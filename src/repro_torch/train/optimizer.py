"""AdamW, functional (port of ``repro/train/optimizer.py``).

State layout mirrors the parameter tree: ``{m, v}`` in fp32 plus a 0-d
int32 step counter.  On one device the state is plain tensors; the
data-parallel train cell (``launch/specs.build_cell``) keeps only its
ZeRO-1 shard of ``(m, v)`` on each rank and updates it with
:func:`adamw_elementwise`, and the int8 gradient compression is
``distributed/collectives.py``.  Every function returns new tensors and
mutates none.

Scalars enter the arithmetic as 0-d fp32 tensors on the data's device,
never as Python numbers divided into a CUDA tensor: PyTorch's CUDA
division by a host scalar multiplies by its reciprocal, which rounds
differently from the division JAX does.  Multiplication by a Python
number rounds the number to fp32 first, as JAX's weak types do.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional, Sequence, Tuple

import torch

from ..distributed.tensor_parallel import all_reduce_sum
from ..interop import tree_flatten, tree_map

PyTree = Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    learning_rate: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class AdamWState(NamedTuple):
    step: torch.Tensor       # 0-d int32
    m: PyTree                # fp32, like params
    v: PyTree                # fp32, like params


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """``x`` as a 0-d fp32 tensor on ``like``'s device."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def init_state(params: PyTree) -> AdamWState:
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                     params)
    device = tree_flatten(params)[0][0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device), m=zeros,
                      v=tree_map(torch.clone, zeros))


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup then cosine decay to min_lr_ratio (fp32, 0-d)."""
    step = torch.as_tensor(step, dtype=torch.int32)
    warm = torch.minimum(_f32(1.0, step),
                         (step + 1).float() / _f32(max(1, cfg.warmup_steps), step))
    t = torch.clamp((step - cfg.warmup_steps).float()
                    / _f32(max(1, cfg.total_steps - cfg.warmup_steps), step), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.learning_rate * warm * cos


def global_norm(tree: PyTree, shards: Optional[Sequence] = None) -> torch.Tensor:
    """The L2 norm of every leaf together.  ``shards`` (tensor-parallel: one
    ``Shard`` or None per leaf, in tree order) marks the leaves that hold
    this rank's shard of a tensor split over a mesh axis: their squares are
    summed over that axis (one all-reduce an axis), each replicated leaf
    counted once, so every rank gets the whole tree's norm.  With no leaf
    split the sum is the single-device one, op for op."""
    leaves = tree_flatten(tree)[0]
    if shards is None or not any(s is not None and s.split for s in shards):
        return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves))
    whole, split, axes = [], {}, {}
    for g, s in zip(leaves, shards):
        sq = torch.sum(torch.square(g.float()))
        if s is not None and s.split:
            split.setdefault(s.axis, []).append(sq)
            axes[s.axis] = s
        else:
            whole.append(sq)
    total = sum(whole)
    for axis, squares in split.items():
        total = total + all_reduce_sum(sum(squares), axes[axis])
    return torch.sqrt(total)


def _clip_scale(max_norm: float, norm: torch.Tensor) -> torch.Tensor:
    return torch.minimum(_f32(1.0, norm),
                         _f32(max_norm, norm) / torch.maximum(norm, _f32(1e-9, norm)))


def clip_by_global_norm(grads: PyTree, max_norm: float) -> Tuple[PyTree, torch.Tensor]:
    norm = global_norm(grads)
    scale = _clip_scale(max_norm, norm)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


def _bias_corrections(cfg: AdamWConfig, stepf: torch.Tensor):
    one = _f32(1.0, stepf)
    return (one - torch.pow(_f32(cfg.beta1, stepf), stepf),
            one - torch.pow(_f32(cfg.beta2, stepf), stepf))


def update_scalars(cfg: AdamWConfig, step: torch.Tensor, gnorm: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-step scalar bundle ``(clip_scale, lr, bc1, bc2)``, 0-d fp32.

    Computed ONCE per step from the pre-increment ``step`` and the global
    gradient norm, then broadcast into every per-leaf/per-chunk call of
    :func:`adamw_elementwise` — the decomposition that lets the OOC sweep
    (train/ooc.py) update state in page-sized chunks while staying
    bitwise-identical to whole-leaf application: everything non-elementwise
    about AdamW lives here.  Mirrors :func:`apply_update` exactly
    (``lr`` from the pre-increment step, bias corrections from the
    post-increment step).
    """
    step = torch.as_tensor(step, dtype=torch.int32, device=gnorm.device)
    scale = _clip_scale(cfg.grad_clip_norm, gnorm).float()
    lr = lr_schedule(cfg, step).float()
    bc1, bc2 = _bias_corrections(cfg, (step + 1).float())
    return scale, lr, bc1, bc2


def adamw_elementwise(cfg: AdamWConfig, p, g, m, v, scale, lr, bc1, bc2):
    """The purely elementwise core of one AdamW update (fp32 in, fp32 out).

    One torch op per reference op, in the reference's order, each rounding
    on its own: no ``alpha=`` arguments, ``addcmul`` or ``_foreach`` ops,
    whose fused multiply-add rounds once where this rounds twice.  So each
    element's result does not depend on how the arrays are chunked, the
    property the paged-vs-resident differential suite leans on.  The
    scalars are 0-d fp32 tensors on the data's device
    (:func:`update_scalars`).
    """
    g = g * scale
    m = cfg.beta1 * m + (1 - cfg.beta1) * g
    v = cfg.beta2 * v + (1 - cfg.beta2) * g * g
    delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) + cfg.weight_decay * p
    return p - lr * delta, m, v


def apply_update(cfg: AdamWConfig, params: PyTree, grads: PyTree,
                 state: AdamWState) -> Tuple[PyTree, AdamWState, dict]:
    """One AdamW step over whole leaves; returns new params and state."""
    grads = tree_map(lambda g: g.float(), grads)
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip_norm)
    step = state.step + 1
    lr = lr_schedule(cfg, state.step)
    b1, b2 = cfg.beta1, cfg.beta2
    m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g, state.m, grads)
    v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * g * g, state.v, grads)
    bc1, bc2 = _bias_corrections(cfg, step.float())

    def upd(p, m_, v_):
        mh = m_ / bc1
        vh = v_ / bc2
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype)

    new_params = tree_map(upd, params, m, v)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_params, AdamWState(step=step, m=m, v=v), metrics
