"""Compressed gradient reduction: int8 with per-tensor scales and error
feedback (port of ``repro/distributed/collectives.py``).

The quantization residual is added back into the next step's gradient
(1-bit / 8-bit SGD lineage).  ``quantize_int8`` is the reference's
arithmetic op for op: the scale is ``max|x| / 127 + 1e-12`` in fp32, ``x /
scale`` is a true division by a 0-d tensor on the data's device (never a
host scalar: see ``train/optimizer.py`` on CUDA division), and
``torch.round`` rounds half to even, as ``jnp.round`` does.

:func:`compressed_all_reduce` is the counterpart of ``compressed_psum``:
the mean over the group of every rank's *dequantized* fp32 values, plus
this rank's new error state.  What crosses the wire is the int8 payload
and one fp32 scale per rank (an all-gather); each rank then dequantizes and
sums the ranks' values in rank order, so every rank gets the same bits.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from ..interop import tree_flatten, tree_map, tree_unflatten
from ..train.optimizer import _f32

PyTree = Any


def quantize_int8(x: torch.Tensor, err: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (+ carried error) -> (q int8, scale 0-d fp32, new_err fp32)."""
    xf = x.float()
    if err is not None:
        xf = xf + err
    scale = torch.max(torch.abs(xf)) / _f32(127.0, xf) + _f32(1e-12, xf)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    new_err = xf - deq                      # error feedback residual
    return q, scale, new_err


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_all_reduce(x: torch.Tensor, group=None,
                          err: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8-compressed mean over ``group``.  Returns (mean fp32, new
    error-feedback state of this rank)."""
    q, scale, new_err = quantize_int8(x, err)
    n = dist.get_world_size(group)
    qs = torch.empty(n * q.numel(), dtype=torch.int8, device=q.device)
    scales = torch.empty(n, dtype=torch.float32, device=q.device)
    dist.all_gather_into_tensor(qs, q.reshape(-1), group=group)
    dist.all_gather_into_tensor(scales, scale.reshape(1), group=group)
    qs = qs.view((n,) + tuple(q.shape))
    acc = dequantize_int8(qs[0], scales[0])
    for j in range(1, n):
        acc = acc + dequantize_int8(qs[j], scales[j])
    return acc / _f32(float(n), acc), new_err


def init_error_state(grads: PyTree) -> PyTree:
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
                    grads)


def compress_grads(grads: PyTree, err_state: PyTree
                   ) -> Tuple[PyTree, PyTree, PyTree]:
    """Quantize a gradient tree (per-leaf scales + error feedback)."""
    flat, treedef = tree_flatten(grads)
    eflat = tree_flatten(err_state)[0]
    out = [quantize_int8(g, e) for g, e in zip(flat, eflat)]
    return tuple(tree_unflatten(treedef, [o[i] for o in out]) for i in range(3))


def decompress_grads(qs: PyTree, scales: PyTree) -> PyTree:
    return tree_map(dequantize_int8, qs, scales)
