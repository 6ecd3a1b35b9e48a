"""Mixture-of-Experts FFN: top-k router + sort-based capacity dispatch.

Port of ``repro/models/moe.py``.  Dispatch is the sort/gather formulation:
assignments are sorted by expert (a stable sort), positions within each
expert's segment become capacity slots, tokens gather into an [E, C, d]
block, the experts run as batched products (``torch.einsum``, as the JAX
package leaves them to XLA outside any kernel), and results scatter-add
back with the renormalised router weights.  Assignments past an expert's
capacity are dropped (contribute zero).

One device has no mesh, so ``shard_local`` takes the dense dispatch, as the
reference does without a mesh; its ``shard_map`` form waits for the
distribution slice (ROADMAP.md, Queue 1 item 8).  ``moe_sharding`` only
names the parameters' logical axes here.

Aux losses (returned; ``train_step`` adds them to the loss): load-balance
(Switch §2.2), router z-loss (ST-MoE) and the dropped share.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from .common import ParamSpec, fan_in_init, normal_init


def moe_param_specs(d_model: int, d_ff: int, num_experts: int,
                    moe_sharding: str = "ep") -> dict:
    e_ax = "expert" if moe_sharding == "ep" else None
    f_ax = None if moe_sharding == "ep" else "expert_ffn"

    def e_init(gen, shape, dtype):
        return fan_in_init(gen, shape, dtype, fan_in=shape[-2])

    return {
        "router": ParamSpec((d_model, num_experts), ("embed", None),
                            lambda g, s, d: normal_init(g, s, d, 0.02)),
        "w_gate": ParamSpec((num_experts, d_model, d_ff), (e_ax, "embed", f_ax), e_init),
        "w_up": ParamSpec((num_experts, d_model, d_ff), (e_ax, "embed", f_ax), e_init),
        "w_down": ParamSpec((num_experts, d_ff, d_model), (e_ax, f_ax, "embed"), e_init),
    }


def moe_forward(p: dict, x: torch.Tensor, top_k: int,
                capacity_factor: float = 1.25, shard_local: bool = False,
                moe_sharding: str = "tp") -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: [b, s, d] -> (y [b, s, d], aux {moe_lb_loss, moe_z_loss,
    moe_drop_frac}).  ``shard_local`` and ``moe_sharding`` select the
    reference's mesh-local dispatch, which needs a mesh; with one device
    both take the dense dispatch."""
    del shard_local, moe_sharding
    return _moe_forward_dense(p, x, top_k, capacity_factor)


def route(router: torch.Tensor, x2: torch.Tensor, top_k: int):
    """Router of tokens x2 [T, d] -> (logits [T, E] fp32, probs, top-k
    weights renormalised to sum 1 (Mixtral), top-k expert ids [T, K])."""
    logits = (x2 @ router).float()
    probs = torch.softmax(logits, dim=-1)
    top_w, top_ids = torch.topk(probs, top_k, dim=-1)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    return logits, probs, top_w, top_ids


def expert_ffn(p: dict, xg: torch.Tensor) -> torch.Tensor:
    """Every expert's SwiGLU FFN on its capacity block: [E, C, d] -> [E, C, d]."""
    h = torch.nn.functional.silu(torch.einsum("ecd,edf->ecf", xg, p["w_gate"])) * \
        torch.einsum("ecd,edf->ecf", xg, p["w_up"])
    return torch.einsum("ecf,efd->ecd", h, p["w_down"])


def _moe_forward_dense(p: dict, x: torch.Tensor, top_k: int,
                       capacity_factor: float = 1.25
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    b, s, d = x.shape
    E = p["router"].shape[1]
    T = b * s
    K = top_k
    dev = x.device
    x2 = x.reshape(T, d)
    logits, probs, top_w, top_ids = route(p["router"], x2, K)
    cap = int(max(1, round(T * K / E * capacity_factor)))   # Python's round, as the reference

    flat_e = top_ids.reshape(-1)                            # [T*K]
    order = torch.sort(flat_e, stable=True).indices
    sorted_e = flat_e[order]
    # per-expert counts without bincount, which reads its input's max on
    # the host
    counts = torch.zeros(E, dtype=flat_e.dtype, device=dev).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts               # exclusive
    pos_in_e = torch.arange(T * K, device=dev) - starts[sorted_e]
    keep = pos_in_e < cap
    tok_idx = order // K
    slot = sorted_e * cap + pos_in_e                        # [T*K] flat slot

    # token index of each slot (T: the zero row); dropped assignments all
    # write one extra slot, cut off after (no host sync for a mask)
    table = torch.full((E * cap + 1,), T, dtype=torch.long, device=dev)
    table.scatter_(0, torch.where(keep, slot, E * cap), tok_idx)
    table = table[:E * cap]

    x_pad = torch.cat([x2, x2.new_zeros((1, d))], dim=0)
    xg = x_pad[table].reshape(E, cap, d)                    # [E, C, d]
    eo_flat = expert_ffn(p, xg).reshape(E * cap, d)

    # combine: assignment i (sorted order) reads expert-output slot[i].
    # index_add_ into zeros: each token receives K = 2 terms (top-2), and
    # a sum of two terms onto 0 is the same in either order, so the result
    # is bitwise reproducible even where CUDA's index_add_ adds with
    # atomics in no fixed order (for K > 2 it would not be).
    w_sorted = top_w.reshape(-1)[order].to(eo_flat.dtype)
    zero = torch.zeros((), dtype=eo_flat.dtype, device=dev)
    contrib = eo_flat[torch.where(keep, slot, 0)] * torch.where(keep, w_sorted, zero)[:, None]
    y = torch.zeros((T + 1, d), dtype=eo_flat.dtype, device=dev).index_add_(
        0, torch.where(keep, tok_idx, T), contrib)[:T]

    # aux losses
    me = probs.mean(dim=0)                                  # mean router prob
    ce = counts.float() / (T * K)
    lb_loss = E * torch.sum(me * ce)
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    dropped = 1.0 - keep.sum().float() / (T * K)
    aux = {"moe_lb_loss": lb_loss, "moe_z_loss": z_loss, "moe_drop_frac": dropped}
    return y.reshape(b, s, d).to(x.dtype), aux
