"""Mixture-of-Experts FFN: top-k router + sort-based capacity dispatch.

Port of ``repro/models/moe.py``.  Dispatch is the sort/gather formulation:
assignments are sorted by expert (a stable sort), positions within each
expert's segment become capacity slots, tokens gather into an [E, C, d]
block, the experts run as batched products (``torch.einsum``, as the JAX
package leaves them to XLA outside any kernel), and results scatter-add
back with the renormalised router weights.  Assignments past an expert's
capacity are dropped (contribute zero).

``shard_local=True`` with a ``DeviceMesh`` active (``distributed/
sharding.use_mesh``) runs the dispatch on each rank's local tokens over the
mesh's process groups (:func:`_moe_forward_shard_local`, the reference's
``shard_map`` form); without one it takes the dense dispatch, as the
reference does without a mesh.

Aux losses (returned; ``train_step`` adds them to the loss): load-balance
(Switch §2.2), router z-loss (ST-MoE) and the dropped share.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..distributed.tensor_parallel import (Shard, all_gather, all_reduce_sum, axis_shard,
                                           from_copies, take_shard, to_local_region)
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
    moe_drop_frac}).  Tokens over capacity are dropped (contribute zero).

    ``shard_local=True`` under an active ``DeviceMesh`` takes the
    mesh-local dispatch (§Perf H1); then ``x`` is this rank's tokens and
    ``p`` holds this rank's expert shards (``moe_sharding``: "tp" shards
    d_ff over ``model``, "ep" the experts), or the whole experts where the
    rules replicate them (``parallelism="dp"``): each rank then takes its
    shard itself."""
    if shard_local:
        from ..distributed.sharding import active_mesh, is_device_mesh

        mesh = active_mesh()
        if is_device_mesh(mesh):
            return _moe_forward_shard_local(p, x, top_k, capacity_factor, moe_sharding, mesh)
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


class _Dispatch:
    """The sort/gather dispatch of tokens x2 [T, d] into an [E, C, d]
    capacity block, and what combining the experts' outputs back needs.

    With ``region`` (TP-MoE over a split ``model`` axis) the routing is
    replicated work, and the token rows gathered into the block and the
    combine weights enter each rank's work on its d_ff slice through
    ``to_local_region``: their partial gradients are summed."""

    def __init__(self, router: torch.Tensor, x2: torch.Tensor, top_k: int,
                 capacity_factor: float, region: Optional[Shard] = None):
        T, d = x2.shape
        E = router.shape[1]
        K = top_k
        dev = x2.device
        self.T, self.K, self.E = T, K, E
        self.logits, self.probs, top_w, top_ids = route(router, x2, K)
        cap = int(max(1, round(T * K / E * capacity_factor)))  # Python's round, as the reference
        self.cap = cap

        flat_e = top_ids.reshape(-1)                            # [T*K]
        order = torch.sort(flat_e, stable=True).indices
        sorted_e = flat_e[order]
        # per-expert counts without bincount, which reads its input's max on
        # the host
        self.counts = torch.zeros(E, dtype=flat_e.dtype, device=dev).scatter_add_(
            0, flat_e, torch.ones_like(flat_e))
        starts = torch.cumsum(self.counts, 0) - self.counts     # exclusive
        pos_in_e = torch.arange(T * K, device=dev) - starts[sorted_e]
        self.keep = pos_in_e < cap
        self.tok_idx = order // K
        self.slot = sorted_e * cap + pos_in_e                   # [T*K] flat slot
        self.w_sorted = top_w.reshape(-1)[order]
        if region is not None:
            x2, self.w_sorted = to_local_region(x2, region), to_local_region(self.w_sorted, region)

        # token index of each slot (T: the zero row); dropped assignments all
        # write one extra slot, cut off after (no host sync for a mask)
        table = torch.full((E * cap + 1,), T, dtype=torch.long, device=dev)
        table.scatter_(0, torch.where(self.keep, self.slot, E * cap), self.tok_idx)
        x_pad = torch.cat([x2, x2.new_zeros((1, d))], dim=0)
        self.xg = x_pad[table[:E * cap]].reshape(E, cap, d)     # [E, C, d]

    def combine(self, eo_flat: torch.Tensor) -> torch.Tensor:
        """Expert outputs [E*C, d] -> y [T, d]: assignment i (sorted order)
        reads slot[i].  index_add_ into zeros: each token receives K = 2
        terms (top-2), and a sum of two terms onto 0 is the same in either
        order, so the result is bitwise reproducible even where CUDA's
        index_add_ adds with atomics in no fixed order (for K > 2 it would
        not be)."""
        keep, T = self.keep, self.T
        zero = torch.zeros((), dtype=eo_flat.dtype, device=eo_flat.device)
        w = torch.where(keep, self.w_sorted.to(eo_flat.dtype), zero)
        contrib = eo_flat[torch.where(keep, self.slot, 0)] * w[:, None]
        return torch.zeros((T + 1, eo_flat.shape[1]), dtype=eo_flat.dtype,
                           device=eo_flat.device).index_add_(
            0, torch.where(keep, self.tok_idx, T), contrib)[:T]

    def aux(self) -> Dict[str, torch.Tensor]:
        """Load-balance loss, router z-loss and the dropped share."""
        T, K, E = self.T, self.K, self.E
        me = self.probs.mean(dim=0)                             # mean router prob
        ce = self.counts.float() / (T * K)
        return {"moe_lb_loss": E * torch.sum(me * ce),
                "moe_z_loss": torch.mean(torch.logsumexp(self.logits, dim=-1) ** 2),
                "moe_drop_frac": 1.0 - self.keep.sum().float() / (T * K)}


def _moe_forward_dense(p: dict, x: torch.Tensor, top_k: int,
                       capacity_factor: float = 1.25
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    b, s, d = x.shape
    disp = _Dispatch(p["router"], x.reshape(b * s, d), top_k, capacity_factor)
    eo_flat = expert_ffn(p, disp.xg).reshape(-1, d)
    return disp.combine(eo_flat).reshape(b, s, d).to(x.dtype), disp.aux()


def _mean_over(v: torch.Tensor, groups) -> torch.Tensor:
    """``pmean`` over the batch's groups' product.  Its backward sums the
    cotangents over the groups (``torch.distributed.nn``'s ``all_reduce``):
    the train cell weights each rank's gradients by its share of the loss
    and sums them over the same axes (``launch/specs.py``)."""
    from torch.distributed.nn.functional import all_reduce

    n = 1
    for g in groups:
        v = all_reduce(v, group=g)
        n *= torch.distributed.get_world_size(g)
    return v / n


def _expert_shards(p: dict, moe_sharding: str) -> dict:
    """Whole expert weights (replicated over ``model``) -> this rank's
    shard of them over ``model``: TP-MoE's d_ff columns of ``w_gate`` /
    ``w_up`` and rows of ``w_down``, or EP's block of experts.  The router
    stays whole."""
    dims = ({"w_gate": 0, "w_up": 0, "w_down": 0} if moe_sharding == "ep"
            else {"w_gate": 2, "w_up": 2, "w_down": 1})
    total = p["w_gate"].shape[dims["w_gate"]]
    sh = axis_shard("model", total)
    if total % sh.parts:
        raise ValueError(f"shard-local MoE ({moe_sharding}): {total} "
                         f"{'experts' if moe_sharding == 'ep' else 'd_ff columns'} do not "
                         f"split over model {sh.parts}")
    return {**p, **{k: take_shard(p[k], dim, sh) for k, dim in dims.items()}}


def _moe_forward_shard_local(p: dict, x: torch.Tensor, top_k: int,
                             capacity_factor: float, moe_sharding: str,
                             mesh) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Local dispatch per data shard over a ``DeviceMesh`` (§Perf H1).

    ``x`` is this rank's tokens (its shard over the data axes, the same on
    every ``model`` peer); the router is whole.  Capacity is per shard, so
    at a capacity factor that drops tokens this is not the dense dispatch
    (it is the reference's ``shard_map`` form).

    TP-MoE: ``w_gate`` / ``w_up`` / ``w_down`` are this rank's d_ff slice.
    Every rank routes all its tokens (replicated work) and runs the
    complete dispatch against its slice; the partial outputs leave through
    ``all_reduce_sum``.

    EP-MoE: the weights are this rank's ``E / n`` experts.  Each ``model``
    peer routes and dispatches a distinct ``1/n`` of the tokens (when ``n``
    divides them), an all-to-all exchanges expert slots for token shards,
    each rank runs its own experts, a reverse all-to-all returns the
    outputs, and an all-gather reassembles the token slices.  Tokens ``n``
    does not divide are routed whole on every peer, and the outputs, the
    same on every peer, leave through ``from_copies``.

    Under ``parallelism="dp"`` the rules replicate the experts, so ``p``
    holds them whole on every rank; the reference's ``shard_map`` splits
    them over ``model`` all the same, so each rank takes its shard
    (:func:`_expert_shards`) and the dispatch above runs on it.  ``x`` is
    then too the data shard, the same on every ``model`` peer: the cells
    split the batch over the data axes alone.

    The gradients follow ``distributed/tensor_parallel.py``'s rule over
    ``model`` (a replicated tensor carries its whole gradient on every
    rank): what enters rank-local work does so through
    ``to_local_region``, and a whole expert weight's shard through
    ``take_shard``.  The aux losses are averaged over ``model`` where
    its peers routed distinct tokens (``all_reduce_sum / n``), and over the
    data groups by ``_mean_over``, as the reference's ``pmean``.
    """
    from torch.distributed.nn.functional import all_to_all_single

    from ..distributed.sharding import active_rules, entry_axes

    data_groups = [mesh.get_group(a) for a in ("pod", "data") if a in mesh.mesh_dim_names]
    ms = axis_shard("model")
    rule = active_rules().get("expert" if moe_sharding == "ep" else "expert_ffn")
    if ms.split and "model" not in entry_axes(rule):
        p = _expert_shards(p, moe_sharding)
    b, s, d = x.shape

    def leave(y, aux):
        aux = {k: _mean_over(v, data_groups) for k, v in aux.items()}
        return y.reshape(b, s, d).to(x.dtype), aux

    if moe_sharding == "tp" or not ms.split:
        disp = _Dispatch(p["router"], x.reshape(b * s, d), top_k, capacity_factor, region=ms)
        y = disp.combine(expert_ffn(p, disp.xg).reshape(-1, d)).to(x.dtype)
        # w_down rows are a d_ff shard -> partial outputs; finish the TP sum
        return leave(all_reduce_sum(y, ms), disp.aux())

    n = ms.parts
    e_local = p["w_gate"].shape[0]
    x_full = to_local_region(x.reshape(b * s, d), ms)
    router = to_local_region(p["router"], ms)
    # x is replicated over "model": each model peer must dispatch a
    # DISTINCT 1/n token slice, else every peer ships identical slots and
    # expert compute inflates n×
    tokens = x_full.shape[0]
    split = tokens % n == 0 and tokens >= n
    tok = Shard(ms.offset * tokens // n, tokens // n, tokens, ms.axis, n) if split else None
    disp = _Dispatch(router, x_full[tok.slice] if split else x_full, top_k, capacity_factor)
    cap = disp.cap

    # exchange: this rank sends its slots for expert-block j to peer j;
    # afterwards dim 0 indexes the SOURCE peer.  The backward of each
    # all-to-all is the reverse exchange.
    model = mesh.get_group("model")
    xg = disp.xg.reshape(n, e_local, cap, d).contiguous()
    xg = all_to_all_single(torch.empty_like(xg), xg, group=model)
    xg = xg.transpose(0, 1).reshape(e_local, n * cap, d)
    eo = expert_ffn(p, xg)                                   # [e_local, n*cap, d]
    # reverse exchange: send each source peer its slots back
    eo = eo.reshape(e_local, n, cap, d).transpose(0, 1).contiguous()
    eo = all_to_all_single(torch.empty_like(eo), eo, group=model)
    y = disp.combine(eo.reshape(-1, d))
    aux = disp.aux()
    if not split:
        return leave(from_copies(y, ms), {k: from_copies(v, ms) for k, v in aux.items()})
    # the full token range from the model-axis slices (backward: this
    # rank's slice); the aux losses averaged over the slices
    return leave(all_gather(y, 0, tok), {k: all_reduce_sum(v, ms) / n for k, v in aux.items()})
