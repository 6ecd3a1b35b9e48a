"""Sharding specs and abstract inputs for every (arch × shape) cell, and
the cell's callable (port of ``repro/launch/specs.py``).

The abstract tensors live on the ``meta`` device (shapes and dtypes, no
storage); the specs are the reference's, as tuples (``distributed/
sharding.py``).  ``build_cell`` returns a :class:`Cell`: the callable, its
meta arguments, and the specs of its arguments and outputs.  The dry run
(``launch/dryrun.py``) reads only the meta tensors and the specs.

The callable executes on a ``DeviceMesh``.  Each rank holds its local
shard of every argument (``local_tree``) and returns its local shard of
every output under the cell's specs; the cell reduces what crosses ranks
itself:

* train: data parallel over the batch's mesh axes with ZeRO-1 AdamW
  moments and, over ``model`` > 1, tensor parallel for every architecture
  (the weights split as for prefill; the loss's vocabulary split too,
  ``train/loss.py``).  Each rank runs
  ``step_grads`` on its parameter shards under the mesh and the rules the
  cell was built with: the reference's sharding constraints are
  collectives whose backward is the one GSPMD derives
  (``distributed/tensor_parallel.py``).  Each rank's
  gradients are weighted by its share of the loss tokens and summed over
  the batch's axes, so the result is the gradient of the global mean loss
  (as GSPMD computes it), not the mean of shard means.  ``global_norm``
  sums the squares of each ``model``-split leaf over ``model`` and counts
  each replicated leaf once, so the clip sees the whole gradient; each rank
  then runs ``adamw_elementwise`` on its ZeRO-1 slice of its param shard,
  gradients and moments, and gathers the updated slices over the batch's
  axes, back to its shard under the param specs.  The arithmetic per
  element is ``apply_update``'s, so at world size 1 the step is bitwise
  ``train_step``'s.
* prefill / decode: ``T.prefill`` / ``T.decode_step`` under the mesh and
  the rules the cell was built with.  Over ``model`` > 1 every
  architecture runs tensor-parallel on its parameter shards (heads, KV
  heads, ffn and vocab split; TP-MoE's expert d_ff or EP's experts; the
  Mamba mixer's and the mLSTM's channels; the encoder-decoder's memory KV
  by KV heads), the reference's sharding constraints made explicit
  collectives (``models/blocks.py``, ``models/xlstm.py``,
  ``distributed/tensor_parallel.py``).  The logits are gathered to the
  whole vocabulary; the cache comes back as this rank's shard under the
  cell's specs: the prefill's KV split by KV heads where the rules split
  them, the decode's by sequence, or by KV heads where the mesh does not
  divide its length; the Mamba and mLSTM states and the conv states by
  channel; the mLSTM / sLSTM cell states whole on every ``model`` rank.

A cell runs on a ``DeviceMesh``; on a ``MeshSpec`` (the dry run's
production meshes) it only accounts, and its callable refuses to run.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Any, Callable, Optional, Tuple

import torch
import torch.distributed as dist

from .. import torch_dtype
from ..configs.base import ModelConfig, ShapeConfig
from ..distributed.sharding import (active_rules, entry_axes, gather_shard, is_device_mesh,
                                    logical_pspec, mesh_spec, shard_slices, use_mesh)
from ..distributed.tensor_parallel import axis_shard
from ..interop import tree_flatten, tree_map, tree_unflatten
from ..models import transformer as T
from ..models.common import is_tuple, shapes_tree
from ..models.transformer import param_specs
from ..train.optimizer import (AdamWConfig, AdamWState, adamw_elementwise, global_norm,
                               update_scalars)
from ..train.train_step import TrainConfig, step_grads

META = torch.device("meta")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


# ------------------------------------------------------------------- params


def abstract_params(cfg: ModelConfig) -> Any:
    dtype = torch_dtype(cfg.param_dtype)
    return tree_map(lambda shp: _meta(shp, dtype), shapes_tree(param_specs(cfg)),
                    is_leaf=is_tuple)


def param_pspecs(cfg: ModelConfig, mesh) -> Any:
    return tree_map(lambda s: logical_pspec(s.logical_axes, s.shape, mesh), param_specs(cfg))


def zero1_pspec(base: tuple, shape: Tuple[int, ...], mesh) -> tuple:
    """Augment a param spec with data(-and-pod) sharding for optimizer state.

    The first unsharded dim divisible by the data axis (or pod*data) takes it
    — ZeRO-1: m/v live sharded, params stay as-is (DESIGN.md §4).
    """
    ms = mesh_spec(mesh)
    data_axes = tuple(a for a in ("pod", "data") if a in ms.axis_names)
    total = math.prod(ms.sizes[a] for a in data_axes)
    spec = list(base) + [None] * (len(shape) - len(base))
    for i, (ax, dim) in enumerate(zip(spec, shape)):
        if ax is None and dim % total == 0 and total > 1:
            spec[i] = data_axes if len(data_axes) > 1 else data_axes[0]
            return tuple(spec)
    # fall back to data-only
    if len(data_axes) > 1:
        d = ms.sizes["data"]
        for i, (ax, dim) in enumerate(zip(spec, shape)):
            if ax is None and dim % d == 0 and d > 1:
                spec[i] = "data"
                return tuple(spec)
    return tuple(spec)


def opt_pspecs(cfg: ModelConfig, mesh) -> AdamWState:
    mv = tree_map(lambda s: zero1_pspec(logical_pspec(s.logical_axes, s.shape, mesh),
                                        s.shape, mesh), param_specs(cfg))
    return AdamWState(step=(), m=mv, v=mv)


def abstract_opt_state(cfg: ModelConfig) -> AdamWState:
    zeros = lambda: tree_map(lambda shp: _meta(shp, torch.float32),  # noqa: E731
                             shapes_tree(param_specs(cfg)), is_leaf=is_tuple)
    return AdamWState(step=_meta((), torch.int32), m=zeros(), v=zeros())


# -------------------------------------------------------------------- batch


def batch_pspec(mesh, batch_size: Optional[int] = None) -> tuple:
    """Batch partitioning over (pod, data), dropped when not divisible
    (long_500k has global_batch=1: batch stays replicated)."""
    ms = mesh_spec(mesh)
    axes = tuple(a for a in ("pod", "data") if a in ms.axis_names)
    if batch_size is not None:
        if batch_size % math.prod(ms.sizes[a] for a in axes) != 0:
            axes = tuple(a for a in axes
                         if batch_size % ms.sizes[a] == 0 and a == "data")
    if not axes:
        return (None,)
    return (axes if len(axes) > 1 else axes[0],)


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Abstract model inputs for one cell (meta tensors)."""
    B, S = shape.global_batch, shape.seq_len
    bf16, i32 = torch.bfloat16, torch.int32
    batch: dict = {}
    if shape.kind in ("train", "prefill"):
        if cfg.input_mode == "embeds":
            batch["embeds"] = _meta((B, S, cfg.d_model), bf16)
            if cfg.mrope_sections is not None:
                batch["positions"] = _meta((B, 3, S), i32)
        else:
            batch["tokens"] = _meta((B, S), i32)
        if cfg.is_encdec:
            # stub speech frontend: ~same-length frame embeddings
            batch["src_embeds"] = _meta((B, S, cfg.d_model), bf16)
        if shape.kind == "train":
            batch["labels"] = _meta((B, S), i32)
    else:  # decode
        batch["tokens"] = _meta((B,), i32)
        batch["cur_pos"] = _meta((B,), i32)
    return batch


def batch_pspecs(cfg: ModelConfig, shape: ShapeConfig, mesh) -> dict:
    b_axes = batch_pspec(mesh, shape.global_batch)[0]
    return {k: (b_axes,) + (None,) * (v.dim() - 1)
            for k, v in input_specs(cfg, shape).items()}


# -------------------------------------------------------------------- cache


def abstract_cache(cfg: ModelConfig, shape: ShapeConfig) -> list:
    return T.init_cache(cfg, shape.global_batch, shape.seq_len,
                        torch_dtype(cfg.compute_dtype), device=META,
                        memory_len=shape.seq_len if cfg.is_encdec else None)


def cache_pspecs(cfg: ModelConfig, shape: ShapeConfig, mesh) -> list:
    """Specs mirroring init_cache's structure (a list of per-segment dicts;
    the mLSTM / sLSTM states are flat entries, batch-sharded on dim 1)."""
    b_ax = batch_pspec(mesh, shape.global_batch)[0]

    def spec_for(key: str, x: torch.Tensor) -> tuple:
        if key in ("k", "v"):           # [L, B, S, KVH, D]
            return (None, b_ax, *logical_pspec(("kv_seq", "kv_heads"), x.shape[2:4], mesh),
                    None)
        if key in ("xk", "xv"):         # [L, B, Sm, KVH, D]
            return (None, b_ax, None, logical_pspec(("kv_heads",), (x.shape[3],), mesh)[0],
                    None)
        if key == "pos":                # [L, B, S]
            return (None, b_ax, logical_pspec(("kv_seq",), (x.shape[2],), mesh)[0])
        if key == "ssm":                # [L, B, d_inner, N]
            return (None, b_ax, logical_pspec(("ssm_inner",), (x.shape[2],), mesh)[0], None)
        if key == "conv":               # [L, B, K-1, d_inner or d_model]
            return (None, b_ax, None, logical_pspec(("ssm_inner",), (x.shape[3],), mesh)[0])
        # mlstm/slstm states and anything else: batch-shard dim 1 only
        return (None, b_ax) + (None,) * (x.dim() - 2)

    return [{k: spec_for(k, x) for k, x in seg.items()} for seg in abstract_cache(cfg, shape)]


# ------------------------------------------------------------ local shards


def local_tree(tree, specs, mesh, coord=None):
    """Each leaf's shard at ``coord`` (this rank's by default) under its
    spec, as a copy (so the full tensor can be freed)."""
    return tree_map(lambda t, s: t[shard_slices(s, t.shape, mesh, coord)].clone(),
                    tree, specs, is_leaf=is_tuple)


def batch_part(o_spec: tuple, p_spec: tuple) -> tuple:
    """A ZeRO-1 moment spec's batch-axis entries alone: the entries that the
    param spec also has (``zero1_pspec`` adds batch axes on dims the param
    spec leaves whole) dropped.  It splits a rank's param shard into the
    ZeRO-1 slices of the ranks that share that shard."""
    p_spec = tuple(p_spec) + (None,) * (len(o_spec) - len(p_spec))
    return tuple(e if pe is None else None for e, pe in zip(o_spec, p_spec))


# elements that an in-place update computes at a time
IN_PLACE_CHUNK = 1 << 24


def _blocks(shape: Tuple[int, ...], limit: int):
    """Index tuples covering ``shape`` in blocks of leading rows of at most
    ``limit`` elements (one element where a row alone is larger)."""
    if math.prod(shape) <= limit:
        yield ()
        return
    inner = math.prod(shape[1:])
    if inner <= limit:
        rows = max(1, limit // inner)
        for i in range(0, shape[0], rows):
            yield (slice(i, i + rows),)
        return
    for i in range(shape[0]):
        for rest in _blocks(shape[1:], limit):
            yield (i,) + rest


def _update_in_place(ocfg: AdamWConfig, p, g, m, v, scalars) -> None:
    """``adamw_elementwise`` over blocks of at most IN_PLACE_CHUNK elements
    (:func:`_blocks`), written back into ``p``, ``m`` and ``v``: the bits of
    the whole-leaf update, which is chunk-invariant, with one block's
    temporaries alive at a time."""
    for blk in _blocks(tuple(p.shape), IN_PLACE_CHUNK):
        p_l, m_l, v_l = adamw_elementwise(ocfg, p[blk].float(), g[blk].float(), m[blk],
                                          v[blk], *scalars)
        p[blk].copy_(p_l)
        m[blk].copy_(m_l)
        v[blk].copy_(v_l)


def zero1_local_update(ocfg: AdamWConfig, params, grads, opt_local: AdamWState,
                       o_specs: AdamWState, scalars, mesh, coord=None, p_specs=None,
                       in_place: bool = False):
    """One AdamW update of the ZeRO-1 shard at ``coord`` (this rank's by
    default): ``(new param slices, new local state)``.  ``params`` and
    ``grads`` are this rank's shards under ``p_specs`` (default: whole, the
    gradients reduced), ``opt_local`` holds this shard's moments, and
    ``scalars`` is ``update_scalars`` of the whole gradient's norm, so each
    element's result is ``apply_update``'s.  Each leaf's slice is the batch
    part (:func:`batch_part`) of its moment spec, taken of the param
    shard.  ``in_place``: the update is written into the param slices and
    the moments themselves (:func:`_update_in_place`), which it returns."""
    p_leaves, treedef = tree_flatten(params)
    g_leaves = tree_flatten(grads)[0]
    specs = tree_flatten(o_specs.m, is_tuple)[0]
    bases = (tree_flatten(p_specs, is_tuple)[0] if p_specs is not None
             else [()] * len(specs))
    m_leaves, v_leaves = tree_flatten(opt_local.m)[0], tree_flatten(opt_local.v)[0]
    new_p, new_m, new_v = [], [], []
    for p, g, s, base, m, v in zip(p_leaves, g_leaves, specs, bases, m_leaves, v_leaves):
        sl = shard_slices(batch_part(s, base), p.shape, mesh, coord)
        if in_place:
            _update_in_place(ocfg, p[sl], g[sl], m, v, scalars)
            new_p.append(p[sl])
            new_m.append(m)
            new_v.append(v)
            continue
        p_l, m_l, v_l = adamw_elementwise(ocfg, p[sl].float(), g[sl].float(), m, v, *scalars)
        new_p.append(p_l.to(p.dtype))
        new_m.append(m_l)
        new_v.append(v_l)
    return (tree_unflatten(treedef, new_p),
            AdamWState(step=opt_local.step + 1, m=tree_unflatten(treedef, new_m),
                       v=tree_unflatten(treedef, new_v)))


def _all_reduce(t: torch.Tensor, groups) -> torch.Tensor:
    """In-place SUM over each group in turn (the batch's mesh axes; for
    equal-sized groups the nested sums are the sum over their product)."""
    for g in groups:
        dist.all_reduce(t, group=g)
    return t


# ---------------------------------------------------------------- entry fns


@dataclasses.dataclass
class Cell:
    """A cell's callable, its abstract (meta) arguments and outputs, and
    their specs."""

    fn: Callable
    args: tuple
    in_specs: tuple
    out: tuple
    out_specs: tuple


def _require_device_mesh(mesh) -> None:
    if not is_device_mesh(mesh):
        raise TypeError("a cell executes on a DeviceMesh; a MeshSpec only accounts")


def _leaf_shards(p_specs, mesh) -> list:
    """Per param leaf (tree order), this rank's ``Shard`` of the mesh axis
    its spec splits (None: replicated), for ``global_norm``."""
    sizes = mesh_spec(mesh).sizes
    out = []
    for spec in tree_flatten(p_specs, is_tuple)[0]:
        axes = [a for e in spec for a in entry_axes(e) if sizes[a] > 1]
        if len(axes) > 1:
            raise NotImplementedError(f"a parameter split over several mesh axes {axes}")
        out.append(axis_shard(axes[0]) if axes else None)
    return out


def _unbatched(c_specs) -> list:
    """Cache specs with the batch entry (dim 1) dropped: the cells build and
    take caches of their local batch."""
    return [{k: s[:1] + (None,) + s[2:] for k, s in seg.items()} for seg in c_specs]


def _train_fn(cfg, tcfg, mesh, rules, p_specs, o_specs, b_specs, donate, params, opt_state,
              batch):
    _require_device_mesh(mesh)
    groups = [mesh.get_group(a) for a in entry_axes(b_specs["labels"][0])]
    labels, mask = batch["labels"], batch.get("loss_mask")
    n_local = (mask.sum() if mask is not None else torch.tensor(labels.numel())).to(
        device=labels.device, dtype=torch.float32)
    n_total = _all_reduce(n_local.clone(), groups)
    w = n_local / torch.clamp(n_total, min=1.0)     # this shard's share of the loss

    with use_mesh(mesh, rules):
        metrics, grads = step_grads(cfg, tcfg, params, batch)
        # in place on fp32 gradients (step_grads' own tensors): the same bits
        # as g * w without a second copy of the gradient tree
        grads = tree_map(lambda g: _all_reduce(g.float().mul_(w), groups), grads)
        metrics = {k: _all_reduce(v.float() * w, groups) for k, v in metrics.items()
                   if k != "tokens"}
        gnorm = global_norm(grads, _leaf_shards(p_specs, mesh))
    scalars = update_scalars(tcfg.optimizer, opt_state.step, gnorm)
    p_local, opt_state = zero1_local_update(tcfg.optimizer, params, grads, opt_state,
                                            o_specs, scalars, mesh, p_specs=p_specs,
                                            in_place=donate)
    new = tree_map(lambda p, s, base: gather_shard(p, batch_part(s, base), mesh),
                   p_local, o_specs.m, p_specs, is_leaf=is_tuple)
    if donate:      # the updated shards in the arguments' own storage
        new = tree_map(lambda old, t: old if t.data_ptr() == old.data_ptr() else old.copy_(t),
                       params, new)
    params = new
    metrics.update(tokens=n_total, grad_norm=gnorm, lr=scalars[1])
    return params, opt_state, metrics


# cache entries a rank computes as its own shard (the Mamba and mLSTM states
# on its channels, the memory KV on its KV heads; the sLSTM's conv state,
# which its block slices): the prefill cell holds them as this rank's shards
# from the start
RANK_LOCAL_STATES = ("ssm", "conv", "xk", "xv")


def _cache_shards(cache, c_local, mesh, rank_local: bool) -> list:
    """Each segment's entries of ``RANK_LOCAL_STATES`` (``rank_local``) or
    the others at this rank's shard; the rest as they are."""
    return [{k: (local_tree(t, seg_s[k], mesh) if (k in RANK_LOCAL_STATES) == rank_local
                 else t) for k, t in seg.items()} for seg, seg_s in zip(cache, c_local)]


def _prefill_fn(cfg, shape, mesh, rules, c_specs, params, batch):
    c_local = _unbatched(c_specs)
    _require_device_mesh(mesh)
    first = tree_flatten(batch)[0][0]
    with use_mesh(mesh, rules):
        cache = T.init_cache(cfg, first.shape[0], shape.seq_len,
                             torch_dtype(cfg.compute_dtype), device=first.device,
                             memory_len=shape.seq_len if cfg.is_encdec else None)
        cache = _cache_shards(cache, c_local, mesh, rank_local=True)
        last_hidden, cache = T.prefill(cfg, params, batch, cache)
        logits = T.lm_logits(cfg, params, last_hidden)
    return logits, _cache_shards(cache, c_local, mesh, rank_local=False)


def _decode_fn(cfg, shape, mesh, rules, params, cache, tokens, cur_pos):
    _require_device_mesh(mesh)
    with use_mesh(mesh, rules):
        return T.decode_step(cfg, params, cache, tokens, cur_pos, seq_len=shape.seq_len)


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh,
               tcfg: Optional[TrainConfig] = None, donate: bool = False) -> Cell:
    """The cell's callable, meta arguments and outputs, and specs, under the
    active rules (``use_mesh(mesh, rules_for(shape.kind, cfg))``), which
    the callables run under.  ``donate`` (train): the step writes the
    updated params and moments into its arguments' storage and returns
    them, as the reference's ``donate_argnums=(0, 1)`` lets XLA do, so no
    second training state is alive at its peak; the caller must not read
    the arguments as the old values after."""
    rules = active_rules()
    p_specs = param_pspecs(cfg, mesh)
    a_params = abstract_params(cfg)
    b_specs = batch_pspecs(cfg, shape, mesh)
    a_batch = input_specs(cfg, shape)

    if shape.kind == "train":
        tcfg = tcfg or TrainConfig()
        o_specs = opt_pspecs(cfg, mesh)
        a_opt = abstract_opt_state(cfg)
        fn = partial(_train_fn, cfg, tcfg, mesh, rules, p_specs, o_specs, b_specs, donate)
        return Cell(fn, (a_params, a_opt, a_batch), (p_specs, o_specs, b_specs),
                    (a_params, a_opt), (p_specs, o_specs))

    c_specs = cache_pspecs(cfg, shape, mesh)
    a_cache = abstract_cache(cfg, shape)
    bp = batch_pspec(mesh, shape.global_batch)
    logits = _meta((shape.global_batch, cfg.padded_vocab), torch_dtype(cfg.compute_dtype))
    out, out_specs = (logits, a_cache), (bp + (None,), c_specs)
    if shape.kind == "prefill":
        fn = partial(_prefill_fn, cfg, shape, mesh, rules, c_specs)
        return Cell(fn, (a_params, a_batch), (p_specs, b_specs), out, out_specs)

    fn = partial(_decode_fn, cfg, shape, mesh, rules)
    return Cell(fn, (a_params, a_cache, a_batch["tokens"], a_batch["cur_pos"]),
                (p_specs, c_specs, bp, bp), out, out_specs)
