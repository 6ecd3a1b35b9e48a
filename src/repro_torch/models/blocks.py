"""Decoder and encoder blocks, cache-aware (port of ``repro/models/blocks.py``):
every kind of the JAX package — dense, encoder, xdecoder (self- plus
cross-attention), MoE, hymba, mLSTM and sLSTM.

A block provides ``block_param_specs(cfg, seg)`` (one layer's ParamSpec
tree) and ``block_apply(cfg, seg, p, x, ctx) -> (x, new_cache_layer, aux)``.
``ctx`` carries the mode ("train" | "prefill" | "decode"), positions
([B, S], or [B, 3, S] under M-RoPE), the per-layer cache slice and, for
cross-attention, the encoder memory.  A prefill whose mask positions (the
temporal row under M-RoPE) are ``0..S-1`` in every row runs its
self-attention in the ``flash_attention`` kernel, an encoder's without the
causal mask; a prefill's cross-attention always runs there (no mask, the
memory as keys); other prefills keep the plain ``attention``.  A hymba
block runs attention and a Mamba mixer side by side on the same input
(``models/ssm.py``); an MoE block's FFN is ``models/moe.py``; the xLSTM
kinds are ``models/xlstm.py``.

Cache writes are **in-place** (JAX rebuilt the cache with ``.at[].set``):
a writer returns the very tensors it was given, updated, so the caller can
tell what was written in place from what is new.  An xLSTM layer's state
tuple is kept under one name per tensor (mLSTM ``C``, ``n``, ``m``; sLSTM
``c``, ``n``, ``m``, ``h``; both ``conv``), so every cache is a flat dict
of tensors.  On the paged decode path
the new token goes into the pool with one index write and attention reads
the pool through the page table with the ``paged_attention`` kernel
(with the segment's sliding window, if any: the pool holds every position
and the kernel reads only the last ``window``);
:func:`_gather_paged` (gather pages, then plain ``decode_attention``) stays
as the oracle the tests hold that path to.

Under an active ``DeviceMesh`` (the train, prefill and decode cells) ``p``
holds this rank's shards, split as ``launch/specs.param_pspecs`` says, and
the reference's sharding constraints are explicit collectives, with the
backward GSPMD gives them (``distributed/tensor_parallel.py``):

* attention: ``wq`` / ``bq`` are column shards over ``padded_heads·D``,
  ``wk`` / ``wv`` / ``bk`` / ``bv`` over ``KV·D`` (a shard may cut a KV
  head, so K and V are gathered to whole KV heads), ``wo`` a row shard.  A
  prefill on the kernel route attends this rank's own heads where its
  columns are whole heads (``flash_attention``'s ``head_offset``), and so
  does training (the plain attention over those heads' KV map); elsewhere
  q is gathered to every head.  Each rank multiplies the columns of ``o``
  that its ``wo`` rows take, and the partial products are summed.  In the
  backward the input and the gathered K, V (and q) sum the ranks' partial
  gradients (``to_local_region``).
* decode: the cache is split by sequence (``kv_seq``); the new token is
  written by the rank whose slice holds its slot, each rank attends every
  head over its slice, and the slices' softmax parts are combined
  (flash-decoding: a max, then one sum of the rescaled numerators and
  normalisers).  Where the mesh does not divide the cache's length, the
  rules split its KV heads instead: each rank writes and attends its own KV
  heads for the query heads that read them, and where those are not its own
  heads one sum combines every head's output (``_decode_kv_heads``).
* cross-attention (the encoder-decoder): q on this rank's heads, the
  memory's K and V from the ``wk`` / ``wv`` column shards gathered to whole
  KV heads; the cached memory KV (``xk`` / ``xv``) is each rank's own KV
  heads, which ``cross_decode`` attends as the decode cache above.
* MLP: ``w_gate`` / ``w_up`` / ``w_in`` / ``b_in`` column shards over
  ``d_ff``, ``w_down`` / ``w_out`` row shards; the partial products are
  summed, then ``b_out`` is added once; the input's partial gradients are
  summed in the backward.
* MoE (``models/moe.py``, shard-local): TP-MoE's experts split on d_ff,
  EP's on the expert axis, over ``model``.
* hymba's Mamba mixer on ``ssm_inner`` channels (``models/ssm.py``), its
  states split the same way; its output, as the attention's, is summed
  before the branch's RMS norm.
* xLSTM (``models/xlstm.py``): the mLSTM block on ``ssm_inner`` channels,
  its conv state split the same way and its cell whole on every rank; the
  sLSTM block whole but for its FFN on ``ffn``.

Under M-RoPE the contiguous cache is filled by sequence index, and the
``pos`` row holds each entry's temporal position, which the decode mask
reads; a decode step appends at the first free slot.  (The JAX package
indexes the cache by the temporal position, so the tokens of an image block,
which share one, overwrite each other; ROADMAP.md, divergences of the
reference.)
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig, Segment
from ..distributed.sharding import active_mesh, is_device_mesh, logical_pspec
from ..distributed.tensor_parallel import (Shard, all_gather, all_reduce_sum, entry_shard,
                                           shard_of, to_local_region)
from ..kernels.flash_attention.ops import flash_attention
from ..kernels.paged_attention.ops import paged_attention
from .common import ParamSpec, fan_in_init, ones_init, zeros_init
from .moe import moe_forward, moe_param_specs
from .ssm import mamba_decode, mamba_forward, mamba_param_specs, mamba_state_init
from .layers import (
    AttnSpec,
    apply_rope,
    attention,
    decode_attention,
    decode_attention_sharded,
    expand_kv,
    gelu_mlp,
    make_qh_to_kv_map,
    rms_norm,
    swiglu,
)
from .xlstm import (
    mlstm_block_forward,
    mlstm_block_specs,
    slstm_block_forward,
    slstm_block_specs,
    slstm_d_ff,
)

# names under which an xLSTM layer's cache keeps its state tuple
STATE_NAMES = {"mlstm": ("C", "n", "m"), "slstm": ("c", "n", "m", "h")}


@dataclasses.dataclass
class BlockCtx:
    mode: str                                   # train | prefill | decode
    positions: torch.Tensor                     # [B, S] or [B, 3, S] (M-RoPE)
    cache: Optional[Dict[str, torch.Tensor]] = None   # this layer's cache slice
    cur_pos: Optional[torch.Tensor] = None      # [B] decode position
    # the mask positions (the temporal row under M-RoPE) are 0..S-1 in
    # every row: prefill self-attention then takes the flash_attention kernel
    default_positions: bool = False
    memory: Optional[torch.Tensor] = None       # encoder output [B, Sm, d]
    memory_positions: Optional[torch.Tensor] = None   # [B, Sm]
    # decode: the contiguous cache's global length where the mesh may split
    # it by sequence or by KV heads (None: the cache is whole)
    seq_len: Optional[int] = None
    # decode under M-RoPE: the first free slot of the contiguous cache [B],
    # counted over the whole cache (None: counted in the layer's own cache)
    fill: Optional[torch.Tensor] = None


# ----------------------------------------------------------------- attention


def attn_param_specs(cfg: ModelConfig) -> dict:
    H, KV, D, E = cfg.padded_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_model

    def o_init(gen, shape, dtype):
        """Zero rows for padded heads => exact function preservation."""
        w = fan_in_init(gen, shape, dtype, fan_in=cfg.num_heads * D)
        if cfg.padded_heads != cfg.num_heads:
            w = w.reshape(H, D, E)
            w[cfg.num_heads:] = 0.0
            w = w.reshape(H * D, E)
        return w

    specs = {
        "wq": ParamSpec((E, H * D), ("embed", "heads"), fan_in_init),
        "wk": ParamSpec((E, KV * D), ("embed", "kv_heads"), fan_in_init),
        "wv": ParamSpec((E, KV * D), ("embed", "kv_heads"), fan_in_init),
        "wo": ParamSpec((H * D, E), ("heads", "embed"), o_init),
    }
    if cfg.qkv_bias:
        specs["bq"] = ParamSpec((H * D,), ("heads",), zeros_init)
        specs["bk"] = ParamSpec((KV * D,), ("kv_heads",), zeros_init)
        specs["bv"] = ParamSpec((KV * D,), ("kv_heads",), zeros_init)
    return specs


def _qkv(cfg: ModelConfig, p: dict, x: torch.Tensor, hs: Shard, kvs: Shard,
         whole_q: bool, mem: Optional[torch.Tensor] = None, gather_kv: bool = True):
    """(q, k, v [B,S,*,D], h0): k and v over every KV head (with
    ``gather_kv`` false, this rank's ``kvs`` columns: its own KV heads
    where they are whole heads); q over this rank's heads from global head
    ``h0`` where its ``hs`` columns are whole heads and ``whole_q`` is
    false, else over every head (``h0`` 0).  With ``mem`` (cross-attention)
    k and v are the memory's, without bias, as the reference computes them.

    Backward: ``x`` enters the column shards of ``wq`` (and of ``wk`` /
    ``wv`` where they are split) through ``to_local_region``, so its
    partial gradients are summed; K, V and a gathered q, replicated, enter
    the rank's own heads the same way.  K and V from replicated ``wk`` /
    ``wv`` (``KV·D`` not divisible by the mesh) read ``x`` itself: their
    gradient, summed over the ranks' heads, is already whole."""
    b, s, _ = x.shape
    x_cols = to_local_region(x, hs)
    if mem is not None:
        x_kv = to_local_region(mem, kvs)
    else:
        x_kv = (x_cols if hs.split else to_local_region(x, kvs)) if kvs.split else x
    q = x_cols @ p["wq"]
    k = x_kv @ p["wk"]
    v = x_kv @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"]
        if mem is None:
            k, v = k + p["bk"], v + p["bv"]
    if gather_kv:
        k, v = all_gather(k, -1, kvs), all_gather(v, -1, kvs)
        k, v = to_local_region(k, hs), to_local_region(v, hs)
    h0 = hs.offset // cfg.head_dim
    if hs.split and (whole_q or hs.size % cfg.head_dim):
        q, h0 = to_local_region(all_gather(q, -1, hs), hs), 0
    q = q.reshape(b, s, -1, cfg.head_dim)
    k = k.reshape(b, x_kv.shape[1], -1, cfg.head_dim)
    v = v.reshape(b, x_kv.shape[1], -1, cfg.head_dim)
    return q, k, v, h0


def _out_proj(p: dict, o: torch.Tensor, hs: Shard) -> torch.Tensor:
    """o [B,S,*·D] @ wo: this rank's rows of wo take the columns of o they
    multiply (o may hold more heads than they do); the ranks' partial
    products are summed."""
    if o.shape[-1] != hs.size:
        o = o[..., hs.slice]
    return all_reduce_sum(o @ p["wo"], hs)


def _cache_shards(cfg: ModelConfig, ctx: BlockCtx, window: Optional[int],
                  local_len: int) -> Tuple[Shard, Shard]:
    """This rank's slice of the decode cache's sequence and of its KV heads,
    as the cell's cache specs split them: the sequence on ``kv_seq`` where
    the mesh divides its length, else the KV heads on ``kv_heads`` where it
    divides them (``launch/specs.cache_pspecs``)."""
    kvh = cfg.num_kv_heads
    if ctx.seq_len is None or not is_device_mesh(active_mesh()):
        return Shard(0, local_len, local_len), Shard(0, kvh, kvh)
    total = ctx.seq_len if window is None else min(ctx.seq_len, window)
    seq_e, kv_e = logical_pspec(("kv_seq", "kv_heads"), (total, kvh))
    ss, kh = entry_shard(seq_e, total), entry_shard(kv_e, kvh)
    if ss.size != local_len:
        raise ValueError(f"decode: a cache of {local_len} positions is not this rank's "
                         f"slice {ss} of {total}")
    return ss, kh


def _kv_head_of(cfg: ModelConfig, h: int) -> int:
    """The KV head global query head ``h`` reads (``make_qh_to_kv_map``'s)."""
    group = max(1, cfg.num_heads // cfg.num_kv_heads)
    return min(h // group, cfg.num_kv_heads - 1) if h < cfg.num_heads else 0


def _decode_heads(cfg: ModelConfig, hs: Shard, kh: Shard) -> Tuple[list, bool]:
    """(the global query heads this rank attends in a decode step, whether
    they are its own heads of ``hs``).  With the KV heads split (``kh``):
    the heads whose KV head the rank holds, which need not be its own (a
    padded-head map crosses shards); else its own heads where its ``hs``
    columns are whole heads, else every head."""
    d = cfg.head_dim
    own = (list(range(hs.offset // d, (hs.offset + hs.size) // d)) if hs.size % d == 0
           else None)
    if kh.split:
        sel = [h for h in range(cfg.padded_heads)
               if kh.offset <= _kv_head_of(cfg, h) < kh.offset + kh.size]
    else:
        sel = own if own is not None else list(range(cfg.padded_heads))
    return sel, sel == own


def _decode_kv_heads(cfg: ModelConfig, q: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                     k_pos: torch.Tensor, cur_pos: torch.Tensor, window: Optional[int],
                     kh: Shard, sel: list, aligned: bool) -> torch.Tensor:
    """One token's attention over this rank's KV heads ``kh`` of a cache
    (``kc`` / ``vc`` [B,S,kh.size,D], ``k_pos`` [B,S]) for the query heads
    ``sel`` (``q``: those heads where ``aligned``, else every head).  Returns
    ``sel``'s outputs where ``aligned`` (the rank's own heads), else every
    head's: each rank writes the heads it attended into zeros and one sum
    over ``kh``'s axis combines them (one rank contributes each head)."""
    b = q.shape[0]
    if not aligned:
        q = q[:, :, sel]
    local = [_kv_head_of(cfg, h) - kh.offset for h in sel]
    if local != list(range(kc.shape[2])):      # not one KV head a query head, in order
        local = torch.tensor(local, dtype=torch.long, device=q.device)
        kc, vc = expand_kv(kc, local), expand_kv(vc, local)
    o = decode_attention(q, kc, vc, k_pos, cur_pos, window)
    if aligned:
        return o
    out = o.new_zeros((b, 1, cfg.padded_heads, cfg.head_dim))
    out[:, :, sel] = o
    return all_reduce_sum(out, kh)


def _rope_q_positions(positions: torch.Tensor) -> torch.Tensor:
    """[B,S] mask positions from possibly-M-RoPE positions (the temporal row)."""
    return positions[:, 0] if positions.dim() == 3 else positions


def attn_apply(cfg: ModelConfig, seg: Segment, p: dict, x: torch.Tensor,
               ctx: BlockCtx, cross: bool = False):
    """Self- or cross-attention sublayer -> (out [B,S,d], new_cache)."""
    b, s, _ = x.shape
    q_pos = _rope_q_positions(ctx.positions)

    def kv_map(h0=0, count=None):
        return make_qh_to_kv_map(cfg.num_heads, cfg.num_kv_heads,
                                 cfg.padded_heads, x.device, h0, count)

    hs = shard_of("heads", cfg.padded_heads * cfg.head_dim)
    kvs = shard_of("kv_heads", cfg.num_kv_heads * cfg.head_dim)
    if cross:
        # keys and values from the encoder memory (gathered to whole KV
        # heads where the mesh splits them), q on this rank's own heads: no
        # RoPE, no mask, no cache write (the decode reads the ones
        # _fill_cross_kv stored)
        q, km, vm, h0 = _qkv(cfg, p, x, hs, kvs, whole_q=False, mem=ctx.memory)
        if ctx.mode == "prefill":
            o = flash_attention(q.transpose(1, 2), km.transpose(1, 2), vm.transpose(1, 2),
                                causal=False, num_heads=cfg.num_heads,
                                head_offset=h0).transpose(1, 2)
        else:
            spec = AttnSpec(causal=False, impl="auto", chunk_size=cfg.attn_chunk)
            qh_map = kv_map(h0, q.shape[2])
            o = attention(q, expand_kv(km, qh_map), expand_kv(vm, qh_map), spec,
                          q_pos, ctx.memory_positions)
        return _out_proj(p, o.reshape(b, s, -1), hs), None

    kernel_route = ctx.mode == "prefill" and ctx.default_positions
    contiguous_decode = (ctx.mode == "decode" and ctx.cache is not None
                         and "k_pool" not in ctx.cache)
    kh = None
    if contiguous_decode:
        ss, kh = _cache_shards(cfg, ctx, seg.window, ctx.cache["k"].shape[1])
    if kh is not None and kh.split:
        # a decode cache split by KV heads: this rank's k and v are its own
        # KV heads (kv_heads splits wk / wv the same way), q its own heads
        # where they are the ones that read those KV heads, else every head
        sel, aligned = _decode_heads(cfg, hs, kh)
        q, k, v, h0 = _qkv(cfg, p, x, hs, kvs, whole_q=not aligned, gather_kv=False)
    else:
        # the kernel's prefill and training attend this rank's own heads
        own_heads = kernel_route or ctx.mode == "train"
        q, k, v, h0 = _qkv(cfg, p, x, hs, kvs, whole_q=not own_heads)
    q = apply_rope(q, ctx.positions, cfg.rope_theta, cfg.mrope_sections)
    k = apply_rope(k, ctx.positions, cfg.rope_theta, cfg.mrope_sections)
    window = seg.window
    causal = seg.kind != "encoder"
    by_index = cfg.mrope_sections is not None
    new_cache = None

    if kernel_route:
        # the kernel reads the [B,S,*,D] tensors as [B,*,S,D] views in place,
        # attends the real heads over un-expanded KV and zeros the padded
        # ones (their wo rows are zero); its output is [B,S,H,D] in memory
        o = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                            causal=causal, window=window, num_heads=cfg.num_heads,
                            head_offset=h0).transpose(1, 2)
        if ctx.cache is not None:
            new_cache = _write_prefill_cache(ctx.cache, k, v, q_pos, window, by_index,
                                             index_positions=True)
    elif ctx.mode in ("train", "prefill"):
        # explicit positions (or training, which has no backward kernel):
        # plain dense/chunked attention over expanded KV, on q's heads
        spec = AttnSpec(causal=causal, window=window, impl="auto",
                        chunk_size=cfg.attn_chunk, causal_skip=cfg.causal_skip)
        qh_map = kv_map(h0, q.shape[2])
        o = attention(q, expand_kv(k, qh_map), expand_kv(v, qh_map), spec,
                      q_pos, q_pos)
        if ctx.mode == "prefill" and ctx.cache is not None:
            new_cache = _write_prefill_cache(ctx.cache, k, v, q_pos, window, by_index)
    elif ctx.cache is not None and "k_pool" in ctx.cache:
        # paged decode: write the token through the page table, then read the
        # pool through the table in-kernel, the last `window` positions of
        # a windowed segment only (padded heads come back as zeros; their
        # wo rows are zero)
        assert s == 1
        new_cache = _write_paged_cache(ctx.cache, k, v)
        o = paged_attention(q[:, 0].contiguous(), new_cache["k_pool"],
                            new_cache["v_pool"], new_cache["table"],
                            new_cache["len"], num_heads=cfg.num_heads,
                            window=window)
    else:  # decode: one token against a contiguous cache
        assert s == 1
        new_cache = _write_decode_cache(ctx.cache, k, v, ctx.cur_pos, window, by_index, ss,
                                        ctx.fill)
        kc, vc = new_cache["k"], new_cache["v"]
        if kh.split:
            o = _decode_kv_heads(cfg, q, kc, vc, new_cache["pos"], ctx.cur_pos, window, kh,
                                 sel, aligned)
            return _out_proj(p, o.reshape(b, s, -1), hs), new_cache
        if cfg.decode_kv_expand or cfg.padded_heads != cfg.num_heads:
            qh_map = kv_map()
            kc, vc = expand_kv(kc, qh_map), expand_kv(vc, qh_map)
        if ss.split:
            o = decode_attention_sharded(q, kc, vc, new_cache["pos"], ctx.cur_pos, window, ss)
        else:
            o = decode_attention(q, kc, vc, new_cache["pos"], ctx.cur_pos, window)
    return _out_proj(p, o.reshape(b, s, -1), hs), new_cache


def cross_decode(cfg: ModelConfig, p: dict, x: torch.Tensor, cache: dict) -> torch.Tensor:
    """Cross-attention of one decode token over the memory KV that
    ``_fill_cross_kv`` cached (``xk`` / ``xv`` [B, Sm, KVH, D], this rank's
    KV heads where the mesh splits them), every entry valid (the
    reference's ``_xdecoder_decode``) -> [B, 1, d].  Over the mesh the rank
    attends the query heads that read its KV heads (its own heads where
    they are those), and ``wo``'s rows are summed."""
    b, s, _ = x.shape
    hs = shard_of("heads", cfg.padded_heads * cfg.head_dim)
    kh = shard_of("kv_heads", cfg.num_kv_heads)
    sel, aligned = _decode_heads(cfg, hs, kh)
    q = x @ p["wq"]
    if not aligned:
        q = all_gather(q, -1, hs)
    q = q.reshape(b, s, -1, cfg.head_dim)
    sm = cache["xk"].shape[1]
    mem_pos = torch.arange(sm, dtype=torch.int32, device=x.device).expand(b, sm)
    big = torch.full((b,), 2**30, dtype=torch.int32, device=x.device)
    o = _decode_kv_heads(cfg, q, cache["xk"], cache["xv"], mem_pos, big, None, kh, sel,
                         aligned)
    return _out_proj(p, o.reshape(b, s, -1), hs)


def _write_prefill_cache(cache, k, v, positions, window, by_index=False,
                         index_positions=False):
    """Install prefilled KV into a (possibly ring) cache, in place.  With
    ``by_index`` (M-RoPE) token ``i`` goes to slot ``i`` and ``pos`` holds
    its temporal position.  Where token ``i`` goes to slot ``i`` (that, or
    ``index_positions``: the positions are ``0..S-1``), a cache without a
    window keeps the first ``S_cache`` tokens: the reference's scatter drops
    the writes past its end (the production prefill cells give hymba a
    prompt of the cache's length behind its meta tokens)."""
    S_cache = cache["k"].shape[1]
    b, s = positions.shape
    if window is not None and S_cache < s:
        # ring cache: keep the last S_cache tokens at slot = pos % S_cache
        k, v, positions = k[:, -S_cache:], v[:, -S_cache:], positions[:, -S_cache:]
    elif (by_index or index_positions) and S_cache < s:
        k, v, positions = k[:, :S_cache], v[:, :S_cache], positions[:, :S_cache]
    bi = torch.arange(b, device=k.device)[:, None]
    if by_index:
        slots = torch.arange(positions.shape[1], device=k.device)[None, :]
    else:
        slots = positions % S_cache if window is not None else positions
    cache["k"][bi, slots] = k.to(cache["k"].dtype)
    cache["v"][bi, slots] = v.to(cache["v"].dtype)
    cache["pos"][bi, slots] = positions.to(cache["pos"].dtype)
    return cache


def _write_paged_cache(cache, k, v):
    """Append one token through the page table, in place.

    cache: {"k_pool"/"v_pool": [P, ps, KVH, D], "table": [B, maxp] int32,
            "len": [B] int32}.  The new token for sequence b goes to physical
    page table[b, len[b] // ps], slot len[b] % ps (the logical page index is
    clamped to the table, as JAX clamps an out-of-range gather).  Page
    *allocation* happened host-side (kvcache/allocator) before this step.
    Returns the cache with ``len + 1``.
    """
    ps = cache["k_pool"].shape[1]
    lens = cache["len"].long()
    bi = torch.arange(lens.shape[0], device=lens.device)
    col = torch.clamp(lens // ps, max=cache["table"].shape[1] - 1)
    pages = cache["table"][bi, col].long()
    slots = lens % ps
    cache["k_pool"][pages, slots] = k[:, 0].to(cache["k_pool"].dtype)
    cache["v_pool"][pages, slots] = v[:, 0].to(cache["v_pool"].dtype)
    return {"k_pool": cache["k_pool"], "v_pool": cache["v_pool"],
            "table": cache["table"], "len": cache["len"] + 1}


def _gather_paged(cache):
    """Plain read path: gather table pages -> contiguous [B, S, KVH, D].

    The JAX package's decode path and the oracle the paged-attention
    kernel path is held to.  Returns (k, v, k_positions, cur_pos)."""
    b, maxp = cache["table"].shape
    ps = cache["k_pool"].shape[1]
    tbl = cache["table"].long()
    kc = cache["k_pool"][tbl].reshape(b, maxp * ps, *cache["k_pool"].shape[2:])
    vc = cache["v_pool"][tbl].reshape(b, maxp * ps, *cache["v_pool"].shape[2:])
    lens = cache["len"]                                   # post-write lengths
    pos = torch.arange(maxp * ps, dtype=torch.int32, device=lens.device)[None, :]
    kpos = torch.where(pos < lens[:, None], pos, torch.full_like(pos, -1))
    return kc, vc, kpos, lens - 1                          # cur_pos = len-1


def _write_decode_cache(cache, k, v, cur_pos, window, by_index=False,
                        seq: Optional[Shard] = None, fill: Optional[torch.Tensor] = None):
    """Write one token into a contiguous (possibly ring) cache, in place.
    With ``by_index`` (M-RoPE) it goes to the first free slot (``fill``
    where given: counted over the whole cache).  With the cache split by
    sequence (``seq``), the slot is counted in the whole cache and only the
    rank whose slice holds it writes."""
    S_cache = cache["k"].shape[1]
    b = k.shape[0]
    if by_index:
        slots = (cache["pos"] >= 0).sum(dim=1) if fill is None else fill
    else:
        total = S_cache if seq is None else seq.total
        slots = (cur_pos % total) if window is not None else cur_pos
    slots = slots.long()
    bi = torch.arange(b, device=k.device)
    new = {"k": k[:, 0], "v": v[:, 0], "pos": cur_pos}
    if seq is None or not seq.split:
        for name, t in new.items():
            cache[name][bi, slots] = t.to(cache[name].dtype)
        return cache
    local = slots - seq.offset
    own = (local >= 0) & (local < S_cache)
    local = local.clamp(0, S_cache - 1)
    for name, t in new.items():
        keep = own.view((b,) + (1,) * (t.dim() - 1))
        cache[name][bi, local] = torch.where(keep, t.to(cache[name].dtype),
                                             cache[name][bi, local])
    return cache


def first_free_slot(cfg: ModelConfig, seg: Segment, pos: torch.Tensor,
                    ctx: BlockCtx) -> torch.Tensor:
    """[B]: the first free slot of an M-RoPE model's contiguous cache, whose
    entries fill its slots in order; ``pos``: one layer's [B, S] (this
    rank's slice where the mesh splits the cache by sequence, the counts
    then summed over the slices)."""
    ss, _ = _cache_shards(cfg, ctx, seg.window, pos.shape[1])
    return all_reduce_sum((pos >= 0).sum(dim=1), ss)


def attn_cache_init(cfg: ModelConfig, seg: Segment, batch: int, seq_len: int,
                    dtype, device) -> Dict[str, torch.Tensor]:
    """Per-LAYER cache slice geometry (stacked by the caller)."""
    S = seq_len if seg.window is None else min(seq_len, seg.window)
    kvh = cfg.num_kv_heads
    return {
        "k": torch.zeros((batch, S, kvh, cfg.head_dim), dtype=dtype, device=device),
        "v": torch.zeros((batch, S, kvh, cfg.head_dim), dtype=dtype, device=device),
        "pos": torch.full((batch, S), -1, dtype=torch.int32, device=device),
    }


# ----------------------------------------------------------------------- MLP


def mlp_param_specs(cfg: ModelConfig) -> dict:
    E, F = cfg.d_model, cfg.d_ff
    if cfg.act == "gelu":
        return {
            "w_in": ParamSpec((E, F), ("embed", "ffn"), fan_in_init),
            "b_in": ParamSpec((F,), ("ffn",), zeros_init),
            "w_out": ParamSpec((F, E), ("ffn", "embed"), fan_in_init),
            "b_out": ParamSpec((E,), ("embed",), zeros_init),
        }
    return {
        "w_gate": ParamSpec((E, F), ("embed", "ffn"), fan_in_init),
        "w_up": ParamSpec((E, F), ("embed", "ffn"), fan_in_init),
        "w_down": ParamSpec((F, E), ("ffn", "embed"), fan_in_init),
    }


def mlp_apply(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """Split on ffn over the mesh, the ranks' partial products are summed
    and ``b_out`` is added once, after the sum."""
    fs = shard_of("ffn", cfg.d_ff)
    x = to_local_region(x, fs)
    if cfg.act == "gelu":
        if not fs.split:
            return gelu_mlp(x, p["w_in"], p["b_in"], p["w_out"], p["b_out"])
        return all_reduce_sum(gelu_mlp(x, p["w_in"], p["b_in"], p["w_out"]), fs) + p["b_out"]
    return all_reduce_sum(swiglu(x, p["w_gate"], p["w_up"], p["w_down"]), fs)


# ---------------------------------------------------------------- Mamba


def _inner_shard(cfg: ModelConfig, d_inner: int) -> Shard:
    """This rank's ``ssm_inner`` channels of a Mamba mixer or an mLSTM block
    of ``d_inner`` channels.  ``in_proj`` / ``up_proj`` split their
    ``2·d_inner`` columns by the same rule: a split of the one without the
    other (``d_inner`` not divisible, ``2·d_inner`` divisible) is refused."""
    ss = shard_of("ssm_inner", d_inner)
    if shard_of("ssm_inner", 2 * d_inner).split != ss.split:
        raise NotImplementedError(f"{cfg.name}: d_inner {d_inner} does not split evenly "
                                  f"where 2·d_inner does")
    return ss


# --------------------------------------------------------------- block kinds


def block_param_specs(cfg: ModelConfig, seg: Segment) -> dict:
    norm = lambda: ParamSpec((cfg.d_model,), ("embed",), ones_init)  # noqa: E731
    if seg.kind in ("dense", "encoder"):
        return {"ln1": norm(), "attn": attn_param_specs(cfg),
                "ln2": norm(), "mlp": mlp_param_specs(cfg)}
    if seg.kind == "xdecoder":
        return {"ln1": norm(), "attn": attn_param_specs(cfg),
                "lnx": norm(), "xattn": attn_param_specs(cfg),
                "ln2": norm(), "mlp": mlp_param_specs(cfg)}
    if seg.kind == "moe":
        return {"ln1": norm(), "attn": attn_param_specs(cfg),
                "ln2": norm(),
                "moe": moe_param_specs(cfg.d_model, cfg.d_ff, cfg.num_experts,
                                       cfg.moe_sharding)}
    if seg.kind == "hymba":
        return {
            "ln1": norm(), "attn": attn_param_specs(cfg),
            "mamba": mamba_param_specs(cfg.d_model, cfg.d_inner, cfg.ssm_state,
                                       cfg.d_conv, cfg.dt_rank_actual),
            "beta_attn": ParamSpec((cfg.d_model,), ("embed",), ones_init),
            "beta_mamba": ParamSpec((cfg.d_model,), ("embed",), ones_init),
            "ln_attn_out": norm(), "ln_mamba_out": norm(),
            "ln2": norm(), "mlp": mlp_param_specs(cfg),
        }
    if seg.kind == "mlstm":
        return mlstm_block_specs(cfg.d_model, cfg.num_heads, cfg.mlstm_proj_factor,
                                 cfg.mlstm_qk_factor, cfg.d_conv)
    if seg.kind == "slstm":
        return slstm_block_specs(cfg.d_model, cfg.num_heads, d_conv=cfg.d_conv)
    raise ValueError(seg.kind)


def block_apply(cfg: ModelConfig, seg: Segment, p: dict, x: torch.Tensor,
                ctx: BlockCtx) -> Tuple[torch.Tensor, Any, Dict[str, torch.Tensor]]:
    """Returns (x_out, new_cache_layer, aux_losses)."""
    aux: Dict[str, torch.Tensor] = {}
    if seg.kind in ("dense", "encoder"):
        h, new_cache = attn_apply(cfg, seg, p["attn"], rms_norm(x, p["ln1"], cfg.norm_eps), ctx)
        x = x + h
        x = x + mlp_apply(cfg, p["mlp"], rms_norm(x, p["ln2"], cfg.norm_eps))
        return x, new_cache, aux

    if seg.kind == "xdecoder":
        # the self-attention cache also holds the memory KV (xk, xv): it is
        # written in place and handed back whole
        h, new_cache = attn_apply(cfg, seg, p["attn"], rms_norm(x, p["ln1"], cfg.norm_eps), ctx)
        x = x + h
        hq = rms_norm(x, p["lnx"], cfg.norm_eps)
        if ctx.mode == "decode":
            x = x + cross_decode(cfg, p["xattn"], hq, ctx.cache)
        else:
            x = x + attn_apply(cfg, seg, p["xattn"], hq, ctx, cross=True)[0]
        x = x + mlp_apply(cfg, p["mlp"], rms_norm(x, p["ln2"], cfg.norm_eps))
        return x, new_cache, aux

    if seg.kind == "moe":
        h, new_cache = attn_apply(cfg, seg, p["attn"], rms_norm(x, p["ln1"], cfg.norm_eps), ctx)
        x = x + h
        y, aux = moe_forward(p["moe"], rms_norm(x, p["ln2"], cfg.norm_eps),
                             cfg.top_k, cfg.capacity_factor,
                             shard_local=cfg.moe_shard_local,
                             moe_sharding=cfg.moe_sharding)
        return x + y, new_cache, aux

    if seg.kind == "hymba":
        # attention and a Mamba mixer on the same normed input
        normed = rms_norm(x, p["ln1"], cfg.norm_eps)
        h_attn, new_attn_cache = attn_apply(cfg, seg, p["attn"], normed, ctx)
        mc = ctx.cache if ctx.cache is not None else {}
        ss = _inner_shard(cfg, cfg.d_inner)
        if ctx.mode == "decode":
            h_mamba, (ssm_s, conv_s) = mamba_decode(
                p["mamba"], normed, mc.get("ssm"), mc.get("conv"), cfg.dt_rank_actual, ss)
        else:
            h_mamba, (ssm_s, conv_s) = mamba_forward(
                p["mamba"], normed, mc.get("ssm"), mc.get("conv"),
                cfg.dt_rank_actual, cfg.ssm_chunk, ss)
        # both branches come back summed over the mesh: the RMS norms read
        # whole vectors
        fused = 0.5 * (rms_norm(h_attn, p["ln_attn_out"], cfg.norm_eps) * p["beta_attn"]
                       + rms_norm(h_mamba, p["ln_mamba_out"], cfg.norm_eps) * p["beta_mamba"])
        x = x + fused
        x = x + mlp_apply(cfg, p["mlp"], rms_norm(x, p["ln2"], cfg.norm_eps))
        new_cache = dict(new_attn_cache or {})
        if ctx.mode != "train":
            new_cache["ssm"] = ssm_s
            new_cache["conv"] = conv_s
        return x, (new_cache or None), aux

    if seg.kind in STATE_NAMES:
        names = STATE_NAMES[seg.kind]
        mc = ctx.cache if ctx.cache is not None else {}
        state = tuple(mc[k] for k in names) if names[0] in mc else None
        if seg.kind == "mlstm":
            x, (state, conv_s) = mlstm_block_forward(
                p, x, cfg.num_heads, state=state, conv_state=mc.get("conv"),
                chunk_size=cfg.mlstm_chunk, decode=ctx.mode == "decode",
                shard=_inner_shard(cfg, int(cfg.mlstm_proj_factor * cfg.d_model)))
        else:
            # the FFN on ffn; the conv state on ssm_inner over d_model, as
            # the cache's spec splits it (the conv itself runs whole)
            x, (state, conv_s) = slstm_block_forward(
                p, x, cfg.num_heads, state=state, conv_state=mc.get("conv"),
                ffn=shard_of("ffn", slstm_d_ff(cfg.d_model)),
                conv=shard_of("ssm_inner", cfg.d_model))
        if ctx.mode == "train":
            return x, None, aux
        new = dict(zip(names, state), conv=conv_s)
        if ctx.cache is None:
            return x, new, aux
        for k, t in new.items():                # the state, in place
            ctx.cache[k].copy_(t)
        return x, ctx.cache, aux

    raise ValueError(seg.kind)


def block_cache_init(cfg: ModelConfig, seg: Segment, batch: int, seq_len: int,
                     dtype, device) -> Dict[str, torch.Tensor]:
    """One layer's cache slice for this segment kind."""
    if seg.kind in ("dense", "moe", "encoder", "xdecoder"):
        return attn_cache_init(cfg, seg, batch, seq_len, dtype, device)
    if seg.kind == "hymba":
        c = attn_cache_init(cfg, seg, batch, seq_len, dtype, device)
        c["ssm"], c["conv"] = mamba_state_init(batch, cfg.d_inner, cfg.ssm_state,
                                               cfg.d_conv, dtype, device)
        return c
    H = cfg.num_heads
    f32 = dict(dtype=torch.float32, device=device)
    if seg.kind == "mlstm":
        d_inner = int(cfg.mlstm_proj_factor * cfg.d_model)
        dk = int(cfg.mlstm_qk_factor * d_inner) // H
        dv = d_inner // H
        return {"C": torch.zeros((batch, H, dv, dk), **f32),
                "n": torch.zeros((batch, H, dk), **f32),
                "m": torch.full((batch, H), -30.0, **f32),
                "conv": torch.zeros((batch, cfg.d_conv - 1, d_inner), dtype=dtype,
                                    device=device)}
    if seg.kind == "slstm":
        dh = cfg.d_model // H
        return {"c": torch.zeros((batch, H, dh), **f32),
                "n": torch.zeros((batch, H, dh), **f32),
                "m": torch.full((batch, H, dh), -30.0, **f32),
                "h": torch.zeros((batch, H, dh), **f32),
                "conv": torch.zeros((batch, cfg.d_conv - 1, cfg.d_model), dtype=dtype,
                                    device=device)}
    raise ValueError(seg.kind)
