"""Decoder blocks, cache-aware (port of ``repro/models/blocks.py``): the
dense, MoE and hymba kinds.

A block provides ``block_param_specs(cfg, seg)`` (one layer's ParamSpec
tree) and ``block_apply(cfg, seg, p, x, ctx) -> (x, new_cache_layer, aux)``.
``ctx`` carries the mode ("train" | "prefill" | "decode"), positions and
the per-layer cache slice.  A prefill whose positions are the default
``0..S-1`` runs its self-attention in the ``flash_attention`` kernel; a
prefill with explicit positions keeps the plain ``attention``.  A hymba
block runs attention and a Mamba mixer side by side on the same input
(``models/ssm.py``); an MoE block's FFN is ``models/moe.py``.  The xLSTM
kinds and cross-attention are not ported yet.

Cache writes are **in-place** (JAX rebuilt the cache with ``.at[].set``):
a writer returns the very tensors it was given, updated, so the caller can
tell what was written in place from what is new.  On the paged decode path
the new token goes into the pool with one index write and attention reads
the pool through the page table with the ``paged_attention`` kernel
(with the segment's sliding window, if any: the pool holds every position
and the kernel reads only the last ``window``);
:func:`_gather_paged` (gather pages, then plain ``decode_attention``) stays
as the oracle the tests hold that path to.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig, Segment
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
    expand_kv,
    make_qh_to_kv_map,
    rms_norm,
    swiglu,
)


@dataclasses.dataclass
class BlockCtx:
    mode: str                                   # train | prefill | decode
    positions: torch.Tensor                     # [B, S]
    cache: Optional[Dict[str, torch.Tensor]] = None   # this layer's cache slice
    cur_pos: Optional[torch.Tensor] = None      # [B] decode position
    # positions are 0..S-1 in every row (the caller passed none): prefill
    # self-attention then takes the flash_attention kernel
    default_positions: bool = False


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


def _qkv(cfg: ModelConfig, p: dict, x: torch.Tensor):
    b, s, _ = x.shape
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, cfg.padded_heads, cfg.head_dim)
    k = k.reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    return q, k, v


def attn_apply(cfg: ModelConfig, seg: Segment, p: dict, x: torch.Tensor,
               ctx: BlockCtx):
    """Self-attention sublayer -> (out [B,S,d], new_cache)."""
    b, s, _ = x.shape
    q, k, v = _qkv(cfg, p, x)
    q_pos = ctx.positions
    q = apply_rope(q, ctx.positions, cfg.rope_theta, cfg.mrope_sections)
    k = apply_rope(k, ctx.positions, cfg.rope_theta, cfg.mrope_sections)
    window = seg.window
    new_cache = None

    def kv_map():
        return make_qh_to_kv_map(cfg.num_heads, cfg.num_kv_heads,
                                 cfg.padded_heads, x.device)

    if ctx.mode == "prefill" and ctx.default_positions:
        # the kernel reads the [B,S,*,D] tensors as [B,*,S,D] views in place,
        # attends the real heads over un-expanded KV and zeros the padded
        # ones (their wo rows are zero); its output is [B,S,H,D] in memory
        o = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                            causal=True, window=window,
                            num_heads=cfg.num_heads).transpose(1, 2)
        if ctx.cache is not None:
            new_cache = _write_prefill_cache(ctx.cache, k, v, q_pos, window)
    elif ctx.mode in ("train", "prefill"):
        # explicit positions (or training, which has no backward kernel):
        # plain dense/chunked attention over expanded KV
        spec = AttnSpec(causal=True, window=window, impl="auto",
                        chunk_size=cfg.attn_chunk, causal_skip=cfg.causal_skip)
        qh_map = kv_map()
        o = attention(q, expand_kv(k, qh_map), expand_kv(v, qh_map), spec,
                      q_pos, q_pos)
        if ctx.mode == "prefill" and ctx.cache is not None:
            new_cache = _write_prefill_cache(ctx.cache, k, v, q_pos, window)
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
        new_cache = _write_decode_cache(ctx.cache, k, v, ctx.cur_pos, window)
        kc, vc = new_cache["k"], new_cache["v"]
        if cfg.decode_kv_expand or cfg.padded_heads != cfg.num_heads:
            qh_map = kv_map()
            kc, vc = expand_kv(kc, qh_map), expand_kv(vc, qh_map)
        o = decode_attention(q, kc, vc, new_cache["pos"], ctx.cur_pos, window)
    return o.reshape(b, s, -1) @ p["wo"], new_cache


def _write_prefill_cache(cache, k, v, positions, window):
    """Install prefilled KV into a (possibly ring) cache, in place."""
    S_cache = cache["k"].shape[1]
    b, s = positions.shape
    if window is not None and S_cache < s:
        # ring cache: keep the last S_cache tokens at slot = pos % S_cache
        k, v, positions = k[:, -S_cache:], v[:, -S_cache:], positions[:, -S_cache:]
    bi = torch.arange(b, device=k.device)[:, None]
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


def _write_decode_cache(cache, k, v, cur_pos, window):
    """Write one token into a contiguous (possibly ring) cache, in place."""
    S_cache = cache["k"].shape[1]
    b = k.shape[0]
    slots = (cur_pos % S_cache) if window is not None else cur_pos
    slots = slots.long()
    bi = torch.arange(b, device=k.device)
    cache["k"][bi, slots] = k[:, 0].to(cache["k"].dtype)
    cache["v"][bi, slots] = v[:, 0].to(cache["v"].dtype)
    cache["pos"][bi, slots] = cur_pos.to(cache["pos"].dtype)
    return cache


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
    if cfg.act != "silu":
        raise NotImplementedError(f"act {cfg.act!r} is not ported yet")
    E, F = cfg.d_model, cfg.d_ff
    return {
        "w_gate": ParamSpec((E, F), ("embed", "ffn"), fan_in_init),
        "w_up": ParamSpec((E, F), ("embed", "ffn"), fan_in_init),
        "w_down": ParamSpec((F, E), ("ffn", "embed"), fan_in_init),
    }


def mlp_apply(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    return swiglu(x, p["w_gate"], p["w_up"], p["w_down"])


# --------------------------------------------------------------- block kinds


def _check_kind(seg: Segment) -> None:
    if seg.kind not in ("dense", "moe", "hymba"):
        raise NotImplementedError(
            f"block kind {seg.kind!r} is not ported to repro_torch yet "
            f"(ROADMAP.md, Queue 1 item 7)")


def block_param_specs(cfg: ModelConfig, seg: Segment) -> dict:
    _check_kind(seg)
    norm = lambda: ParamSpec((cfg.d_model,), ("embed",), ones_init)  # noqa: E731
    if seg.kind == "dense":
        return {"ln1": norm(), "attn": attn_param_specs(cfg),
                "ln2": norm(), "mlp": mlp_param_specs(cfg)}
    if seg.kind == "moe":
        return {"ln1": norm(), "attn": attn_param_specs(cfg),
                "ln2": norm(),
                "moe": moe_param_specs(cfg.d_model, cfg.d_ff, cfg.num_experts,
                                       cfg.moe_sharding)}
    return {                                    # hymba
        "ln1": norm(), "attn": attn_param_specs(cfg),
        "mamba": mamba_param_specs(cfg.d_model, cfg.d_inner, cfg.ssm_state,
                                   cfg.d_conv, cfg.dt_rank_actual),
        "beta_attn": ParamSpec((cfg.d_model,), ("embed",), ones_init),
        "beta_mamba": ParamSpec((cfg.d_model,), ("embed",), ones_init),
        "ln_attn_out": norm(), "ln_mamba_out": norm(),
        "ln2": norm(), "mlp": mlp_param_specs(cfg),
    }


def block_apply(cfg: ModelConfig, seg: Segment, p: dict, x: torch.Tensor,
                ctx: BlockCtx) -> Tuple[torch.Tensor, Any, Dict[str, torch.Tensor]]:
    """Returns (x_out, new_cache_layer, aux_losses)."""
    _check_kind(seg)
    aux: Dict[str, torch.Tensor] = {}
    if seg.kind == "dense":
        h, new_cache = attn_apply(cfg, seg, p["attn"], rms_norm(x, p["ln1"], cfg.norm_eps), ctx)
        x = x + h
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

    # hymba: attention and a Mamba mixer on the same normed input
    normed = rms_norm(x, p["ln1"], cfg.norm_eps)
    h_attn, new_attn_cache = attn_apply(cfg, seg, p["attn"], normed, ctx)
    mc = ctx.cache if ctx.cache is not None else {}
    if ctx.mode == "decode":
        h_mamba, (ssm_s, conv_s) = mamba_decode(
            p["mamba"], normed, mc.get("ssm"), mc.get("conv"), cfg.dt_rank_actual)
    else:
        h_mamba, (ssm_s, conv_s) = mamba_forward(
            p["mamba"], normed, mc.get("ssm"), mc.get("conv"),
            cfg.dt_rank_actual, cfg.ssm_chunk)
    fused = 0.5 * (rms_norm(h_attn, p["ln_attn_out"], cfg.norm_eps) * p["beta_attn"]
                   + rms_norm(h_mamba, p["ln_mamba_out"], cfg.norm_eps) * p["beta_mamba"])
    x = x + fused
    x = x + mlp_apply(cfg, p["mlp"], rms_norm(x, p["ln2"], cfg.norm_eps))
    new_cache = dict(new_attn_cache or {})
    if ctx.mode != "train":
        new_cache["ssm"] = ssm_s
        new_cache["conv"] = conv_s
    return x, (new_cache or None), aux


def block_cache_init(cfg: ModelConfig, seg: Segment, batch: int, seq_len: int,
                     dtype, device) -> Dict[str, torch.Tensor]:
    """One layer's cache slice for this segment kind."""
    _check_kind(seg)
    c = attn_cache_init(cfg, seg, batch, seq_len, dtype, device)
    if seg.kind == "hymba":
        c["ssm"], c["conv"] = mamba_state_init(batch, cfg.d_inner, cfg.ssm_state,
                                               cfg.d_conv, dtype, device)
    return c
