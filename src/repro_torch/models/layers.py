"""Core transformer layers: norms, RoPE, GQA attention, MLPs.

Port of ``repro/models/layers.py``.  Attention implementations, as in
the JAX package:

  dense        full [Sq, Sk] score matrix + mask — exact baseline for short
               sequences (the serving prefill buckets).
  chunked      online softmax over KV chunks (a Python loop where JAX used
               ``lax.scan``) with the flash-style backward of
               :class:`FlashVJPAttention`; ``causal_skip=True`` instead
               skips fully masked KV chunks per Q chunk (forward only).

These are the plain paths.  A prefill over the default positions
``0..S-1`` runs its attention in the ``flash_attention`` kernel instead
(``models/blocks.py``), the drop-in the JAX package names for its Pallas
kernel; explicit positions and training keep the functions here.  All
softmax/normalizer math runs in fp32 regardless of compute dtype.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..distributed.tensor_parallel import Shard, all_reduce_max, all_reduce_sum

NEG_INF = -2.0e38  # fp32-safe mask value (avoid inf arithmetic -> NaN)


# --------------------------------------------------------------------- norms


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------- RoPE


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies for half-rotation RoPE: [head_dim // 2], fp32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               mrope_sections=None) -> torch.Tensor:
    """Rotary embedding (LLaMA half-rotation layout).

    x: [B, S, H, D]; positions: [B, S] int — or [B, 3, S] for M-RoPE
    (temporal / height / width position triplets; Qwen2-VL §2), where
    ``mrope_sections`` gives the number of frequency pairs each component
    drives (they sum to D // 2).
    """
    d2 = x.shape[-1] // 2
    inv = rope_freqs(x.shape[-1], theta, x.device)          # [d2]
    if mrope_sections is None:
        angles = positions.float()[..., None] * inv         # [B, S, d2]
    else:
        assert positions.dim() == 3 and positions.shape[1] == 3, positions.shape
        assert sum(mrope_sections) == d2, (mrope_sections, d2)
        # which position component drives each frequency pair
        comp = torch.repeat_interleave(
            torch.arange(3, device=x.device),
            torch.tensor(mrope_sections, device=x.device), output_size=d2)   # [d2]
        angles = positions.float()[:, comp].transpose(1, 2) * inv   # [B, S, d2]
    cos = torch.cos(angles)[..., None, :]                   # [B, S, 1, d2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :d2].float(), x[..., d2:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------------ attention


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    """Static attention behavior for one call."""

    causal: bool = True
    window: Optional[int] = None       # sliding-window size (None = full)
    impl: str = "auto"                 # "dense" | "chunked" | "auto"
    chunk_size: int = 512
    causal_skip: bool = False          # triangular chunk schedule


def _group(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """[B,S,H,D] -> [B,S,KVH,rep,D] grouped for GQA einsums."""
    b, s, h, d = q.shape
    assert h % n_kv == 0, (h, n_kv)
    return q.reshape(b, s, n_kv, h // n_kv, d)


def _mask_bias(q_pos, k_pos, spec: AttnSpec, k_valid=None) -> torch.Tensor:
    """[B, Sq, Sk] fp32 additive bias from positions (+ validity)."""
    d = q_pos[:, :, None] - k_pos[:, None, :]
    ok = torch.ones(d.shape, dtype=torch.bool, device=d.device)
    if spec.causal:
        ok &= d >= 0
    if spec.window is not None:
        ok &= d < spec.window
    if k_valid is not None:
        ok &= k_valid[:, None, :]
    zero = torch.zeros((), dtype=torch.float32, device=d.device)
    return torch.where(ok, zero, torch.full_like(zero, NEG_INF))


def attention(q, k, v, spec: AttnSpec, q_positions, k_positions,
              k_valid=None) -> torch.Tensor:
    """GQA attention -> [B, Sq, H, D].  Softmax in fp32.

    q: [B, Sq, H, D]; k/v: [B, Sk, KVH, D]; positions int [B, S*];
    k_valid: optional [B, Sk] bool (cache validity).
    """
    impl = spec.impl
    if impl == "auto":
        impl = "chunked" if q.shape[1] * k.shape[1] > 1024 * 1024 else "dense"
    if impl == "dense":
        return _dense_attention(q, k, v, spec, q_positions, k_positions, k_valid)
    return _chunked_attention(q, k, v, spec, q_positions, k_positions, k_valid)


def _dense_attention(q, k, v, spec, q_pos, k_pos, k_valid):
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    qg = _group(q, kvh).float()                                  # [B,Sq,KVH,rep,D]
    scale = 1.0 / math.sqrt(d)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg, k.float()) * scale  # [B,KVH,rep,Sq,Sk]
    s = s + _mask_bias(q_pos, k_pos, spec, k_valid)[:, None, None]
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrqk,bkgd->bqgrd", p, v.float())
    return o.reshape(b, sq, h, d).to(q.dtype)


def _pad_chunks(k, v, spec, k_pos, k_valid):
    """KV padded to a chunk multiple with invalid entries -> (k, v, k_pos,
    k_valid, chunk)."""
    b, sk = k.shape[0], k.shape[1]
    ck = min(spec.chunk_size, sk)
    if k_valid is None:
        k_valid = torch.ones((b, sk), dtype=torch.bool, device=k.device)
    if sk % ck:
        pad = ck - sk % ck
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = F.pad(k_pos, (0, pad), value=2**30)
        k_valid = F.pad(k_valid, (0, pad), value=False)
    return k, v, k_pos, k_valid, ck


def _chunked_attention(q, k, v, spec, q_pos, k_pos, k_valid):
    """Online softmax over KV chunks: the JAX package's flash-VJP attention
    (:class:`FlashVJPAttention`) and, with ``causal_skip``, its triangular
    schedule (forward only, as there)."""
    if not spec.causal_skip:
        return FlashVJPAttention.apply(q, k, v, q_pos, k_pos, k_valid, spec)
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    k, v, k_pos, k_valid, ck = _pad_chunks(k, v, spec, k_pos, k_valid)
    n_chunks = k.shape[1] // ck
    qg = _group(q, kvh).float()
    if spec.causal and sq > 1:
        # triangular schedule: each Q chunk sees only the KV chunks that can
        # be unmasked for it (ascending, chunk-aligned positions)
        cq = min(spec.chunk_size, sq)
        assert sq % cq == 0
        outs = []
        for qi in range(sq // cq):
            hi = min(((qi + 1) * cq - 1) // ck + 1, n_chunks)
            lo = max(0, (qi * cq - spec.window) // ck) if spec.window is not None else 0
            sl = slice(qi * cq, (qi + 1) * cq)
            outs.append(_online_softmax(qg[:, sl], q_pos[:, sl], k, v, k_pos,
                                        k_valid, spec, ck, range(lo, hi))[0])
        return torch.cat(outs, dim=1).to(q.dtype)
    return _online_softmax(qg, q_pos, k, v, k_pos, k_valid, spec, ck,
                           range(n_chunks))[0].to(q.dtype)


def _online_softmax(qg, q_pos, k, v, k_pos, k_valid, spec, ck, chunks):
    """Flash recurrence over the given KV chunks -> (o [B, Sq, H, D] fp32,
    m, l [B, KVH, rep, Sq] fp32: the running max and normaliser)."""
    b, sq, kvh, rep, d = qg.shape
    scale = 1.0 / math.sqrt(d)
    m = torch.full((b, kvh, rep, sq), NEG_INF, dtype=torch.float32, device=qg.device)
    l = torch.zeros((b, kvh, rep, sq), dtype=torch.float32, device=qg.device)
    acc = torch.zeros((b, kvh, rep, sq, d), dtype=torch.float32, device=qg.device)
    for c in chunks:
        sl = slice(c * ck, (c + 1) * ck)
        kc, vc = k[:, sl], v[:, sl]
        s = torch.einsum("bqgrd,bkgd->bgrqk", qg, kc.float()) * scale
        s = s + _mask_bias(q_pos, k_pos[:, sl], spec, k_valid[:, sl])[:, None, None]
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        # p rounded to the value dtype, products accumulated in fp32 (the
        # JAX package's preferred_element_type=float32)
        acc = acc * corr[..., None] + torch.einsum(
            "bgrqk,bkgd->bgrqd", p.to(vc.dtype).float(), vc.float())
        m = m_new
    o = acc / torch.clamp(l[..., None], min=1e-37)
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, kvh * rep, d), m, l


def _chunked_forward(q, k, v, spec, q_pos, k_pos, k_valid):
    """Every KV chunk through the recurrence -> (o [B,Sq,H,D] in q's dtype,
    m, l)."""
    kvh = k.shape[2]
    k, v, k_pos, k_valid, ck = _pad_chunks(k, v, spec, k_pos, k_valid)
    o, m, l = _online_softmax(_group(q, kvh).float(), q_pos, k, v, k_pos, k_valid,
                              spec, ck, range(k.shape[1] // ck))
    return o.to(q.dtype), m, l


def _chunked_backward(q, k, v, spec, q_pos, k_pos, k_valid, o, m, l, do):
    """The flash backward: probabilities recomputed chunk by chunk from the
    saved ``(m, l)`` -> (dq, dk, dv) in the inputs' dtypes."""
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    sk_orig = k.shape[1]
    k, v, k_pos, k_valid, ck = _pad_chunks(k, v, spec, k_pos, k_valid)
    rep = h // kvh
    scale = 1.0 / math.sqrt(d)
    qg = _group(q, kvh).float()                                   # [B,Sq,g,r,D]
    og = _group(o, kvh).float()
    dog = _group(do, kvh).float()
    l_safe = torch.clamp(l, min=1e-37)                            # [B,g,r,Sq]
    D = torch.einsum("bqgrd,bqgrd->bgrq", dog, og)                # rowsum(do*o)
    dq = torch.zeros((b, sq, kvh, rep, d), dtype=torch.float32, device=q.device)
    dks, dvs = [], []
    for c in range(k.shape[1] // ck):
        sl = slice(c * ck, (c + 1) * ck)
        kc, vc = k[:, sl].float(), v[:, sl].float()
        s = torch.einsum("bqgrd,bkgd->bgrqk", qg, kc) * scale
        s = s + _mask_bias(q_pos, k_pos[:, sl], spec, k_valid[:, sl])[:, None, None]
        p = torch.exp(s - m[..., None]) / l_safe[..., None]       # normalised
        dp = torch.einsum("bqgrd,bkgd->bgrqk", dog, vc)
        ds = p * (dp - D[..., None])
        dq = dq + torch.einsum("bgrqk,bkgd->bqgrd", ds, kc) * scale
        dks.append(torch.einsum("bgrqk,bqgrd->bkgd", ds, qg) * scale)
        dvs.append(torch.einsum("bgrqk,bqgrd->bkgd", p, dog))
    dk = torch.cat(dks, dim=1)[:, :sk_orig]
    dv = torch.cat(dvs, dim=1)[:, :sk_orig]
    return dq.reshape(b, sq, h, d).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FlashVJPAttention(torch.autograd.Function):
    """Chunked attention with a flash-style backward (the JAX package's
    ``_flash_vjp_attention``, a ``jax.custom_vjp``).

    Plain autograd through the online-softmax loop would save every KV
    chunk's fp32 probabilities, O(Sq·Sk) per head.  The forward saves only
    ``(q, k, v, positions, o, m, l)`` and the backward recomputes the
    probabilities chunk by chunk, the FlashAttention recurrence:

        D    = rowsum(do ⊙ o)
        P_c  = exp(s_c − m) / l
        ds_c = P_c ⊙ (do·v_cᵀ − D)
        dq  += ds_c·k_c·scale;  dk_c = ds_cᵀ·q·scale;  dv_c = P_cᵀ·do

    Plain PyTorch, as the JAX package computes it outside any Pallas
    kernel.  ``apply(q, k, v, q_pos, k_pos, k_valid, spec)``; positions and
    validity get no gradient.
    """

    @staticmethod
    def forward(ctx, q, k, v, q_pos, k_pos, k_valid, spec):
        o, m, l = _chunked_forward(q, k, v, spec, q_pos, k_pos, k_valid)
        ctx.spec = spec
        ctx.save_for_backward(q, k, v, q_pos, k_pos, k_valid, o, m, l)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, q_pos, k_pos, k_valid, o, m, l = ctx.saved_tensors
        dq, dk, dv = _chunked_backward(q, k, v, ctx.spec, q_pos, k_pos, k_valid,
                                       o, m, l, do)
        return dq, dk, dv, None, None, None, None


def _decode_scores(q, k_cache, k_positions, cur_pos, window):
    """A decode token's fp32 scores [B,KVH,rep,S] against the cache and
    which keys it sees [B, S]."""
    kvh = k_cache.shape[2]
    qg = _group(q, kvh).float()[:, 0]                          # [B,KVH,rep,D]
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bgrd,bkgd->bgrk", qg, k_cache.float()) * scale
    dlt = cur_pos[:, None] - k_positions                       # [B, S]
    ok = (k_positions >= 0) & (dlt >= 0)
    if window is not None:
        ok &= dlt < window
    return s, ok


def decode_attention(q, k_cache, v_cache, k_positions, cur_pos,
                     window: Optional[int] = None) -> torch.Tensor:
    """Single-token attention against a (possibly ring) KV cache.

    q: [B, 1, H, D]; k/v_cache: [B, S, KVH, D]; k_positions: [B, S] int
    (< 0 => invalid); cur_pos: [B] int.
    """
    b, _, h, d = q.shape
    s, ok = _decode_scores(q, k_cache, k_positions, cur_pos, window)
    zero = torch.zeros((), dtype=torch.float32, device=q.device)
    s = s + torch.where(ok, zero, torch.full_like(zero, NEG_INF))[:, None, None, :]
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrk,bkgd->bgrd", p, v_cache.float())
    return o.reshape(b, 1, h, d).to(q.dtype)


def decode_attention_sharded(q, k_cache, v_cache, k_positions, cur_pos,
                             window: Optional[int], seq: Shard) -> torch.Tensor:
    """:func:`decode_attention` over a cache split by sequence over the
    mesh (``seq``): each rank attends every head over its slice, then the
    slices are combined flash-decoding style,

        m = max_r m_r,   o = sum_r e^{m_r - m} acc_r / sum_r e^{m_r - m} l_r

    with ``acc_r`` the slice's unnormalised ``p @ v`` and ``l_r`` its
    normaliser; a slice with no visible key has ``m_r = -inf`` and weight 0.
    Arguments as :func:`decode_attention`'s, the cache and positions being
    this rank's slice."""
    b, _, h, d = q.shape
    s, ok = _decode_scores(q, k_cache, k_positions, cur_pos, window)
    s = s.masked_fill(~ok[:, None, None, :], float("-inf"))
    m = s.amax(dim=-1)                                         # [B,KVH,rep]
    p = torch.exp(s - torch.where(torch.isfinite(m), m, 0.0)[..., None])
    acc = torch.einsum("bgrk,bkgd->bgrd", p, v_cache.float())
    m_all = all_reduce_max(m.clone(), seq)
    w = torch.exp(m - torch.where(torch.isfinite(m_all), m_all, 0.0))
    parts = torch.cat([acc * w[..., None], (p.sum(dim=-1) * w)[..., None]], dim=-1)
    parts = all_reduce_sum(parts, seq)
    o = parts[..., :d] / torch.clamp(parts[..., d:], min=1e-37)
    return o.reshape(b, 1, h, d).to(q.dtype)


# ---------------------------------------------------------------------- MLPs


def swiglu(x, w_gate, w_up, w_down) -> torch.Tensor:
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def gelu_mlp(x, w_in, b_in, w_out, b_out=None) -> torch.Tensor:
    """GELU MLP with biases (``jax.nn.gelu``'s default: the tanh form);
    ``b_out`` None leaves the output bias to the caller."""
    y = F.gelu(x @ w_in + b_in, approximate="tanh") @ w_out
    return y if b_out is None else y + b_out


# ---------------------------------------------------------- GQA head mapping


def make_qh_to_kv_map(num_heads: int, num_kv_heads: int, padded_heads: int,
                      device=None, offset: int = 0,
                      count: Optional[int] = None) -> Optional[torch.Tensor]:
    """Per-Q-head KV index map, or None when plain grouping is exact.

    Padding Q heads changes ``i // group`` assignments, so any padded config
    uses an explicit gather map: real head i -> i // group (original
    grouping); padded heads -> kv 0 (their o_proj rows are zero).  Every
    grouped (GQA) config also expands, as in the JAX package.  ``offset``
    / ``count``: the map of global heads ``offset .. offset + count - 1``
    only (a rank's own heads; default: every head from ``offset``).
    """
    count = padded_heads - offset if count is None else count
    if (padded_heads == num_heads and num_kv_heads == num_heads
            and (offset, count) == (0, padded_heads)):
        return None
    group = max(1, num_heads // num_kv_heads)
    idx = [min(i // group, num_kv_heads - 1) if i < num_heads else 0
           for i in range(offset, offset + count)]
    return torch.tensor(idx, dtype=torch.long, device=device)


def expand_kv(k: torch.Tensor, qh_to_kv: Optional[torch.Tensor]) -> torch.Tensor:
    """[B,S,KVH,D] -> [B,S,H,D] per-Q-head KV when a gather map is needed."""
    return k if qh_to_kv is None else k.index_select(2, qh_to_kv)
