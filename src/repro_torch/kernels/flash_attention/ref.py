"""Plain PyTorch version of flash attention (dense scores + mask).

Same contract as ``kernel.flash_attention``; the CPU path of ``ops`` and the
oracle the CUDA kernel is held against.  It computes what the JAX package's
``flash_attention_ref`` computes (fp32 scores, a ``NEG_INF`` mask on
top-left aligned positions, fp32 softmax), plus ``num_heads``: heads at or
past it are padding and come back as zeros, and real head ``i`` reads KV
head ``i // (num_heads // KVH)``; and ``head_offset``: local head ``j`` of
``q`` is global head ``head_offset + j`` (a tensor-parallel rank's heads).
The heads of a shard go through the same grouped products as in the call
over every head, on the KV groups they touch, so they come back bitwise
equal to those heads of that call.  A row that sees no key (a window with
Sq > Sk) comes back as zeros, as from the kernel.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -2.0e38


def flash_attention_ref(q, k, v, causal: bool = True, window: Optional[int] = None,
                        num_heads: Optional[int] = None, head_offset: int = 0):
    """q: [B,H,Sq,D] (global heads ``head_offset ..``); k, v: [B,KVH,Sk,D]
    -> [B,H,Sq,D] in q's dtype."""
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    nh = head_offset + h if num_heads is None else num_heads
    rep = nh // kvh
    lo, hi = head_offset, min(nh, head_offset + h)     # this call's real heads
    out = torch.zeros_like(q)
    if hi <= lo:
        return out
    g0, g1 = lo // rep, (hi - 1) // rep + 1            # the KV groups they read
    if (g0, g1) == (0, kvh) and (lo, hi) == (0, nh):
        qr = q[:, :nh]
    else:
        qr = q.new_zeros((b, (g1 - g0) * rep, sq, d))
        qr[:, lo - g0 * rep:hi - g0 * rep] = q[:, :hi - lo]
    qg = qr.reshape(b, g1 - g0, rep, sq, d).float()
    s = torch.einsum("bgrqd,bgkd->bgrqk", qg, k[:, g0:g1].float()) / math.sqrt(d)
    qp = torch.arange(sq, device=q.device)[:, None]
    kp = torch.arange(sk, device=q.device)[None, :]
    ok = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kp <= qp
    if window is not None:
        ok &= qp - kp < window
    s = s.masked_fill(~ok, NEG_INF)
    p = torch.softmax(s, dim=-1) * ok.any(dim=-1, keepdim=True)
    o = torch.einsum("bgrqk,bgkd->bgrqd", p, v[:, g0:g1].float())
    o = o.reshape(b, (g1 - g0) * rep, sq, d)[:, lo - g0 * rep:hi - g0 * rep]
    out[:, :hi - lo] = o.to(q.dtype)
    return out
