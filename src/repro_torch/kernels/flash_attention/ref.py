"""Plain PyTorch version of flash attention (dense scores + mask).

Same contract as ``kernel.flash_attention``; the CPU path of ``ops`` and the
oracle the CUDA kernel is held against.  It computes what the JAX package's
``flash_attention_ref`` computes (fp32 scores, a ``NEG_INF`` mask on
top-left aligned positions, fp32 softmax), plus ``num_heads``: heads at or
past it are padding and come back as zeros, and real head ``i`` reads KV
head ``i // (num_heads // KVH)``.  A row that sees no key (a window with
Sq > Sk) comes back as zeros, as from the kernel.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -2.0e38


def flash_attention_ref(q, k, v, causal: bool = True, window: Optional[int] = None,
                        num_heads: Optional[int] = None):
    """q: [B,H,Sq,D]; k, v: [B,KVH,Sk,D] -> [B,H,Sq,D] in q's dtype."""
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    nh = h if num_heads is None else num_heads
    qg = q[:, :nh].reshape(b, kvh, nh // kvh, sq, d).float()
    s = torch.einsum("bgrqd,bgkd->bgrqk", qg, k.float()) / math.sqrt(d)
    qp = torch.arange(sq, device=q.device)[:, None]
    kp = torch.arange(sk, device=q.device)[None, :]
    ok = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kp <= qp
    if window is not None:
        ok &= qp - kp < window
    s = s.masked_fill(~ok, NEG_INF)
    p = torch.softmax(s, dim=-1) * ok.any(dim=-1, keepdim=True)
    o = torch.einsum("bgrqk,bgkd->bgrqd", p, v.float()).reshape(b, nh, sq, d)
    out = torch.zeros_like(q)
    out[:, :nh] = o.to(q.dtype)
    return out
