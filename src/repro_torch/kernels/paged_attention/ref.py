"""Plain PyTorch version of paged decode attention (gather + softmax).

Same contract as ``kernel.paged_attention``; the CPU path of ``ops`` and the
oracle the CUDA kernel is held against.  One deliberate difference from the
JAX package's ``paged_attention_ref``: a row of length 0 gives zeros, as
the kernels (Pallas and CUDA) do, not the softmax of an all-masked row.
``window`` (the JAX package's paged decode applies it through its gather
path, ``decode_attention``) keeps the key at position ``p`` iff
``0 <= len - 1 - p < window``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -2.0e38


def paged_attention_ref(q, k_pool, v_pool, page_table, lengths,
                        num_heads: Optional[int] = None, window: Optional[int] = None):
    b, h, d = q.shape
    _, page_size, kvh, _ = k_pool.shape
    pages = page_table.shape[1]
    nh = h if num_heads is None else num_heads
    rep = nh // kvh
    tbl = page_table.long()
    # gather each sequence's pages into contiguous [b, S, kvh, d]
    k_seq = k_pool[tbl].reshape(b, pages * page_size, kvh, d).float()
    v_seq = v_pool[tbl].reshape(b, pages * page_size, kvh, d).float()

    qg = q[:, :nh].reshape(b, kvh, rep, d).float()
    s = torch.einsum("bgrd,bkgd->bgrk", qg, k_seq) / math.sqrt(d)
    pos = torch.arange(pages * page_size, device=q.device)
    lens = lengths.long()[:, None]
    valid = pos[None, :] < lens                                    # [b, S]
    if window is not None:
        valid &= pos[None, :] >= lens - window
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1) * valid.any(dim=1).float()[:, None, None, None]
    o = torch.einsum("bgrk,bkgd->bgrd", p, v_seq).reshape(b, nh, d)
    out = torch.zeros_like(q)
    out[:, :nh] = o.to(q.dtype)
    return out
