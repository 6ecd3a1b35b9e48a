"""Paged decode attention on the card: wrapper of ``csrc/paged_attention.cu``.

Replaces the Pallas TPU kernel in ``repro/kernels/paged_attention/kernel.py``
with a hand-written CUDA kernel: one block per (sequence, KV head) reads
the sequence's pages through the page table, up to its length only, and
keeps the online softmax in fp32.  The wrapper checks device, dtype, shape
and contiguity, allocates the output, launches on PyTorch's current stream
without synchronising, and raises if the launch was refused.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from .. import check_launch, load_library

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def _function():
    global _fn
    if _fn is None:
        fn = load_library("paged_attention").repro_paged_attention
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i, i,
                       ctypes.c_float, p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                    page_table: torch.Tensor, lengths: torch.Tensor,
                    num_heads: Optional[int] = None) -> torch.Tensor:
    """Decode attention through a paged KV pool, on the card.

    q:           [B, H, D]                one query token per sequence
    k_pool/v_pool: [P, page_size, KVH, D] shared physical page pool
    page_table:  [B, pages_per_seq] int32 logical -> physical page
    lengths:     [B] int32                valid tokens per sequence
    num_heads:   real query heads (default H); heads past it are padding
                 and come back as zeros
    returns      [B, H, D] in q's dtype
    """
    b, h, d = q.shape
    p_total, page_size, kvh, d2 = k_pool.shape
    nh = h if num_heads is None else num_heads
    tensors = (q, k_pool, v_pool, page_table, lengths)
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("paged_attention kernel: every input must be on one CUDA device")
    if q.dtype not in _DTYPES or k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError(f"paged_attention kernel: q/k_pool/v_pool must share one of "
                        f"{list(_DTYPES)}, got {q.dtype}/{k_pool.dtype}/{v_pool.dtype}")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("paged_attention kernel: page_table and lengths must be int32")
    if (v_pool.shape != k_pool.shape or d2 != d or page_table.shape[0] != b
            or page_table.dim() != 2 or lengths.shape != (b,)):
        raise ValueError(f"paged_attention kernel: shapes q {tuple(q.shape)}, pool "
                         f"{tuple(k_pool.shape)}, table {tuple(page_table.shape)}, "
                         f"lengths {tuple(lengths.shape)} do not match")
    if not 0 < nh <= h or nh % kvh or nh // kvh > 8 or d > 256:
        raise ValueError(f"paged_attention kernel: needs num_heads ({nh}) a multiple "
                         f"of KVH ({kvh}), at most 8 per KV head, <= H ({h}); D <= 256")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention kernel: inputs must be contiguous")
    out = torch.empty_like(q)
    if b == 0:
        return out
    err = _function()(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), page_table.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), _DTYPES[q.dtype], b, h, nh, kvh, d,
        p_total, page_size, page_table.shape[1], 1.0 / math.sqrt(d),
        torch.cuda.current_stream(q.device).cuda_stream)
    check_launch("paged_attention", err)
    return out
