"""Paged decode attention on the card: wrapper of ``csrc/paged_attention.cu``.

Replaces the Pallas TPU kernel in ``repro/kernels/paged_attention/kernel.py``
with a hand-written CUDA kernel that splits each sequence's pages over
blocks: a block stages its split's K/V rows with ``cp.async``, scores them
on the tensor cores (bf16) or with FMA (fp32) under an fp32 online
softmax, and a second kernel merges the splits in a fixed order.  With a
sliding ``window`` the splits cover only the pages that can hold one of
the last ``window`` positions, from the page of ``len - window`` on.  The
wrapper checks device, dtype, shape and contiguity, picks the split from
shapes alone (:func:`split_plan`; it never reads ``lengths`` or the table
on the host), allocates the output and the merge scratch, launches on
PyTorch's current stream without synchronising, and raises if the launch
was refused.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Optional, Tuple

import torch

from .. import check_launch, load_library

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BLOCKS_PER_SM = 4           # over the table: live lengths are shorter
MIN_SPLIT_TOKENS = 128      # a split's least work: two bf16 stages
MAX_SPLIT_PAGES = 1024      # page ids a block holds in shared memory
MAX_SPLITS = 1024
_fn = None
_sms: Dict[int, int] = {}


def _function():
    global _fn
    if _fn is None:
        fn = load_library("paged_attention").repro_paged_attention
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 7 + [i] * 12 + [ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def visible_pages(pages_per_seq: int, page_size: int, window: Optional[int]) -> int:
    """Most table entries a sequence's visible keys can span: the whole
    table, or with a window the pages holding positions ``[len - window,
    len)``, at most ``ceil((window - 1) / page_size) + 1`` whatever ``len``."""
    if window is None:
        return pages_per_seq
    return min(pages_per_seq, -(-(window - 1) // page_size) + 1)


@functools.lru_cache(maxsize=64)
def split_plan(pages_per_seq: int, page_size: int, b: int, kvh: int,
               num_sms: int, window: Optional[int] = None) -> Tuple[int, int]:
    """(pages_per_split, splits) for a [b, pages_per_seq] table over kvh KV
    heads: about ``BLOCKS_PER_SM`` blocks per SM over the visible span
    (:func:`visible_pages`; a block past its sequence's length exits at
    once), at least ``MIN_SPLIT_TOKENS`` tokens a split, at most
    ``MAX_SPLIT_PAGES`` pages.  Shapes only: the same plan serves every
    step of a decode whatever the lengths are, so it is cached.
    ``sweep.py`` times other split sizes against it."""
    pages_per_seq = visible_pages(pages_per_seq, page_size, window)
    want = max(1, -(-BLOCKS_PER_SM * num_sms // (b * kvh)))
    per = max(-(-MIN_SPLIT_TOKENS // page_size), -(-pages_per_seq // want))
    per = max(min(per, pages_per_seq, MAX_SPLIT_PAGES), -(-pages_per_seq // MAX_SPLITS))
    if per > MAX_SPLIT_PAGES:
        raise ValueError(f"paged_attention kernel: a table of {pages_per_seq} pages needs "
                         f"more than {MAX_SPLITS} splits of {MAX_SPLIT_PAGES} pages")
    return per, -(-pages_per_seq // per)


def _num_sms(device: torch.device) -> int:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    n = _sms.get(idx)
    if n is None:
        n = _sms[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return n


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                    page_table: torch.Tensor, lengths: torch.Tensor,
                    num_heads: Optional[int] = None,
                    window: Optional[int] = None) -> torch.Tensor:
    """Decode attention through a paged KV pool, on the card.

    q:           [B, H, D]                one query token per sequence
    k_pool/v_pool: [P, page_size, KVH, D] shared physical page pool
    page_table:  [B, pages_per_seq] int32 logical -> physical page
    lengths:     [B] int32                valid tokens per sequence
    num_heads:   real query heads (default H); heads past it are padding
                 and come back as zeros
    window:      sliding window: only positions ``[len - window, len)``
                 are visible (None: all of ``[0, len)``)
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
    if window is not None and window < 1:
        raise ValueError(f"paged_attention kernel: window must be >= 1, got {window}")
    out = torch.empty_like(q)
    pps = page_table.shape[1]
    if b == 0 or pps == 0:
        return out.zero_()
    per, splits = split_plan(pps, page_size, b, kvh, _num_sms(q.device), window)
    # partial (acc, m, l) of every split, merged in order by a second kernel;
    # freed on return, the caching allocator hands it out again only to work
    # ordered after both launches on this stream
    scratch = None
    if splits > 1:
        scratch = torch.empty(b * kvh * splits * (nh // kvh) * (d + 2),
                              dtype=torch.float32, device=q.device)
    isz = q.element_size()
    vec = ((d * isz) % 16 == 0 and k_pool.data_ptr() % 16 == 0
           and v_pool.data_ptr() % 16 == 0)
    err = _function()(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), page_table.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), None if scratch is None else scratch.data_ptr(),
        _DTYPES[q.dtype], b, h, nh, kvh, d, p_total, page_size, pps, per, splits,
        window or 0, 1.0 / math.sqrt(d), int(vec),
        torch.cuda.current_stream(q.device).cuda_stream)
    check_launch("paged_attention", err)
    return out
