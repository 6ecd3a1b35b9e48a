"""Prefill attention on the card: wrapper of ``csrc/flash_attention.cu``.

Replaces the Pallas TPU kernel in ``repro/kernels/flash_attention/kernel.py``
with a hand-written CUDA kernel: one block per (64-row q tile, head,
sequence) walks only the KV tiles its causal/window mask can see, keeps the
online softmax in fp32, and runs bf16 products on the tensor cores (fp32
inputs as plain FMA).  The wrapper checks device, dtype and shapes, reads
q/k/v through their strides (the head_dim stride must be 1; any other
layout, such as a ``transpose(1, 2)`` view of a ``[B,S,H,D]`` tensor, is
read in place), allocates the output, launches on PyTorch's current stream
without synchronising, and raises if the launch was refused.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from .. import check_launch, load_library

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128
_fn = None


def _function():
    global _fn
    if _fn is None:
        fn = load_library("flash_attention").repro_flash_attention
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn.argtypes = ([p, p, p, p, i] + [i64] * 12 + [i] * 9
                       + [ctypes.c_float, i, p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _vectorizable(tensors, d: int) -> bool:
    """16-byte loads are valid: every row start is 16-byte aligned."""
    vec = 16 // tensors[0].element_size()
    return d % vec == 0 and all(
        t.data_ptr() % 16 == 0 and all(s % vec == 0 for s in t.stride()[:3])
        for t in tensors)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    num_heads: Optional[int] = None) -> torch.Tensor:
    """Self-attention over whole sequences, on the card.

    q:         [B, H, Sq, D]     any strides, head_dim stride 1
    k, v:      [B, KVH, Sk, D]   the same
    causal:    mask k_pos > q_pos (positions from 0 at the top left)
    window:    also mask q_pos - k_pos >= window (None: no window)
    num_heads: real query heads (default H); head i < num_heads reads KV
               head i // (num_heads // KVH), heads past it come back as zeros
    returns    [B, H, Sq, D] in q's dtype, laid out as [B, Sq, H, D] in
               memory (so ``out.transpose(1, 2)`` is contiguous)
    """
    b, h, sq, d = q.shape
    nh = h if num_heads is None else num_heads
    if k.dim() != 4 or v.shape != k.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention kernel: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} do not match")
    kvh, sk = k.shape[1], k.shape[2]
    if not all(t.is_cuda and t.device == q.device for t in (q, k, v)):
        raise ValueError("flash_attention kernel: every input must be on one CUDA device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel: q/k/v must share one of "
                        f"{list(_DTYPES)}, got {q.dtype}/{k.dtype}/{v.dtype}")
    if not 0 < nh <= h or nh % kvh or not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention kernel: needs num_heads ({nh}) a multiple of "
                         f"KVH ({kvh}) and <= H ({h}); 0 < D <= {MAX_HEAD_DIM} (D={d})")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention kernel: window must be >= 1, got {window}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention kernel: the head_dim stride must be 1")
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    if out.numel() == 0:
        return out
    err = _function()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _DTYPES[q.dtype],
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        b, h, nh, kvh, d, sq, sk, int(causal), window or 0, 1.0 / math.sqrt(d),
        int(_vectorizable((q, k, v), d)), torch.cuda.current_stream(q.device).cuda_stream)
    check_launch("flash_attention", err)
    return out
