"""Prefill attention on the card: wrapper of ``csrc/flash_attention.cu``.

Replaces the Pallas TPU kernel in ``repro/kernels/flash_attention/kernel.py``
with hand-written CUDA kernels, in two variants that the wrapper chooses
between before it launches (:func:`choose_variant`):

* ``"hopper"``: bf16 with head_dim 64 or 128, q/k/v views that a TMA
  tensor map can describe (16-byte aligned, byte strides multiples of 16).
  One CTA per (128-row q tile, real head, sequence): a producer warpgroup
  keeps K/V tiles in flight by TMA, two consumer warpgroups run QK^T and PV
  on ``wgmma``.  The wrapper computes each tensor map's geometry
  (:func:`tensor_map_geometry`); the C side encodes and checks it.
* ``"generic"``: everything else — fp32 (plain FMA), other head dims,
  views TMA cannot describe.  One block per (64-row q tile, head, sequence),
  bf16 on ``mma.sync``.

Both keep the online softmax in fp32, walk only the KV tiles the
causal/window mask can see, read q/k/v through their strides (the head_dim
stride must be 1; a ``transpose(1, 2)`` view of a ``[B,S,H,D]`` tensor is
read in place), and write padded heads as zeros.  ``head_offset`` names the
global head of q's first head (a tensor-parallel rank's own heads); each
(batch, head) tile then runs the work it runs in the launch over every
head, so a shard's heads are bitwise those of that launch.  The wrapper
checks device, dtype and shapes, allocates the output, launches on
PyTorch's current stream without synchronising, and raises if the launch
(or a tensor-map encode) failed; it never retries on the other variant.  Each launch adds
one to ``launch_counts["flash_attention"]`` and one to
``variant_counts[<variant>]``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from .. import check_launch, load_library

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128
HOPPER_HEAD_DIMS = (64, 128)
BLOCK_ROWS = 128          # q rows of a hopper CTA, keys of its KV tile
BOX_COLS = 64             # bf16 columns of one 128-byte swizzled TMA box
VARIANTS = ("hopper", "generic")

variant_counts: Dict[str, int] = {v: 0 for v in VARIANTS}
_fns: Dict[str, object] = {}


def reset_variant_counts() -> None:
    for v in variant_counts:
        variant_counts[v] = 0


def _function(variant: str):
    fn = _fns.get(variant)
    if fn is None:
        lib = load_library("flash_attention")
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        if variant == "hopper":
            fn = lib.repro_flash_attention_sm90
            fn.argtypes = ([p] * 5 + [i64] * 3 + [i] * 10 + [ctypes.c_float, p])
        else:
            fn = lib.repro_flash_attention
            fn.argtypes = ([p, p, p, p, i] + [i64] * 12 + [i] * 10
                           + [ctypes.c_float, i, p])
        fn.restype = ctypes.c_int
        _fns[variant] = fn
    return fn


class TensorMapGeometry(NamedTuple):
    """A ``[B, heads, S, D]`` view as a 4-D TMA tensor map, innermost first:
    ``dims`` (D, S, heads, B), byte ``strides`` of S, heads and B, and the
    ``box`` one load copies (64 columns x 128 rows: a D-128 row is two
    boxes, since a 128-byte swizzled box is at most 128 bytes wide)."""

    dims: Tuple[int, int, int, int]
    strides: Tuple[int, int, int]
    box: Tuple[int, int, int, int]


def tensor_map_geometry(t: torch.Tensor) -> TensorMapGeometry:
    """The tensor map of ``t`` ([B, heads, S, D], head_dim stride 1).  A
    dimension of size 1 is never stepped over; it takes the stride a packed
    tensor would have, whatever PyTorch reports for it."""
    b, heads, s, d = t.shape
    es = t.element_size()
    packed = (d * es, s * d * es, heads * s * d * es)
    strides = tuple(st * es if n > 1 else pk for st, n, pk in
                    zip((t.stride(2), t.stride(1), t.stride(0)), (s, heads, b), packed))
    return TensorMapGeometry((d, s, heads, b), strides, (BOX_COLS, BLOCK_ROWS, 1, 1))


def choose_variant(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """``"hopper"`` where the TMA/wgmma kernel takes the call, else
    ``"generic"``: from dtype, head_dim, Sk and alignment alone."""
    if (q.dtype != torch.bfloat16 or q.shape[3] not in HOPPER_HEAD_DIMS
            or k.shape[2] == 0):
        return "generic"
    for t in (q, k, v):
        if t.data_ptr() % 16 or any(s % 16 or s >= 1 << 40
                                    for s in tensor_map_geometry(t).strides):
            return "generic"
    return "hopper"


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    num_heads: Optional[int] = None,
                    variant: Optional[str] = None, head_offset: int = 0) -> torch.Tensor:
    """Self-attention over whole sequences, on the card.

    q:         [B, H, Sq, D]     any strides, head_dim stride 1
    k, v:      [B, KVH, Sk, D]   the same
    causal:    mask k_pos > q_pos (positions from 0 at the top left)
    window:    also mask q_pos - k_pos >= window (None: no window)
    num_heads: real query heads of the model (default head_offset + H);
               global head i < num_heads reads KV head i // (num_heads //
               KVH), heads past it come back as zeros
    head_offset: local head j of q is global head head_offset + j (a
               tensor-parallel rank's heads; a shard may hold padded heads
               only, and then reads nothing)
    variant:   None chooses (:func:`choose_variant`); ``"generic"`` forces
               the generic kernel, ``"hopper"`` raises where it cannot run
    returns    [B, H, Sq, D] in q's dtype, laid out as [B, Sq, H, D] in
               memory (so ``out.transpose(1, 2)`` is contiguous)
    """
    b, h, sq, d = q.shape
    nh = head_offset + h if num_heads is None else num_heads
    if k.dim() != 4 or v.shape != k.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention kernel: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} do not match")
    kvh, sk = k.shape[1], k.shape[2]
    if not all(t.is_cuda and t.device == q.device for t in (q, k, v)):
        raise ValueError("flash_attention kernel: every input must be on one CUDA device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel: q/k/v must share one of "
                        f"{list(_DTYPES)}, got {q.dtype}/{k.dtype}/{v.dtype}")
    if head_offset < 0 or nh <= 0 or nh % kvh or not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention kernel: needs num_heads ({nh}) > 0 a multiple "
                         f"of KVH ({kvh}), head_offset ({head_offset}) >= 0 and "
                         f"0 < D <= {MAX_HEAD_DIM} (D={d})")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention kernel: window must be >= 1, got {window}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention kernel: the head_dim stride must be 1")
    if variant not in (None, *VARIANTS):
        raise ValueError(f"flash_attention kernel: unknown variant {variant!r}")
    chosen = choose_variant(q, k, v)
    if variant == "hopper" and chosen != "hopper":
        raise ValueError("flash_attention kernel: the hopper variant needs bf16, D in "
                         f"{HOPPER_HEAD_DIMS}, Sk > 0 and TMA-aligned views")
    variant = variant or chosen
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if variant == "hopper":
        geometry = [x for t in (q, k, v) for g in tensor_map_geometry(t) for x in g]
        err = _function("hopper")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            (ctypes.c_int64 * len(geometry))(*geometry), *out.stride()[:3],
            b, h, nh, head_offset, kvh, d, sq, sk, int(causal), window or 0,
            1.0 / math.sqrt(d), stream)
        if err < 0:
            raise RuntimeError(f"flash_attention kernel: cuTensorMapEncodeTiled failed "
                               f"with CUresult {-err}")
    else:
        err = _function("generic")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _DTYPES[q.dtype],
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            b, h, nh, head_offset, kvh, d, sq, sk, int(causal), window or 0,
            1.0 / math.sqrt(d), int(_vectorizable((q, k, v), d)), stream)
    check_launch("flash_attention", err)
    variant_counts[variant] += 1
    return out


def _vectorizable(tensors, d: int) -> bool:
    """16-byte loads are valid: every row start is 16-byte aligned."""
    vec = 16 // tensors[0].element_size()
    return d % vec == 0 and all(
        t.data_ptr() % 16 == 0 and all(s % vec == 0 for s in t.stride()[:3])
        for t in tensors)
