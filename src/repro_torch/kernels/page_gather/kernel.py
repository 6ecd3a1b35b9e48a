"""Whole-page gather/scatter on the card: wrappers of ``csrc/page_gather.cu``.

Replace the Pallas TPU kernels in ``repro/kernels/page_gather/kernel.py``
and, with a layer axis, the reference's ``pool.at[:, ids].set(...)`` over
every layer of a pool, in one launch per pool:

* ``page_gather(pool, ids)``: ``[P, E] -> [n, E]`` (the Pallas contract)
  or ``[L, P, E] -> [L, n, E]``.
* ``page_scatter(pool, ids, pages)``: in place, returns ``pool`` (the JAX
  version donates and aliases it).  For a ``[P, E]`` pool ``pages`` is a
  contiguous ``[n, E]``.  For ``[L, P, E]`` it is ``[L, S, T]`` with each
  layer's S rows of T elements contiguous and any layer stride (the
  prefill cache's K, read where it lies), S*T <= n*E: each layer's S*T
  elements fill its n pages in order and the rest of them is written as
  zeros (the reference pads with zeros before it installs).

A pool's rows are contiguous; its layer stride is free.  Page ids follow
the reference (``jnp.take`` / ``.at[].set``): an id in ``[-P, 0)`` means
page ``P + id``; a gather row whose id lies outside ``[-P, P)`` is filled
with :func:`take_fill` of the pool's dtype, and a scatter drops such an id.
Ids must be unique after wrapping for a scatter (duplicate order is
undefined, as in the reference).  Two variants, chosen before the
launch from addresses and sizes alone (:func:`choose_variant`) and never
retried on the other: ``"bulk"`` (TMA bulk copies through a shared-memory
ring) where every base, layer stride, row and source run is a multiple of
16 bytes, ``"generic"`` (16-byte vectors or bytes) otherwise.  The
wrappers check device, dtype and shapes, launch on PyTorch's current
stream without synchronising, and raise if a launch was refused.  Each
launch adds one to ``launch_counts[<name>]`` and to
``copy_variant_counts[<name>][<variant>]``.  :func:`copy_h2d` copies host
memory by address into a CUDA tensor (no kernel, not counted).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from .. import check_launch, load_library
from .ref import take_fill

VARIANTS = ("bulk", "generic")

copy_variant_counts: Dict[str, Dict[str, int]] = {
    name: {v: 0 for v in VARIANTS} for name in ("page_gather", "page_scatter")}
_fns: Dict[str, object] = {}
_sms: Dict[int, int] = {}


def reset_copy_variant_counts() -> None:
    for counts in copy_variant_counts.values():
        for v in counts:
            counts[v] = 0


def _function():
    fn = _fns.get("copy")
    if fn is None:
        fn = load_library("page_gather").repro_page_copy
        p, i, i64, u64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_ulonglong
        fn.argtypes = [p, p, i64, p, p, i64, i, i, i64, i64, i, u64, u64, i, i, p]
        fn.restype = ctypes.c_int
        _fns["copy"] = fn
    return fn


@functools.lru_cache(maxsize=None)
def _pad_words(dtype: torch.dtype) -> Tuple[int, int]:
    """A gather's fill as two little-endian 64-bit words: 16 bytes of
    :func:`take_fill` repeated (every element size divides 16)."""
    size = torch.empty((), dtype=dtype).element_size()
    raw = bytes(torch.full((16 // size,), take_fill(dtype), dtype=dtype)
                .view(torch.uint8).tolist())
    return int.from_bytes(raw[:8], "little"), int.from_bytes(raw[8:], "little")


def copy_h2d(dst: torch.Tensor, src_address: int, nbytes: int) -> None:
    """Copy ``nbytes`` of host memory at ``src_address`` into the start of
    the contiguous CUDA tensor ``dst`` on PyTorch's current stream, without
    synchronising: the caller keeps the host memory alive and unchanged
    until the stream has passed the copy."""
    if not (dst.is_cuda and dst.is_contiguous()):
        raise ValueError("copy_h2d: dst must be a contiguous CUDA tensor")
    if not 0 <= nbytes <= dst.numel() * dst.element_size():
        raise ValueError(f"copy_h2d: {nbytes} bytes do not fit dst")
    fn = _fns.get("h2d")
    if fn is None:
        fn = load_library("page_gather").repro_copy_h2d
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns["h2d"] = fn
    err = fn(dst.data_ptr(), src_address, nbytes,
             torch.cuda.current_stream(dst.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"copy_h2d: cudaMemcpyAsync failed with cudaError {err}")


def bulk_shape() -> Dict[str, int]:
    """The bulk variant's launch shape, as the built library has it."""
    fn = load_library("page_gather").repro_page_copy_bulk_shape
    fn.argtypes, fn.restype = [ctypes.POINTER(ctypes.c_int)], None
    out = (ctypes.c_int * 5)()
    fn(out)
    return dict(zip(("stages", "stage_bytes", "threads", "ctas_per_sm",
                     "dynamic_smem_bytes"), out))


def _sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _sms:
        _sms[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sms[idx]


def _check_ids(pool: torch.Tensor, page_ids: torch.Tensor, name: str) -> None:
    if not (pool.is_cuda and page_ids.is_cuda and page_ids.device == pool.device):
        raise ValueError(f"{name} kernel: pool and page_ids must be on one CUDA device")
    if page_ids.dim() != 1:
        raise ValueError(f"{name} kernel: page_ids must be [n]")
    if page_ids.dtype != torch.int32:
        raise TypeError(f"{name} kernel: page_ids must be int32, got {page_ids.dtype}")
    if not page_ids.is_contiguous():
        raise ValueError(f"{name} kernel: page_ids must be contiguous")


def _layers(pool: torch.Tensor, name: str) -> Tuple[int, int, int, int]:
    """(L, P, E, layer stride in elements) of a ``[P, E]`` or ``[L, P, E]``
    pool whose rows are contiguous."""
    if pool.dim() == 2 and pool.is_contiguous():
        return 1, pool.shape[0], pool.shape[1], 0
    if pool.dim() == 3 and (pool.shape[0] == 0 or pool[0].is_contiguous()):
        return pool.shape[0], pool.shape[1], pool.shape[2], pool.stride(0)
    raise ValueError(f"{name} kernel: pool must be a contiguous [P, page_elems] or "
                     f"[L, P, page_elems] with contiguous rows, got {tuple(pool.shape)}")


def choose_variant(addresses, layer_strides, row_bytes: int, src_bytes: int) -> str:
    """``"bulk"`` where every address the kernel forms is 16-byte aligned
    and every run it copies a multiple of 16 bytes: the base ``addresses``,
    the ``layer_strides`` (bytes), a page row and each layer's source run
    (``src_bytes``); else ``"generic"``."""
    if all(x % 16 == 0 for x in (*addresses, *layer_strides, row_bytes, src_bytes)):
        return "bulk"
    return "generic"


def _copy(name: str, variant: Optional[str], src: torch.Tensor, src_ids, src_layer: int,
          dst: torch.Tensor, dst_ids, dst_layer: int, layers: int, n: int, row_bytes: int,
          src_bytes: int, num_pages: int, pad: Tuple[int, int] = (0, 0)) -> None:
    """Launch one layered copy; strides and sizes in bytes; ``pad`` the
    16 bytes written where nothing is read."""
    if variant not in (None, *VARIANTS):
        raise ValueError(f"{name} kernel: unknown variant {variant!r}")
    strides = (src_layer, dst_layer) if layers > 1 else ()
    chosen = choose_variant((src.data_ptr(), dst.data_ptr()), strides, row_bytes, src_bytes)
    if variant == "bulk" and chosen != "bulk":
        raise ValueError(f"{name} kernel: the bulk variant needs 16-byte aligned bases, "
                         "layer strides, rows and source runs")
    variant = variant or chosen
    if layers == 0 or n == 0 or row_bytes == 0:
        return
    err = _function()(
        src.data_ptr(), src_ids.data_ptr() if src_ids is not None else None, src_layer,
        dst.data_ptr(), dst_ids.data_ptr() if dst_ids is not None else None, dst_layer,
        layers, n, row_bytes, src_bytes, num_pages, *pad, int(variant == "bulk"),
        _sm_count(dst.device), torch.cuda.current_stream(dst.device).cuda_stream)
    check_launch(name, err)
    copy_variant_counts[name][variant] += 1


def page_gather(pool: torch.Tensor, page_ids: torch.Tensor,
                variant: Optional[str] = None) -> torch.Tensor:
    """pool: [P, E] or [L, P, E]; page_ids: [n] int32 -> [n, E] or [L, n, E].
    ``variant`` None chooses; ``"generic"`` forces the generic kernel,
    ``"bulk"`` raises where it cannot run."""
    _check_ids(pool, page_ids, "page_gather")
    L, P, E, layer = _layers(pool, "page_gather")
    n = page_ids.shape[0]
    es = pool.element_size()
    out = torch.empty((L, n, E), dtype=pool.dtype, device=pool.device)
    _copy("page_gather", variant, pool, page_ids, layer * es, out, None, n * E * es,
          L, n, E * es, n * E * es, P, _pad_words(pool.dtype))
    return out if pool.dim() == 3 else out[0]


def page_scatter(pool: torch.Tensor, page_ids: torch.Tensor, pages: torch.Tensor,
                 variant: Optional[str] = None) -> torch.Tensor:
    """Write ``pages`` into ``pool`` rows ``page_ids`` of every layer, in
    place (zeros past the source in a layered pool, see the module note);
    returns ``pool``.  ``variant`` as for :func:`page_gather`."""
    _check_ids(pool, page_ids, "page_scatter")
    L, P, E, layer = _layers(pool, "page_scatter")
    n = page_ids.shape[0]
    if pages.device != pool.device or pages.dtype != pool.dtype:
        raise TypeError("page_scatter kernel: pages must match the pool's device and dtype")
    if pool.dim() == 2:
        if pages.shape != (n, E) or not pages.is_contiguous():
            raise ValueError(f"page_scatter kernel: pages must be contiguous "
                             f"[{n}, {E}], got {tuple(pages.shape)}")
        src_elems, src_layer = n * E, 0
    else:
        if (pages.dim() != 3 or pages.shape[0] != L
                or not (L == 0 or pages[0].is_contiguous())):
            raise ValueError(f"page_scatter kernel: pages must be [{L}, S, T] with each "
                             f"layer contiguous, got {tuple(pages.shape)}")
        src_elems, src_layer = pages.shape[1] * pages.shape[2], pages.stride(0)
        if src_elems > n * E:
            raise ValueError(f"page_scatter kernel: {src_elems} source elements a layer "
                             f"do not fit {n} pages of {E}")
    es = pool.element_size()
    _copy("page_scatter", variant, pages, None, src_layer * es, pool, page_ids, layer * es,
          L, n, E * es, src_elems * es, P)
    return pool
