"""Whole-page gather/scatter on the card: wrappers of ``csrc/page_gather.cu``.

Replace the Pallas TPU kernels in ``repro/kernels/page_gather/kernel.py``:
one block per page, 16-byte vector copies.  ``page_scatter`` writes the
pool in place (the JAX version donates and aliases it) and returns it.
Page ids must be unique for a scatter; duplicate order is undefined, as in
the reference.  The wrappers check device, dtype, shape and contiguity,
launch on PyTorch's current stream without synchronising, and raise if a
launch was refused.
"""

from __future__ import annotations

import ctypes

import torch

from .. import check_launch, load_library

_fns = {}


def _function(symbol: str):
    fn = _fns.get(symbol)
    if fn is None:
        fn = getattr(load_library("page_gather"), symbol)
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, p]
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return fn


def _check(pool: torch.Tensor, page_ids: torch.Tensor, name: str) -> None:
    if not (pool.is_cuda and page_ids.is_cuda and page_ids.device == pool.device):
        raise ValueError(f"{name} kernel: pool and page_ids must be on one CUDA device")
    if pool.dim() != 2 or page_ids.dim() != 1:
        raise ValueError(f"{name} kernel: pool must be [P, page_elems] and page_ids [n]")
    if page_ids.dtype != torch.int32:
        raise TypeError(f"{name} kernel: page_ids must be int32, got {page_ids.dtype}")
    if not (pool.is_contiguous() and page_ids.is_contiguous()):
        raise ValueError(f"{name} kernel: inputs must be contiguous")


def page_gather(pool: torch.Tensor, page_ids: torch.Tensor) -> torch.Tensor:
    """pool: [P, page_elems]; page_ids: [n] int32 -> [n, page_elems]."""
    _check(pool, page_ids, "page_gather")
    n = page_ids.shape[0]
    out = torch.empty((n, pool.shape[1]), dtype=pool.dtype, device=pool.device)
    if n == 0:
        return out
    err = _function("repro_page_gather")(
        pool.data_ptr(), page_ids.data_ptr(), out.data_ptr(), n,
        pool.shape[1] * pool.element_size(), pool.shape[0],
        torch.cuda.current_stream(pool.device).cuda_stream)
    check_launch("page_gather", err)
    return out


def page_scatter(pool: torch.Tensor, page_ids: torch.Tensor,
                 pages: torch.Tensor) -> torch.Tensor:
    """Write ``pages`` [n, page_elems] into ``pool`` rows ``page_ids``, in
    place; returns ``pool``."""
    _check(pool, page_ids, "page_scatter")
    n = page_ids.shape[0]
    if pages.device != pool.device or pages.dtype != pool.dtype:
        raise TypeError("page_scatter kernel: pages must match the pool's device and dtype")
    if pages.shape != (n, pool.shape[1]) or not pages.is_contiguous():
        raise ValueError(f"page_scatter kernel: pages must be contiguous "
                         f"[{n}, {pool.shape[1]}], got {tuple(pages.shape)}")
    if n == 0:
        return pool
    err = _function("repro_page_scatter")(
        pool.data_ptr(), page_ids.data_ptr(), pages.data_ptr(), n,
        pool.shape[1] * pool.element_size(), pool.shape[0],
        torch.cuda.current_stream(pool.device).cuda_stream)
    check_launch("page_scatter", err)
    return pool
