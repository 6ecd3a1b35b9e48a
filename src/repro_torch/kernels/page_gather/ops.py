"""Public entries for whole-page install/evict: the ``impl`` switch.

``"auto"`` launches the CUDA kernel for a CUDA pool, takes the kernel's
meta implementation for a meta pool (``kernels/meta.py``: the dry run) and
runs the plain PyTorch version for a CPU pool; ``"cuda"``, ``"meta"`` and
``"ref"`` force one.  There is no fallback.  Pools are ``[P, E]`` or
``[L, P, E]`` (every layer in one call); ``page_scatter`` updates ``pool``
in place and returns it.
"""

from __future__ import annotations

from ..meta import page_gather_meta, page_scatter_meta
from .kernel import page_gather as _gather, page_scatter as _scatter
from .ref import page_gather_ref, page_scatter_ref


def _resolve(impl, pool):
    if impl == "auto":
        return "cuda" if pool.is_cuda else "meta" if pool.is_meta else "ref"
    if impl not in ("cuda", "meta", "ref"):
        raise ValueError(f"unknown impl {impl!r}; choose auto, cuda, meta or ref")
    return impl


def page_gather(pool, page_ids, impl="auto"):
    impl = _resolve(impl, pool)
    if impl == "cuda":
        return _gather(pool, page_ids)
    if impl == "meta":
        return page_gather_meta(pool, page_ids)
    return page_gather_ref(pool, page_ids)


def page_scatter(pool, page_ids, pages, impl="auto"):
    impl = _resolve(impl, pool)
    if impl == "cuda":
        return _scatter(pool, page_ids, pages)
    if impl == "meta":
        return page_scatter_meta(pool, page_ids, pages)
    return page_scatter_ref(pool, page_ids, pages)


def pool_rows(pool):
    """A ``[L, P, ...]`` page pool as the ``[L, P, E]`` the copies take (a view)."""
    return pool.view(pool.shape[0], pool.shape[1], -1)


def token_rows(kv):
    """``[L, S, ...]`` KV as a layered scatter's ``[L, S, T]`` source: a view
    where each layer's tokens already lie contiguous (the prefill cache's K
    at any layer stride), else a contiguous copy."""
    rows = kv.reshape(kv.shape[0], kv.shape[1], -1)
    return rows if kv.shape[0] == 0 or rows[0].is_contiguous() else rows.contiguous()
