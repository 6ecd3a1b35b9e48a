"""Public entries for whole-page install/evict: the ``impl`` switch.

``"auto"`` launches the CUDA kernel for a CUDA pool and runs the plain
PyTorch version for a CPU pool; ``"cuda"`` and ``"ref"`` force one.  There
is no fallback.  ``page_scatter`` updates ``pool`` in place and returns it.
"""

from __future__ import annotations

from .kernel import page_gather as _gather, page_scatter as _scatter
from .ref import page_gather_ref, page_scatter_ref


def _resolve(impl, pool):
    if impl == "auto":
        return "cuda" if pool.is_cuda else "ref"
    if impl not in ("cuda", "ref"):
        raise ValueError(f"unknown impl {impl!r}; choose auto, cuda or ref")
    return impl


def page_gather(pool, page_ids, impl="auto"):
    if _resolve(impl, pool) == "cuda":
        return _gather(pool, page_ids)
    return page_gather_ref(pool, page_ids)


def page_scatter(pool, page_ids, pages, impl="auto"):
    if _resolve(impl, pool) == "cuda":
        return _scatter(pool, page_ids, pages)
    return page_scatter_ref(pool, page_ids, pages)
