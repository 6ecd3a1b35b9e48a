"""Plain PyTorch versions of page gather/scatter (the CPU path and oracle)."""

from __future__ import annotations


def page_gather_ref(pool, page_ids):
    return pool.index_select(0, page_ids.long())


def page_scatter_ref(pool, page_ids, pages):
    """In place, like the kernel; returns ``pool``."""
    return pool.index_copy_(0, page_ids.long(), pages)
