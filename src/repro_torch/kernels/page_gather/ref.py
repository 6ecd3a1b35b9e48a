"""Plain PyTorch versions of page gather/scatter (the CPU path and oracle),
with the kernels' shapes: a ``[P, E]`` pool (the Pallas contract) or an
``[L, P, E]`` one, every layer at once (the reference's ``pool.at[:, ids]``)."""

from __future__ import annotations


def page_gather_ref(pool, page_ids):
    """[P, E] -> [n, E]; [L, P, E] -> [L, n, E]."""
    return pool.index_select(pool.dim() - 2, page_ids.long())


def page_scatter_ref(pool, page_ids, pages):
    """In place, like the kernel; returns ``pool``.  A layered ``pages``
    [L, S, T] fills each layer's n pages in order, padded with zeros."""
    if pool.dim() == 2:
        return pool.index_copy_(0, page_ids.long(), pages)
    L, n, E = pool.shape[0], page_ids.shape[0], pool.shape[2]
    padded = pages.new_zeros((L, n * E))
    padded[:, :pages.shape[1] * pages.shape[2]] = pages.reshape(L, -1)
    return pool.index_copy_(1, page_ids.long(), padded.view(L, n, E))
