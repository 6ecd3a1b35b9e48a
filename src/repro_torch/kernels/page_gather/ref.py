"""Plain PyTorch versions of page gather/scatter (the CPU path and oracle),
with the kernels' shapes: a ``[P, E]`` pool (the Pallas contract) or an
``[L, P, E]`` one, every layer at once (the reference's ``pool.at[:, ids]``).

Page ids as in the reference's ``jnp.take`` / ``.at[].set``: an id in
``[-P, 0)`` means page ``P + id``; a gathered row whose id lies outside
``[-P, P)`` holds :func:`take_fill` of the dtype, and a scatter drops such
an id.
"""

from __future__ import annotations

import torch



def take_fill(dtype: torch.dtype):
    """What ``jnp.take`` writes for an out-of-range id: NaN for floating
    (and complex) types, ``True`` for bool, the minimum of a signed integer
    type and the maximum of an unsigned one."""
    if dtype.is_floating_point or dtype.is_complex:
        return float("nan")
    if dtype == torch.bool:
        return True
    info = torch.iinfo(dtype)
    return info.max if info.min == 0 else info.min


def _wrap(pool, page_ids):
    """(ids taken modulo P, mask of the ids in [-P, P) that name a page)."""
    P = pool.shape[-2]
    ids = page_ids.long()
    return ids.remainder(max(P, 1)), (ids >= -P) & (ids < P)


def page_gather_ref(pool, page_ids):
    """[P, E] -> [n, E]; [L, P, E] -> [L, n, E]."""
    ids, ok = _wrap(pool, page_ids)
    out = pool.index_select(pool.dim() - 2, ids)
    return out.masked_fill_(~ok[:, None], take_fill(pool.dtype))


def page_scatter_ref(pool, page_ids, pages):
    """In place, like the kernel; returns ``pool``.  A layered ``pages``
    [L, S, T] fills each layer's n pages in order, padded with zeros."""
    if page_ids.numel() == 0:
        return pool
    ids, ok = _wrap(pool, page_ids)
    if pool.dim() == 3:
        L, n, E = pool.shape[0], page_ids.shape[0], pool.shape[2]
        padded = pages.new_zeros((L, n * E))
        padded[:, :pages.shape[1] * pages.shape[2]] = pages.reshape(L, -1)
        pages = padded.view(L, n, E)
    keep = ok.nonzero().squeeze(1)
    return pool.index_copy_(pool.dim() - 2, ids[keep], pages.index_select(-2, keep))
