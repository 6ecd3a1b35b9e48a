"""The kernels' meta implementations: what each op's ``"auto"`` takes on
``meta`` tensors (the dry run, ``launch/dryrun.py``).

A meta tensor has no data, so nothing is launched and no plain version
runs: each function returns outputs of its kernel's shapes, dtypes and
layout, and adds the call, its flops and its bytes (each input read once,
each output written once) under the kernel's own formula to
``meta_costs[<name>]``:

* ``flash_attention``: ``4 * B * Hq * D * sum_q visible(q)`` flops, ``Hq``
  the call's real heads and ``visible(q)`` the keys the causal / window
  mask leaves row ``q`` (positions from 0 at the top left), the masked part
  never computed; bytes of q's real heads, the K / V groups they read and
  the whole output.
* ``paged_attention``: ``4 * B * Hq * L * D`` flops, ``L`` the keys a
  sequence can see: the table's capacity (pages x page size), or the
  window where that is shorter (a meta ``lengths`` has no values); bytes
  of q's real heads, ``L`` K and V rows a sequence, the table, the lengths
  and the output.
* ``page_gather`` / ``page_scatter``: 0 flops, ``2 * L * n * E * elt``
  bytes (each of ``n`` pages of ``E`` elements read and written once a
  layer).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import meta_costs


def _count(name: str, flops: int, nbytes: int) -> None:
    c = meta_costs[name]
    c["calls"] += 1
    c["flops"] += flops
    c["bytes"] += nbytes


def visible_keys(sq: int, sk: int, causal: bool, window: Optional[int]) -> int:
    """``sum_q visible(q)`` over ``sq`` query rows and ``sk`` keys, top-left
    aligned: key ``k`` is visible to row ``q`` iff ``k <= q`` (causal) and
    ``q - k < window``.  The count is linear between the kinks of its
    clamps, so each piece sums as an arithmetic series."""
    w = window or 0

    def f(q):
        hi = min(q + 1, sk) if causal else sk
        lo = max(q - w + 1, 0) if window else 0
        return max(hi - lo, 0)

    kinks = (sk - 1, w - 1, sk + w - 1)
    cuts = sorted({0, sq} | {c + e for c in kinks for e in (0, 1) if 0 < c + e < sq})
    return sum((f(a) + f(b - 1)) * (b - a) // 2 for a, b in zip(cuts, cuts[1:]))


def flash_attention_cost(q, k, causal=True, window=None, num_heads=None, head_offset=0):
    """(flops, bytes) of one ``flash_attention`` call (module note)."""
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    nh = head_offset + h if num_heads is None else num_heads
    lo, hi = head_offset, min(nh, head_offset + h)
    real = max(hi - lo, 0)
    rep = max(nh // kvh, 1)
    groups = (hi - 1) // rep - lo // rep + 1 if real else 0
    isz = q.element_size()
    flops = 4 * b * real * d * visible_keys(sq, sk, causal, window)
    nbytes = (b * real * sq * d + 2 * b * groups * sk * d + b * h * sq * d) * isz
    return flops, nbytes


def flash_attention_meta(q, k, v, causal=True, window=None, num_heads=None, head_offset=0):
    """[B, H, Sq, D] in q's dtype, laid out as [B, Sq, H, D], as the kernel
    returns it."""
    b, h, sq, d = q.shape
    _count("flash_attention", *flash_attention_cost(q, k, causal, window, num_heads,
                                                    head_offset))
    return torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)


def paged_attention_cost(q, k_pool, page_table, num_heads=None, window=None):
    """(flops, bytes) of one ``paged_attention`` call (module note)."""
    b, h, d = q.shape
    page_size, kvh = k_pool.shape[1], k_pool.shape[2]
    pps = page_table.shape[1]
    nh = h if num_heads is None else num_heads
    keys = pps * page_size if window is None else min(pps * page_size, window)
    isz = q.element_size()
    flops = 4 * b * nh * keys * d
    nbytes = ((b * nh * d + 2 * b * keys * kvh * d + q.numel()) * isz
              + page_table.numel() * page_table.element_size() + b * 4)
    return flops, nbytes


def paged_attention_meta(q, k_pool, v_pool, page_table, lengths, num_heads=None,
                         window=None):
    """[B, H, D] in q's dtype."""
    del v_pool, lengths
    _count("paged_attention", *paged_attention_cost(q, k_pool, page_table, num_heads, window))
    return torch.empty_like(q, memory_format=torch.contiguous_format)


def page_copy_bytes(pool, page_ids) -> int:
    layers = pool.shape[0] if pool.dim() == 3 else 1
    return 2 * layers * page_ids.shape[0] * pool.shape[-1] * pool.element_size()


def page_gather_meta(pool, page_ids):
    """[n, E] from a [P, E] pool, [L, n, E] from an [L, P, E] one."""
    _count("page_gather", 0, page_copy_bytes(pool, page_ids))
    return torch.empty((*pool.shape[:-2], page_ids.shape[0], pool.shape[-1]),
                       dtype=pool.dtype, device=pool.device)


def page_scatter_meta(pool, page_ids, pages):
    """``pool`` itself (the kernel writes it in place)."""
    del pages
    _count("page_scatter", 0, page_copy_bytes(pool, page_ids))
    return pool
