"""Public entry for paged decode attention: the ``impl`` switch.

``"auto"`` launches the CUDA kernel for a CUDA tensor, takes the kernel's
meta implementation for a meta tensor (``kernels/meta.py``: the dry run)
and runs the plain PyTorch version for a CPU tensor; ``"cuda"``,
``"meta"`` and ``"ref"`` force one.  There is no fallback: on a CUDA
tensor, ``"auto"`` launches or raises.
"""

from __future__ import annotations

from ..meta import paged_attention_meta
from .kernel import paged_attention as _cuda
from .ref import paged_attention_ref


def paged_attention(q, k_pool, v_pool, page_table, lengths, impl="auto",
                    num_heads=None, window=None):
    if impl == "auto":
        impl = "cuda" if q.is_cuda else "meta" if q.is_meta else "ref"
    if impl == "cuda":
        return _cuda(q, k_pool, v_pool, page_table, lengths, num_heads=num_heads,
                     window=window)
    if impl == "meta":
        return paged_attention_meta(q, k_pool, v_pool, page_table, lengths,
                                    num_heads=num_heads, window=window)
    if impl == "ref":
        return paged_attention_ref(q, k_pool, v_pool, page_table, lengths,
                                   num_heads=num_heads, window=window)
    raise ValueError(f"unknown impl {impl!r}; choose auto, cuda, meta or ref")
