"""Public entry for prefill attention: the ``impl`` switch.

``"auto"`` launches the CUDA kernel for a CUDA tensor, takes the kernel's
meta implementation for a meta tensor (``kernels/meta.py``: the dry run)
and runs the plain PyTorch version for a CPU tensor; ``"cuda"``,
``"meta"`` and ``"ref"`` force one.  There is no fallback: on a CUDA
tensor, ``"auto"`` launches or raises.
"""

from __future__ import annotations

from ..meta import flash_attention_meta
from .kernel import flash_attention as _cuda
from .ref import flash_attention_ref


def flash_attention(q, k, v, causal=True, window=None, impl="auto", num_heads=None,
                    head_offset=0):
    if impl == "auto":
        impl = "cuda" if q.is_cuda else "meta" if q.is_meta else "ref"
    if impl == "cuda":
        return _cuda(q, k, v, causal=causal, window=window, num_heads=num_heads,
                     head_offset=head_offset)
    if impl == "meta":
        return flash_attention_meta(q, k, v, causal=causal, window=window,
                                    num_heads=num_heads, head_offset=head_offset)
    if impl == "ref":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   num_heads=num_heads, head_offset=head_offset)
    raise ValueError(f"unknown impl {impl!r}; choose auto, cuda, meta or ref")
