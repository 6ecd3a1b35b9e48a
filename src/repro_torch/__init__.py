"""PyTorch/CUDA port of the ``repro`` package, for an NVIDIA H100.

The JAX package (``src/repro``) is the reference; each module here has one
counterpart there at the same relative path (``repro_torch/kvcache/
paged_kv.py`` <-> ``repro/kvcache/paged_kv.py``).  The port imports
``torch`` and never ``jax`` nor anything of ``repro``: pure-Python modules it
needs are copied.  Each Pallas TPU kernel on a ported path has a
hand-written CUDA C++ kernel under ``csrc/``, built by ``nvcc`` at first use
(``repro_torch.kernels``).

Entry points take an explicit ``device`` that defaults to ``"cuda"`` and
raise when CUDA is missing; tests pass ``device="cpu"``.
"""

from __future__ import annotations

import torch

__version__ = "1.0.0"            # the JAX package's


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and there
    is no usable card (the port never falls back to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: device 'cuda' requested but torch.cuda.is_available() "
            "is false; pass device='cpu' to run the plain PyTorch path")
    return dev


def torch_dtype(name) -> torch.dtype:
    """Config dtype name (``"bfloat16"``, ``"float32"``) -> ``torch.dtype``."""
    if isinstance(name, torch.dtype):
        return name
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt
