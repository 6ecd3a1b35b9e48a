"""Architecture registry of the port: ``--arch <id>`` -> (full, smoke) config.

Mirrors ``repro/configs/registry.py``: every architecture of the JAX
package, with its own copy of each config module, and the dry run's cells
(``runnable_cells`` / ``skipped_cells``).
"""

from __future__ import annotations

import importlib
from typing import List, Tuple

from .base import SHAPES, ModelConfig, ShapeConfig

_MODULES = {
    "smollm-135m": "smollm_135m",
    "qwen2-1.5b": "qwen2_1p5b",
    "llama3-8b": "llama3_8b",
    "deepseek-7b": "deepseek_7b",
    "mixtral-8x7b": "mixtral_8x7b",
    "phi3.5-moe-42b-a6.6b": "phi3p5_moe",
    "hymba-1.5b": "hymba_1p5b",
    "xlstm-1.3b": "xlstm_1p3b",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "seamless-m4t-medium": "seamless_m4t_medium",
}

ARCH_IDS = tuple(_MODULES)


def _mod(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; choose from {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _mod(arch).config()


def get_smoke_config(arch: str) -> ModelConfig:
    return _mod(arch).smoke_config()


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def runnable_cells() -> List[Tuple[str, str]]:
    """All (arch, shape) dry-run cells, with documented skips applied.

    long_500k runs only for sub-quadratic archs (DESIGN.md §5); every arch
    has a decode path (seamless is enc-DEC), so decode shapes always run.
    """
    cells = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in SHAPES.values():
            if shape.name == "long_500k" and not cfg.sub_quadratic:
                continue  # documented skip: pure full attention
            cells.append((arch, shape.name))
    return cells


def skipped_cells() -> List[Tuple[str, str, str]]:
    out = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        if not cfg.sub_quadratic:
            out.append((arch, "long_500k",
                        "pure full attention — 500k decode cache requires "
                        "sub-quadratic attention (DESIGN.md §5)"))
    return out
