"""Architecture registry of the port: ``--arch <id>`` -> (full, smoke) config.

Mirrors ``repro/configs/registry.py``: every architecture of the JAX
package, with its own copy of each config module.
"""

from __future__ import annotations

import importlib

from .base import ModelConfig

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
