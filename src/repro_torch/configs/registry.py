"""Architecture registry of the port: ``--arch <id>`` -> (full, smoke) config.

Mirrors ``repro/configs/registry.py`` but offers only the architectures the
port runs so far.  The other ids of the JAX package are known and refused
with a pointer to the queue that ports them, never silently mapped to
something else.
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
}

# Architectures of the JAX package that the port does not run yet
# (ROADMAP.md, Queue 1 item 7: xLSTM, M-RoPE, encoder-decoder).
_NOT_PORTED = ("seamless-m4t-medium", "qwen2-vl-7b", "xlstm-1.3b")

ARCH_IDS = tuple(_MODULES)


def _mod(arch: str):
    if arch in _NOT_PORTED:
        raise NotImplementedError(
            f"arch {arch!r} is not ported to repro_torch yet; see ROADMAP.md "
            f"(Queue 1, rest of the model zoo). Ported: {sorted(_MODULES)}")
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; choose from {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _mod(arch).config()


def get_smoke_config(arch: str) -> ModelConfig:
    return _mod(arch).smoke_config()
