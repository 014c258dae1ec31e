"""Architecture registry of the port (``--arch <id>``): plain-data copies
of the JAX package's config modules.

Each module defines ``config()`` (the published configuration, source
cited) and ``smoke_config()`` (a reduced same-family variant for the CPU
tests). ``ARCH_IDS`` lists all ten configs of the JAX package.
"""
from __future__ import annotations

import importlib

from repro_torch.models.types import INPUT_SHAPES, InputShape, ModelConfig

ARCH_IDS = [
    "granite-3-2b",
    "gemma2-27b",
    "stablelm-12b",
    "command-r-35b",
    "granite-moe-1b-a400m",
    "qwen2-moe-a2.7b",
    "xlstm-125m",
    "hymba-1.5b",
    "musicgen-medium",
    "internvl2-1b",
]

_MODULES = {a: "repro_torch.configs." + a.replace("-", "_").replace(".", "_")
            for a in ARCH_IDS}


def _module(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; choose from {ARCH_IDS}")
    return importlib.import_module(_MODULES[arch_id])


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).config()


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).smoke_config()


def get_input_shape(name: str) -> InputShape:
    return INPUT_SHAPES[name]
