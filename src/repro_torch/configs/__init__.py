"""Architecture registry: one module per ported arch, exact public configs.

``get_config(name)`` -> full ModelConfig; ``get_reduced(name)`` -> tiny
same-family config for CPU smoke tests.  ``ARCHS`` lists all ids.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCHS = [
    "granite_moe_1b_a400m",
    "qwen3_1_7b",
]

def _module(name: str):
    # public ids use hyphens/dots (qwen2.5-32b); modules use underscores
    name = name.lower().replace("-", "_").replace(".", "_")
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_reduced(name: str) -> ModelConfig:
    return _module(name).reduced()
