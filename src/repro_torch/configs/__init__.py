"""Architecture registry: ``get_config("<arch-id>")`` and the shape table
(port of ``repro.configs``).

``ARCHITECTURES`` names every architecture of the reference.  The dense
family is ported; ``get_config`` of another family raises
``NotImplementedError`` until its model code is (ROADMAP Queue 1 item 16).
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import InputShape, ModelConfig  # noqa: F401
from repro_torch.configs.shapes import SHAPES, get_shape  # noqa: F401

_ARCH_MODULES = {
    "qwen2-72b": "repro_torch.configs.qwen2_72b",
    "rwkv6-7b": None,
    "qwen3-14b": "repro_torch.configs.qwen3_14b",
    "seamless-m4t-medium": None,
    "granite-moe-1b-a400m": None,
    "kimi-k2-1t-a32b": None,
    "zamba2-2.7b": None,
    "internvl2-26b": None,
    "minitron-4b": "repro_torch.configs.minitron_4b",
    "h2o-danube-3-4b": "repro_torch.configs.h2o_danube3_4b",
}

ARCHITECTURES = tuple(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; have {list(_ARCH_MODULES)}")
    module = _ARCH_MODULES[arch]
    if module is None:
        raise NotImplementedError(
            f"{arch!r} is not ported yet: its family's config and model code "
            "come with ROADMAP Queue 1 item 16")
    return importlib.import_module(module).CONFIG
