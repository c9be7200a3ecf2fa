"""Architecture registry: ``get_config("<arch-id>")`` and the shape table
(port of ``repro.configs``).

``ARCHITECTURES`` names every architecture of the reference, and
``get_config`` resolves each of them.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import InputShape, ModelConfig  # noqa: F401
from repro_torch.configs.shapes import SHAPES, get_shape  # noqa: F401

_ARCH_MODULES = {
    "qwen2-72b": "repro_torch.configs.qwen2_72b",
    "rwkv6-7b": "repro_torch.configs.rwkv6_7b",
    "qwen3-14b": "repro_torch.configs.qwen3_14b",
    "seamless-m4t-medium": "repro_torch.configs.seamless_m4t_medium",
    "granite-moe-1b-a400m": "repro_torch.configs.granite_moe_1b",
    "kimi-k2-1t-a32b": "repro_torch.configs.kimi_k2_1t",
    "zamba2-2.7b": "repro_torch.configs.zamba2_2p7b",
    "internvl2-26b": "repro_torch.configs.internvl2_26b",
    "minitron-4b": "repro_torch.configs.minitron_4b",
    "h2o-danube-3-4b": "repro_torch.configs.h2o_danube3_4b",
}

ARCHITECTURES = tuple(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; have {list(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[arch]).CONFIG


def supports_long_context(cfg: ModelConfig) -> bool:
    """Whether the arch runs long_500k natively (sub-quadratic without a
    variant toggle); the others get the sliding-window variant."""
    return cfg.family in ("ssm", "hybrid") or cfg.sliding_window is not None


def long_context_variant(cfg: ModelConfig) -> ModelConfig:
    """The long_500k-ready variant: the config itself where it runs
    long_500k natively, else a 4096-token sliding window, named
    ``<name>+swa4k``."""
    if supports_long_context(cfg):
        return cfg
    return cfg.with_(name=cfg.name + "+swa4k", sliding_window=4096)
