"""Config registry: ``--arch <id>`` -> ArchConfig.

Counterpart of ``repro/configs/__init__.py``: every arch id of the
reference's zoo resolves to a copy of the reference's config, field for
field (the dense and MoE attention archs, the rwkv and hybrid blocks,
the encoder-decoder and the VLM prefix).
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig

# arch id -> module name
_ARCH_MODULES = {
    "rwkv6-7b": "rwkv6_7b",
    "h2o-danube-3-4b": "h2o_danube3_4b",
    "granite-34b": "granite_34b",
    "phi3-medium-14b": "phi3_medium_14b",
    "stablelm-1.6b": "stablelm_1_6b",
    "whisper-tiny": "whisper_tiny",
    "hymba-1.5b": "hymba_1_5b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "paligemma-3b": "paligemma_3b",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCH_IDS)}")
    mod = importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[arch_id]}")
    return mod.config()


def get_reduced_config(arch_id: str, **overrides) -> ArchConfig:
    """Tiny same-family variant for CPU smoke tests."""
    return get_config(arch_id).reduced(**overrides)
