"""Config registry: ``--arch <id>`` -> ArchConfig.

Counterpart of ``repro/configs/__init__.py``.  Every arch id of the
reference is known; those whose model path the port has (the attention
block with GQA or MLA, a dense or MoE MLP and a uniform sliding window:
``stablelm-1.6b``, ``granite-34b``, ``phi3-medium-14b``,
``h2o-danube-3-4b``, ``deepseek-moe-16b``, ``deepseek-v2-lite-16b``)
resolve, and the others raise ``NotImplementedError`` naming the ROADMAP
item that ports them.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig

# arch id -> module name, for the ported ones
_ARCH_MODULES = {
    "stablelm-1.6b": "stablelm_1_6b",
    "granite-34b": "granite_34b",
    "phi3-medium-14b": "phi3_medium_14b",
    "h2o-danube-3-4b": "h2o_danube3_4b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
}

# arch id -> the ROADMAP item (queue A) that ports its path
_NOT_PORTED = {
    "rwkv6-7b": "A17.5 (SSM / rwkv)",
    "hymba-1.5b": "A17.6 (hybrid, with its per-layer windows)",
    "whisper-tiny": "A17.7 (encoder-decoder)",
    "paligemma-3b": "A17.8 (VLM prefix, with the prefix-LM mask at prefill)",
}

ARCH_IDS = tuple(_ARCH_MODULES) + tuple(_NOT_PORTED)


def get_config(arch_id: str) -> ArchConfig:
    if arch_id in _NOT_PORTED:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported yet: ROADMAP {_NOT_PORTED[arch_id]}")
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCH_IDS)}")
    mod = importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[arch_id]}")
    return mod.config()


def get_reduced_config(arch_id: str, **overrides) -> ArchConfig:
    """Tiny same-family variant for CPU smoke tests."""
    return get_config(arch_id).reduced(**overrides)
