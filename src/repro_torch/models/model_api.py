"""Unified model API: one facade over the port's model families.

Counterpart of ``repro/models/model_api.py`` for the families ``dense``
and ``moe`` (deepseek's MoE, with MLA for deepseek-v2-lite): param specs
(with ``param_dtype``), init, the training loss, prefill, decode and the
cache constructor.  Other families raise NotImplementedError; the
dry-run input specs wait for the dry run (ROADMAP A17.10).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.models import common, transformer


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: Any

    @staticmethod
    def from_config(cfg) -> "Model":
        if cfg.family not in ("dense", "moe"):
            raise NotImplementedError(
                f"{cfg.name}: family {cfg.family!r} is not ported "
                "(ROADMAP A17)")
        return Model(cfg)

    # ---------------- params ----------------
    def param_specs(self):
        specs = transformer.lm_param_specs(self.cfg)
        if self.cfg.param_dtype == "bfloat16":
            specs = common.map_specs(
                lambda sp: sp._replace(dtype=torch.bfloat16)
                if sp.dtype == torch.float32 else sp, specs)
        return specs

    def init_params(self, gen: torch.Generator, device="cuda"):
        """Params on ``device``, drawn from ``gen``, a generator on that
        device (the reference's init laws, torch's draws)."""
        return common.init_params(gen, self.param_specs(), device)

    # ---------------- training ----------------
    def loss(self, params, batch):
        """(loss, metrics) of ``transformer.lm_loss``."""
        if self.cfg.family == "audio":
            raise NotImplementedError(
                f"{self.cfg.name}: the encoder-decoder loss is not ported "
                "(ROADMAP A17.7)")
        return transformer.lm_loss(self.cfg, params, batch)

    # ---------------- serving ----------------
    def prefill(self, params, batch, max_len: int):
        return transformer.prefill(self.cfg, params, batch["tokens"], max_len)

    def decode_step(self, params, tokens, cache):
        return transformer.decode_step(self.cfg, params, tokens, cache)

    def init_cache(self, batch: int, max_len: int, device="cuda"):
        return transformer.init_cache(self.cfg, batch, max_len, device)
