"""Unified model API: one facade over every family of the zoo.

Counterpart of ``repro/models/model_api.py``: param specs (with
``param_dtype``), init, the training loss, prefill (with the audio
family's ``frames`` or the VLM's ``patch_embeds``), decode and the cache
constructor, for the families ``dense``, ``moe``, ``ssm`` (rwkv),
``hybrid`` (hymba), ``vlm`` (paligemma: ``transformer.py`` with its
patch prefix) and ``audio`` (whisper: ``encdec.py``).  The dry-run input
specs wait for the dry run (ROADMAP A17.10).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.models import common, encdec, transformer

FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: Any

    @staticmethod
    def from_config(cfg) -> "Model":
        if cfg.family not in FAMILIES:
            raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}; "
                             f"known: {FAMILIES}")
        return Model(cfg)

    @property
    def _audio(self) -> bool:
        return self.cfg.family == "audio"

    # ---------------- params ----------------
    def param_specs(self):
        if self._audio:
            specs = encdec.encdec_param_specs(self.cfg)
        else:
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
        """(loss, metrics): ``encdec.encdec_loss`` for the audio family
        (the batch holds ``frames``), else ``transformer.lm_loss``."""
        if self._audio:
            return encdec.encdec_loss(self.cfg, params, batch)
        return transformer.lm_loss(self.cfg, params, batch)

    # ---------------- serving ----------------
    def prefill(self, params, batch, max_len: int):
        """The audio family encodes ``batch["frames"]`` and decodes the
        first token of ``batch["tokens"]``; the others prefill the tokens
        after ``batch["patch_embeds"]`` when given."""
        if self._audio:
            return encdec.prefill(self.cfg, params, batch["frames"],
                                  batch["tokens"][:, :1], max_len)
        return transformer.prefill(self.cfg, params, batch["tokens"], max_len,
                                   extra_embeds=batch.get("patch_embeds"))

    def decode_step(self, params, tokens, cache):
        if self._audio:
            return encdec.decode_step(self.cfg, params, tokens, cache)
        return transformer.decode_step(self.cfg, params, tokens, cache)

    def init_cache(self, batch: int, max_len: int, device="cuda"):
        if self._audio:
            return encdec.init_cache(self.cfg, batch, max_len, device)
        return transformer.init_cache(self.cfg, batch, max_len, device)
