"""Unified model API: one facade over every family of the zoo.

Counterpart of ``repro/models/model_api.py``: param specs (with
``param_dtype``), init, the training loss, prefill (with the audio
family's ``frames`` or the VLM's ``patch_embeds``), decode and the cache
constructor, for the families ``dense``, ``moe``, ``ssm`` (rwkv),
``hybrid`` (hymba), ``vlm`` (paligemma: ``transformer.py`` with its
patch prefix) and ``audio`` (whisper: ``encdec.py``), and what the dry
run (``launch/dryrun.py``) traces against: the params, the logical axes
of the params and caches, and ``input_specs(shape)``, empty ``meta``
tensors standing in for every input of every assigned (arch x shape)
cell (no memory).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.models import common, encdec, transformer

FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")


class ShapeCell(NamedTuple):
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPE_CELLS = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}


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

    def abstract_params(self):
        """The params as empty ``meta`` tensors."""
        return common.abstract_params(self.param_specs())

    def param_axes(self):
        return common.param_axes(self.param_specs())

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

    def cache_axes(self):
        """The logical-axes tree parallel to ``init_cache``'s."""
        cfg = self.cfg
        if self._audio:
            return encdec.encdec_cache_axes(cfg)
        stacked = {k: ("layers",) + v
                   for k, v in transformer.cache_axes(cfg).items()}
        out = {"blocks": stacked, "len": ()}
        if transformer._n_dense(cfg):
            out["dense_blocks"] = stacked
        return out

    # ---------------- dry-run input specs ----------------
    def input_specs(self, shape_name: str) -> dict:
        """Empty ``meta`` tensors standing in for the inputs of the
        assigned shape cell: the batch of a train step or a prefill, or a
        decode step's tokens and its cache of ``seq_len`` positions."""
        cfg = self.cfg
        cell = SHAPE_CELLS[shape_name]
        B, S = cell.global_batch, cell.seq_len
        dt = transformer._adtype(cfg)

        def meta(*shape, dtype=dt):
            return torch.empty(shape, dtype=dtype, device="meta")

        def tok(b, s):
            return meta(b, s, dtype=torch.int32)

        if cell.kind == "train":
            if self._audio:
                return {"tokens": tok(B, S), "targets": tok(B, S),
                        "loss_mask": meta(B, S, dtype=torch.float32),
                        "frames": meta(B, cfg.enc_seq, cfg.d_model)}
            st = S - cfg.vis_prefix_len  # total positions == seq_len
            batch = {"tokens": tok(B, st), "targets": tok(B, st),
                     "loss_mask": meta(B, st, dtype=torch.float32)}
            if cfg.vis_prefix_len:
                batch["patch_embeds"] = meta(B, cfg.vis_prefix_len,
                                             cfg.d_model)
            return batch
        if cell.kind == "prefill":
            if self._audio:
                return {"tokens": tok(B, S),
                        "frames": meta(B, cfg.enc_seq, cfg.d_model)}
            batch = {"tokens": tok(B, S - cfg.vis_prefix_len)}
            if cfg.vis_prefix_len:
                batch["patch_embeds"] = meta(B, cfg.vis_prefix_len,
                                             cfg.d_model)
            return batch
        # decode: one new token against a seq_len cache
        return {"tokens": tok(B, 1),
                "cache": self.init_cache(B, S, device="meta")}
