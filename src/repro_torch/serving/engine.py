"""Serving engine: batched prefill + decode with pluggable token choice.

Counterpart of ``repro/serving/engine.py``.  The reference jits each
decode step and donates the cache; here the model writes the cache in
place (``models/attention.py::gqa_decode``), so a generate allocates it
once, at prefill.  A decode step never waits on the host: the cache
length stays on the card and the greedy choice is an ``argmax`` there.
``generate`` also offers temperature sampling and an early-stop token,
and makes room in the cache for a VLM's patch prefix.
The two calls carry the profiler spans ``serve_prefill`` and
``serve_decode``.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch import prng
from repro_torch.models.model_api import Model
from repro_torch.obs.tracing import span

F32_TINY = float(torch.finfo(torch.float32).tiny)


class GenerationResult(NamedTuple):
    tokens: torch.Tensor       # [B, gen_len] int32
    logits_last: torch.Tensor  # [B, V] logits of the final step
    cache: Any


class Engine:
    def __init__(self, model: Model, params: Any):
        self.model = model
        self.params = params

    def prefill(self, batch: dict, max_len: int):
        """Prompt batch -> (next-token logits [B, V], cache)."""
        with span("serve_prefill"):
            return self.model.prefill(self.params, batch, max_len)

    def decode(self, tokens: torch.Tensor, cache):
        """One decode step: tokens [B, 1] -> (logits [B, 1, V], cache)."""
        with span("serve_decode"):
            return self.model.decode_step(self.params, tokens, cache)

    def cache_len(self, prompt_len: int, gen_len: int) -> int:
        """The cache length a generate of ``gen_len`` tokens after a
        ``prompt_len``-token prompt needs: the prompt, the generated
        tokens, one spare, and a VLM's patch prefix
        (``repro/serving/engine.py``'s ``max_len``)."""
        return prompt_len + gen_len + 1 + self.model.cfg.vis_prefix_len

    def generate(self, batch: dict, gen_len: int, *,
                 temperature: float = 0.0,
                 key: Optional[torch.Tensor] = None,
                 stop_token: Optional[int] = None) -> GenerationResult:
        max_len = self.cache_len(batch["tokens"].shape[1], gen_len)
        logits, cache = self.prefill(batch, max_len)
        B = batch["tokens"].shape[0]
        tok = self._choose(logits.reshape(B, -1), temperature, key, 0)
        out = [tok]
        done = torch.zeros(B, dtype=torch.bool, device=tok.device)
        for i in range(gen_len - 1):
            logits, cache = self.decode(tok, cache)
            nxt = self._choose(logits[:, -1], temperature, key, i + 1)
            if stop_token is not None:
                done = done | (tok[:, 0] == stop_token)
                nxt = torch.where(done[:, None], tok, nxt)
            tok = nxt
            out.append(tok)
        return GenerationResult(tokens=torch.cat(out, dim=1),
                                logits_last=logits[:, -1], cache=cache)

    @staticmethod
    def _choose(logits: torch.Tensor, temperature: float,
                key: Optional[torch.Tensor], step: int) -> torch.Tensor:
        """Greedy: ``argmax`` (ties to the first index, as ``jnp.argmax``).
        Temperature: Gumbel-max over ``prng.uniform`` on
        ``fold_in(key, step)``, the twin of ``jax.random.categorical``
        (its ``gumbel`` draws ``uniform(minval=tiny, maxval=1)``)."""
        if temperature <= 0.0 or key is None:
            tok = torch.argmax(logits, dim=-1)
        else:
            u = prng.uniform(prng.fold_in(key, step), tuple(logits.shape),
                             F32_TINY, 1.0, device=logits.device)
            gumbel = -torch.log(-torch.log(u))
            tok = torch.argmax(gumbel + logits / temperature, dim=-1)
        return tok.reshape(-1, 1).to(torch.int32)
