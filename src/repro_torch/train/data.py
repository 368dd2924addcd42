"""Data pipeline with AMPER prioritized sequence replay.

Counterpart of ``repro/train/data.py``: the paper's replay carried over
to language models.  Training sequences live in a replay table with
per-sequence priorities (the EMA of the sequence's last loss, the LM
analogue of |TD error|).  Each step the sampler (uniform, PER, AMPER-k,
AMPER-fr) draws the batch, the step runs, and fresh per-sequence losses
are written back.

The token source is the reference's deterministic synthetic corpus (a
seeded Zipf mixture, numpy), so every run and every resume is bitwise
reproducible without external data.  The table, the sampler's state and
the EMA live on the given device; the draws take host keys (the port's
``prng``), whose bits are jax.random's.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.amper import last_writer
from repro_torch.core.samplers import make_sampler
from repro_torch.xla_float import powf


def corpus_tokens(n_seqs: int, seq_len: int, vocab: int, seed: int = 0) -> np.ndarray:
    """Deterministic synthetic corpus: per-sequence Zipf unigram mixtures."""
    rng = np.random.default_rng(seed)
    base = rng.zipf(1.5, size=(n_seqs, seq_len)).astype(np.int64)
    return (base % vocab).astype(np.int32)


class ReplayDataState(NamedTuple):
    sampler_state: object
    loss_ema: torch.Tensor     # float32[n_seqs]
    seen: torch.Tensor         # int32[n_seqs]


class PrioritizedSeqData:
    """Priority-sampled sequence replay over a fixed token table.

    The sampler gets the reference's arguments unchanged (``min_csp`` the
    batch, ``knn_mode="bisect"``, AMPER-fr in its default ``broadcast``
    mode).  The sampler's state is updated in place, as the port's
    samplers do; :meth:`update` returns the state with the new EMA and
    counts.
    """

    def __init__(self, tokens: np.ndarray, batch: int, *,
                 sampler: str = "amper-fr", alpha: float = 0.6,
                 v_max: float = 12.0, m: int = 20, lam_fr: float = 2.0,
                 csp_ratio: float = 0.15, seed: int = 0, device="cuda"):
        self.device = resolve_device(device)
        self.tokens = torch.from_numpy(np.asarray(tokens, np.int32)).to(
            self.device)
        self.n_seqs, self.seq_len = tokens.shape
        self.batch = batch
        self.alpha = alpha
        self.v_max = v_max
        self.sampler = make_sampler(
            sampler, self.n_seqs, m=m, lam_fr=lam_fr, csp_ratio=csp_ratio,
            v_max=v_max, min_csp=batch, knn_mode="bisect",
            device=self.device)

    def init(self) -> ReplayDataState:
        st = self.sampler.init()
        # every sequence starts at max priority => replayed at least once
        full = torch.full((self.n_seqs,), self.v_max, dtype=torch.float32,
                          device=self.device)
        st = self.sampler.update(
            st, torch.arange(self.n_seqs, dtype=torch.int32,
                             device=self.device), full)
        return ReplayDataState(
            sampler_state=st, loss_ema=full.clone(),
            seen=torch.zeros((self.n_seqs,), dtype=torch.int32,
                             device=self.device))

    def sample(self, state: ReplayDataState, key: torch.Tensor):
        """-> (idx int32[batch], batch dict)."""
        idx = self.sampler.sample(state.sampler_state, key, self.batch)
        seq = self.tokens[idx.to(self.device)]
        batch = {
            "tokens": seq[:, :-1],
            "targets": seq[:, 1:],
            "loss_mask": torch.ones((self.batch, self.seq_len - 1),
                                    dtype=torch.float32, device=self.device),
        }
        return idx, batch

    def update(self, state: ReplayDataState, idx: torch.Tensor,
               seq_loss: torch.Tensor) -> ReplayDataState:
        """Write back fresh per-sequence losses (the LM 'TD errors').

        The first write replaces the v_max placeholder, later ones blend
        an EMA.  ``idx`` may repeat (the draw is with replacement): the
        EMA takes each row's last occurrence (whose loss equals the
        others', the same sequence's), and ``seen`` counts every one.
        """
        idx = idx.to(self.device).to(torch.int64)
        seq_loss = seq_loss.to(torch.float32)
        old = state.loss_ema[idx]
        blended = torch.where(state.seen[idx] > 0, 0.5 * old + 0.5 * seq_loss,
                              seq_loss)
        ema = state.loss_ema.clone()
        ema[idx] = blended[last_writer(idx)]
        prio = powf(torch.clamp(ema[idx], 0.0, self.v_max), self.alpha)
        st = self.sampler.update(state.sampler_state, idx, prio)
        seen = state.seen.index_add(0, idx, torch.ones_like(state.seen[idx]))
        return ReplayDataState(sampler_state=st, loss_ema=ema, seen=seen)
