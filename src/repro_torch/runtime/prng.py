"""PRNG stream discipline for the async runtime.

Counterpart of ``repro/runtime/prng.py``, on :mod:`repro_torch.prng`'s
host keys, so every key equals the reference's bit for bit.  Every
concurrent consumer of randomness (each actor thread and the prefetch
pipeline) folds a distinct stream tag, and for actors its actor id, into
the run key before deriving per-chunk and per-draw keys: no two threads
consume the same key and no thread consumes a key twice.

Layout (``key`` is the key passed to ``ReplayService.run``):

  actor i     fold_in(fold_in(key, ACTOR_STREAM), i) --split--> (reset, roll)
              chunk c uses fold_in(roll, c); step t in the chunk folds t
  prefetcher  fold_in(fold_in(key, SAMPLE_STREAM), draw_seq)

The service itself uses the run key only through ``dqn.init``, and the
sync mode's step keys are the trainer's ``split(fold_in(key, 1), n)``,
so none of these streams collides with them.
"""
from __future__ import annotations

import torch

from repro_torch import prng

ACTOR_STREAM = 0xAC70  # actor-pool stream tag
SAMPLE_STREAM = 0x5A4B  # prefetch-pipeline stream tag


def actor_keys(key: torch.Tensor, actor_id: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (env-reset key, rollout stream key) for one actor thread."""
    stream = prng.fold_in(prng.fold_in(key, ACTOR_STREAM), actor_id)
    k_reset, k_roll = prng.split(stream)
    return k_reset, k_roll


def chunk_key(roll_key: torch.Tensor, chunk_id: int) -> torch.Tensor:
    """Per-rollout-chunk key within one actor's stream."""
    return prng.fold_in(roll_key, chunk_id)


def sample_key(key: torch.Tensor, draw_seq: int) -> torch.Tensor:
    """Per-draw key for the prefetch pipeline's sampler calls."""
    return prng.fold_in(prng.fold_in(key, SAMPLE_STREAM), draw_seq)
