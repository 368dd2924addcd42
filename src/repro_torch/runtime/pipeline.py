"""Double-buffered prefetch of sampled batch slabs.

Counterpart of ``repro/runtime/pipeline.py``.  The pipeline thread draws
slab N+1 while the learner consumes slab N: one draw of ``batch * slab``
rows from the sampler's law (one CSP build for AMPER, one kernel launch
for the fused draw) split into S batches, pushed into a bounded queue
of depth ``prefetch_depth`` (2 = classic double buffering).  Any
registry sampler works, the sharded kinds included.

The reference draws from an immutable state reference it last saw; the
port's state is written in place, so the draw is enqueued under the
service's :class:`~repro_torch.runtime.streams.StateGuard` on this
thread's stream, after the last write the guard ordered and before the
next, and the health probe re-derives the same draw inside the same
guarded block.  Each slab carries the write stamps taken at draw time
(for the stale-safe deferred priority update), the learner-step version
at draw time (for staleness accounting) and the event that marks its
tensors ready.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.obs import span
from repro_torch.runtime import prng
from repro_torch.runtime.actor import PauseGate
from repro_torch.runtime.streams import StateGuard, on_stream, stage_stream


class BatchSlab(NamedTuple):
    """S prefetched batches, stacked on a leading slab axis."""

    seq0: int              # global batch sequence number of row 0
    idx: torch.Tensor      # int32[S, batch] sampled replay rows
    batch: Any             # dict, leaves [S, batch, ...]
    weights: torch.Tensor  # float32[S, batch] importance weights
    stamp: torch.Tensor    # int32[S, batch, 2] (counter, gen) write stamps
    #                        taken at draw time
    version: int           # learner steps completed when this was drawn
    event: Any = None      # recorded on the prefetch stream after the draw


def make_slab_sampler(replay, batch: int, slab: int) -> Callable:
    """The slab draw ``(buffer_state, key, beta) -> (idx, batch, w,
    stamp)``: ONE ``S * batch`` draw of the sampler's law shaped to
    ``[S, batch]``.

    The PER samplers draw stratified (one uniform per segment of the
    cumulative mass), so the rows are split by *interleaving* strata:
    batch j takes flat rows {j, S+j, 2S+j, ...}, the reference's
    ``reshape(batch, slab, ...).swapaxes(0, 1)``, which makes every batch
    a stratified sample over the whole priority range.  For AMPER the
    split is immaterial, and one CSP serves the slab.  Importance weights
    are max-normalized over the whole slab.
    """

    def sample_slab(state, key, beta):
        idx, tree, w = replay.sample(state, key, batch * slab, beta=beta)

        def shape(x):  # [S*batch, ...] -> [S, batch, ...], interleaved
            return x.reshape((batch, slab) + tuple(x.shape[1:])
                             ).transpose(0, 1)

        return (shape(idx), {k: shape(v) for k, v in tree.items()},
                shape(w), shape(replay.stamps(state, idx)))

    return sample_slab


class PrefetchPipeline(threading.Thread):
    """Prefetch thread: guarded draw -> bounded queue.

    ``state_fn()`` returns ``(buffer_state, version)`` and is read inside
    the guard, so the state's host counters match what the device holds
    at that point of the order.
    """

    def __init__(self, sample_fn: Callable, state_fn: Callable, *,
                 out_q: queue.Queue, stop: threading.Event,
                 base_key: torch.Tensor, slab: int, min_size: int,
                 guard: StateGuard, device: torch.device,
                 beta_fn: Callable[[int], Any] | None = None,
                 gate: PauseGate | None = None, start_draw: int = 0,
                 start_seq: int = 0,
                 probe: Callable[[Any, torch.Tensor], None] | None = None,
                 probe_every: int = 0):
        super().__init__(name="replay-prefetch", daemon=True)
        self._sample = sample_fn
        self._state_fn = state_fn
        self._out_q = out_q
        self._stop_evt = stop
        self._base_key = base_key
        self._slab = slab
        self._min_size = min_size
        self._guard = guard
        self._stream = stage_stream(device)
        # version -> IS exponent: the annealed-beta schedule evaluated at
        # the learner step this slab was drawn for.
        self._beta_fn = beta_fn
        self._gate = gate
        # Resume counters: ``draws`` is the PRNG stream position (every
        # performed draw consumed sample_key(base_key, draw), delivered
        # or not), ``seq`` the global batch sequence of the next slab.
        self._start_draw = start_draw
        self._start_seq = start_seq
        # Replay-health probe: called with the exact (state, key) of one
        # in every ``probe_every`` draws, right after the draw and under
        # the same guard, so it re-derives that draw's facts.
        self._probe = probe
        self._probe_every = max(int(probe_every), 0) if probe else 0
        self.draws = start_draw
        self.slabs_done = 0
        # IS exponent the latest completed draw used (None until then).
        self.last_beta: float | None = None
        self.error: BaseException | None = None

    def run(self) -> None:
        try:
            with on_stream(self._stream):
                self._loop()
        except BaseException as e:
            self.error = e
            self._stop_evt.set()

    def _try_put(self, slab) -> bool:
        """One bounded put attempt; abandon to the gate/stop checks."""
        try:
            self._out_q.put(slab, timeout=0.05)
            return True
        except queue.Full:
            return False

    def _draw(self, seq: int, draw: int) -> BatchSlab | None:
        """One guarded slab draw (None while the buffer is too small)."""
        key = prng.sample_key(self._base_key, draw)
        with self._guard.use(self._stream) as op:
            state, version = self._state_fn()
            if state.size < self._min_size:  # a host int: no device sync
                return None
            beta = (self._beta_fn(version) if self._beta_fn is not None
                    else None)
            with span("slab_draw"):
                idx, batch, weights, stamp = self._sample(state, key, beta)
            if self._probe_every and draw % self._probe_every == 0:
                self._probe(state, key)
        # Publish beta only once the draw has returned: a draw that raises
        # must not leave metrics reporting the beta of a slab that never
        # existed.
        if beta is not None:
            self.last_beta = float(beta)
        return BatchSlab(seq0=seq, idx=idx, batch=batch, weights=weights,
                         stamp=stamp, version=version, event=op.event)

    def _loop(self) -> None:
        seq, draw = self._start_seq, self._start_draw
        pending = None
        while not self._stop_evt.is_set():
            if self._gate is not None:
                # Park holding any undelivered slab; it is delivered
                # after resume, so sequence numbers stay gapless.
                self._gate.wait_if_paused(self._stop_evt)
            if pending is None:
                pending = self._draw(seq, draw)
                if pending is None:
                    time.sleep(0.002)  # buffer not yet sampleable
                    continue
                draw += 1
                self.draws = draw
            if self._try_put(pending):
                pending = None
                seq += self._slab
                self.slabs_done += 1
