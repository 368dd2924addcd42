"""Learner loop with a deferred priority-feedback queue.

Counterpart of ``repro/runtime/learner.py``.  The learner consumes
prefetched :class:`~repro_torch.runtime.pipeline.BatchSlab`s on the
service's caller thread and its own stream: S ``learn`` steps a slab, a
Python loop in place of the reference's ``lax.scan``.

Priority feedback is *deferred*: each slab's ``(seq0, idx, |td|, stamp,
version)`` record is enqueued with an event recorded after the slab's
learn steps, and the replay thread applies it out of band through the
buffer's stamped ``update_priorities``, one apply a slab, rows in
learner-step order.  Sequence numbers make the exactly-once / in-order
contract testable; the draw-time version makes staleness (learner steps
between draw and priority write) measurable.

Target sync and params publication happen at slab granularity on the
host: ``target_sync`` is rounded up to the next slab boundary, and every
completed slab publishes the fresh params with their event (actors pick
them up at their next chunk).  ``learn`` builds new params and Adam
moments on every step and never writes a published tensor in place, so
a publication or a snapshot can hold them by reference.
"""
from __future__ import annotations

import collections
import queue
import threading
import time
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.obs import get_registry, span
from repro_torch.runtime.pipeline import BatchSlab
from repro_torch.runtime.streams import accept, mark, on_stream


class Feedback(NamedTuple):
    """One slab's deferred priority updates, learner -> replay thread;
    row j corresponds to global batch sequence number ``seq0 + j``."""

    seq0: int            # global batch sequence number of row 0 (FIFO)
    idx: torch.Tensor    # int32[S, batch] sampled replay rows
    td: torch.Tensor     # float32[S, batch] fresh TD errors
    stamp: torch.Tensor  # int32[S, batch, 2] (counter, gen) write stamps
    #                      taken at draw time
    version: int         # learner steps completed when the slab was drawn
    event: Any = None    # recorded on the learner's stream after the slab


def make_slab_learner(dqn) -> Callable:
    """The slab step ``(params, target, m, v, step0, batch, weights) ->
    (params, m, v, td [S, batch], loss [S])``: S ``learn`` steps, step i
    on batch row i at learner step ``step0 + i``."""
    learn = dqn.learn

    def learn_slab(params, target_params, opt_m, opt_v, step0: int, batch,
                   weights):
        tds, losses = [], []
        for i in range(weights.shape[0]):
            params, opt_m, opt_v, td, loss = learn(
                params, target_params, opt_m, opt_v, step0 + i,
                {k: v[i] for k, v in batch.items()}, weights[i])
            tds.append(td)
            losses.append(loss)
        return params, opt_m, opt_v, torch.stack(tds), torch.stack(losses)

    return learn_slab


class Learner:
    """Drives the slab step; runs on the service's caller thread."""

    def __init__(self, learn_fn: Callable, *, in_q: queue.Queue,
                 feedback_put: Callable[[Feedback], bool],
                 publish: Callable[[Any, Any], None], target_sync: int,
                 stop: threading.Event, stream=None, start_steps: int = 0,
                 on_slab: Callable[..., bool] | None = None):
        self._learn = learn_fn
        self._in_q = in_q
        self._feedback_put = feedback_put
        self._publish = publish           # (params, event) -> None
        self._target_sync = max(int(target_sync), 1)
        self._stop = stop
        self.stream = stream              # the caller thread's stream
        # Checkpoint hook: called after every completed slab (feedback
        # enqueued, params published) with the live (params, target,
        # opt_m, opt_v); returning True stops the run early (preemption).
        self._on_slab = on_slab
        self.steps_done = start_steps     # learner steps (batches) applied
        self.finished = False             # all feedback for the run emitted
        # Live optimizer moments, for the final checkpoint after the run.
        self.opt_m = None
        self.opt_v = None
        # Last loss per slab, kept on the device (no host sync) and
        # bounded so long runs don't grow without limit.
        self.losses: collections.deque = collections.deque(maxlen=256)
        self.first_step_time: float | None = None

    def run(self, params, target_params, opt_m, opt_v,
            n_steps: int) -> tuple[Any, Any]:
        """Consume slabs until ``n_steps`` learner steps are done (rounded
        up to a whole slab).  Returns (params, target_params)."""
        self.opt_m, self.opt_v = opt_m, opt_v
        steps_c = get_registry().counter(
            "learner_steps_total", help="optimizer steps taken")
        try:
            with on_stream(self.stream):
                while self.steps_done < n_steps and not self._stop.is_set():
                    slab = self._get_slab()
                    if slab is None:
                        break
                    if self.first_step_time is None:
                        self.first_step_time = time.perf_counter()
                    accept(self.stream, slab.event, slab.idx, slab.batch,
                           slab.weights, slab.stamp)
                    with span("learn"):
                        params, opt_m, opt_v, td, loss = self._learn(
                            params, target_params, opt_m, opt_v,
                            self.steps_done, slab.batch, slab.weights)
                    self.opt_m, self.opt_v = opt_m, opt_v
                    event = mark(self.stream)
                    s = int(td.shape[0])
                    steps_c.add(s)
                    self._feedback_put(Feedback(
                        seq0=slab.seq0, idx=slab.idx, td=td,
                        stamp=slab.stamp, version=slab.version, event=event))
                    prev = self.steps_done
                    self.steps_done = prev + s
                    # Keep the device tensor: a float() here would sync
                    # the critical path once per slab.
                    self.losses.append(loss[-1])
                    if (self.steps_done // self._target_sync
                            > prev // self._target_sync):
                        target_params = params
                    self._publish(params, event)
                    if self._on_slab is not None and self._on_slab(
                            params, target_params, opt_m, opt_v):
                        break
        finally:
            # The replay thread's exit condition requires finished=True;
            # set it even when the learn step raises, or the replay
            # thread would spin for the rest of the process lifetime.
            self.finished = True
        return params, target_params

    def _get_slab(self) -> BatchSlab | None:
        while not self._stop.is_set():
            try:
                return self._in_q.get(timeout=0.05)
            except queue.Empty:
                continue
        return None
