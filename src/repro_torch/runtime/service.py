"""`ReplayService`: the async actor-learner replay façade, on one card.

Counterpart of ``repro/runtime/service.py``.  It wires the pipeline
stages into one system:

    actors (threads, rollout chunks)
        └── transition blocks ──> replay thread (ring writes, priority
                                  feedback applies on the canonical state)
    prefetch thread (slab draws from the canonical state)
        └── batch slabs ──>
    learner (caller thread, S TD steps a slab)
        └── deferred priority feedback ──> replay thread (stamped,
                                           out of band, exactly once)

``sync=True`` degrades the service to a strict synchronous mode: the
trainer's ``agent_step`` driven step by step on the trainer's keys
``split(fold_in(key, 1), n_steps)``, with no thread and no extra stream,
equal to ``dqn.train`` bit for bit.  It is the baseline the async mode
is measured against.

Device, streams and the in-place state
--------------------------------------

``ReplayService(cfg, ..., device="cuda")`` builds the agent with
``make_dqn(cfg, device=device)``; the tests pass ``"cpu"``.  (The
reference's ``device`` means where prefetched batches go; on one card
that is the service's device, so the two meanings collapse.)  Each stage
thread runs under its own ``torch.cuda.Stream`` on that device: every
actor, the prefetcher, the replay thread, the learner (the caller's
thread) and the snapshot writer.  On the CPU the streams are null
contexts.

* **Every hand-off is ordered and kept alive.**  The transition block,
  the batch slab, the feedback slab, the published params and the
  snapshot capture each travel with an event the producer recorded on
  its stream after making them; the consumer's stream waits on it and
  calls ``record_stream`` on every tensor it received, so the caching
  allocator (per stream) does not hand the memory out again while the
  consumer's kernels still read it (:mod:`repro_torch.runtime.streams`).
* **Draws and writes do not overlap.**  The reference's replay thread
  publishes a fresh immutable pytree after every write, and the
  prefetcher and the snapshotter read whatever reference they last saw.
  The port writes the ring, the stamps and the sampler tables in place,
  so that reading would let a draw see a half-written arc.  Instead the
  tracked lock ``runtime.replay_state`` (a
  :class:`~repro_torch.runtime.streams.StateGuard`) is held while a
  write, a feedback apply, a draw (with its health probe, as one unit)
  or a snapshot clone is enqueued; each waits on the event of the
  operation before it, so the card runs them in the order the lock
  granted them, and each records the state's tensors as in use on its
  stream.
* **Copy-on-write is an explicit copy.**  The snapshotter's ``capture``
  clones the buffer's tensors on the replay stream under that lock (at
  1M CartPole rows a 61.3 MB copy, read and written once).  The params
  and Adam moments are taken by reference: ``learn`` builds new tensors
  on every step and never writes a published one in place.  The writer
  thread waits on the capture's events before the checkpoint layer
  copies the tensors to the host.  ``snapshot_pause_us`` records the
  host cost of the capture, the lock wait included.  The dirty rows
  still come from the ``_fb_rows`` log against the previous save's
  watermark.
* **No jit and no donation.**  The reference donates the consumed block
  and feedback buffers but never the replay state: the prefetcher may
  be mid-draw on the same buffers when the next write lands.  Here the
  same hazard is what the lock above orders; nothing is donated.

No stage catches a kernel's build or launch error: a thread that fails
sets ``stop`` and ``run`` raises its error.

Durability: pass a :class:`~repro_torch.train.checkpoint.CheckpointManager`
to :meth:`ReplayService.run` and the service checkpoints the whole replay
stack (params, optimizer moments, the canonical ``ReplayState``, per-actor
env states, n-step windows and PRNG stream positions, the prefetcher's
draw counter) in the reference's on-disk format, and auto-resumes from
the latest checkpoint.  Saves are incremental (delta chains over the
ring arcs and priority rows written since the last save) and, in async
mode, copy-on-write: nothing pauses but the capture.  In sync mode a
killed and resumed run equals an uninterrupted one bit for bit; async
resume keeps the exactly-once, gapless feedback contract, not the
frames (thread interleaving decides which land first).

Metrics answer the questions the paper's latency story raises at system
scale: learner steps/s, frames/s, queue depths (is the sampler or the
actor pool the bottleneck?) and priority-feedback staleness.
"""
from __future__ import annotations

import collections
import functools
import queue
import threading
import time
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch import obs, prng, resolve_device
from repro_torch.analysis.locks import tracked_queue
from repro_torch.rl.dqn import DQNConfig, make_dqn
from repro_torch.runtime.actor import ActorPool, make_rollout, put_with_stop
from repro_torch.runtime.learner import Feedback, Learner, make_slab_learner
from repro_torch.runtime.pipeline import PrefetchPipeline, make_slab_sampler
from repro_torch.runtime.streams import (StateGuard, accept, clone, mark,
                                         on_stream, stage_stream)
from repro_torch.train import checkpoint as ckpt_mod
from repro_torch.train import replay_checkpoint as rck


class RunResult(NamedTuple):
    params: Any          # final network params (dqn.evaluate accepts them)
    target_params: Any
    buffer: Any          # final canonical ReplayState
    metrics: dict


def _hstats(snap: obs.Snapshot, name: str) -> dict:
    """Histogram summary from a snapshot, zeros when absent/empty."""
    data = snap.data.get(name)
    if not data:
        return {"count": 0, "mean": 0.0, "min": 0.0, "max": 0.0,
                "p50": 0.0, "p95": 0.0, "p99": 0.0}
    return obs.hist_stats(data, snap.meta[name]["bounds"])


def _cval(snap: obs.Snapshot, name: str) -> float:
    data = snap.data.get(name)
    if not data:
        return 0.0
    v = data.get("value", 0.0)
    return 0.0 if v != v else float(v)  # NaN (unset gauge) -> 0


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _RunTelemetry:
    """Per-run observability bundle: registry, instruments, exporters.

    Built at ``run()`` entry and installed as the process-global registry
    for the run, so spans recorded by the runtime threads and by the
    checkpoint and replay layers land in one place; :meth:`finish`
    restores the previous registry.  The service always runs with an
    enabled registry (the staleness and queue-depth stats are always
    kept); the user's Telemetry spec adds exporters and the replay-health
    probe.  ``RunResult.metrics`` comes from a snapshot diff against the
    run-start snapshot, so a long-lived registry still gives per-run
    numbers.
    """

    def __init__(self, spec: obs.Telemetry | None):
        # No spec -> aggregate stats only: no exporters and no probe
        # (a probe spends a draw's work at its cadence).
        self.spec = (spec if spec is not None
                     else obs.Telemetry(probe_every=0))
        self.registry = (self.spec.registry if self.spec.registry is not None
                         else obs.Registry(enabled=True))
        r = self.registry
        self.frames = r.counter(
            "frames_total", help="environment frames appended to replay")
        self.blocks = r.counter(
            "blocks_total", help="transition blocks absorbed by the core")
        self.fb_enqueued = r.counter(
            "feedback_enqueued_total",
            help="priority-feedback slabs enqueued")
        self.fb_applied = r.counter(
            "feedback_applied_total", help="priority-feedback slabs applied")
        self.staleness = r.histogram(
            "staleness_steps", bounds=obs.INT_BUCKETS,
            help="priority-feedback staleness in learner steps")
        self.work_depth = r.histogram(
            "work_queue_depth", bounds=obs.INT_BUCKETS,
            help="actor->replay queue depth per drained item")
        self.batch_depth = r.histogram(
            "batch_queue_depth", bounds=obs.INT_BUCKETS,
            help="prefetch->learner queue depth per drained item")
        self.snap_pause = r.histogram(
            "snapshot_pause_us", bounds=obs.US_BUCKETS,
            help="pipeline pause per snapshot: COW capture cost in async "
                 "mode, the blocking save in sync mode (microseconds)")
        self.base = r.snapshot()
        # the run's spans are those logged after this one
        self.span_base = max((s.seq for s in r.span_log.records()),
                             default=-1)
        self.exporter = (obs.JsonlExporter(self.spec.metrics_out)
                         if self.spec.metrics_out else None)
        self.health: obs.ReplayHealth | None = None
        self._prev = obs.set_registry(r)
        self._finished = False

    def probe_hook(self, sampler, batch: int):
        """The pipeline's probe callback (None when probing is off).  It
        runs on the prefetch thread at cadence, inside the draw's guard:
        it re-derives the draw's CSP facts, refreshes the health gauges
        and appends a JSONL snapshot line, so the log is a timeline."""
        if self.spec.probe_every <= 0:
            return None
        self.health = obs.ReplayHealth(self.registry, sampler, batch,
                                       window=self.spec.window)

        def hook(state, key):
            self.health.update(state.sampler_state, key)
            if self.exporter is not None:
                self.exporter.write_snapshot(self.diff())

        return hook

    def diff(self) -> obs.Snapshot:
        return self.registry.snapshot().diff(self.base)

    def event(self, name: str, **fields) -> None:
        if self.exporter is not None:
            self.exporter.write_event(name, **fields)

    def finish(self, extra: dict | None = None) -> None:
        """The run's spans and a final snapshot into the JSONL log, the
        Prometheus dump, then restore the previously installed global
        registry.  Idempotent."""
        if self._finished:
            return
        self._finished = True
        if self.exporter is not None:
            self.exporter.write_spans(s for s in self.registry.spans()
                                      if s.seq > self.span_base)
            self.exporter.write_snapshot(self.diff(), extra=extra)
            self.exporter.close()
        if self.spec.prometheus_out:
            obs.write_prometheus(self.registry, self.spec.prometheus_out)
        obs.set_registry(self._prev)


class ReplayService:
    """Asynchronous actor-learner replay service (or its strict-sync twin).

    Args:
      cfg: the DQN config (env, sampler, batch, schedules).
      num_actors: actor threads; each steps ``cfg.num_envs`` envs.
      sync: strict synchronous mode; requires ``num_actors=1`` and equals
        the trainer's iteration exactly.
      chunk_len: env steps per actor rollout chunk.
      slab: batches per prefetch draw and per learner call.
      prefetch_depth: batch-slab queue depth (2 = double buffering).
      queue_size: transition-block + feedback queue bound (backpressure).
      min_size: buffer fill before sampling starts; defaults to the
        trainer's ``learn_start`` worth of frames.
      max_replay_ratio: optional frames-per-learner-step cap; actors pause
        when generation runs this far ahead of consumption.
      feedback_log: record the per-batch feedback sequence trace in
        ``metrics["feedback_seqs"]`` (O(learner steps) memory, for tests).
      device: where the agent, the replay and every stage run (default
        the card; ``"cpu"`` for the tests).
      mesh: a :class:`~repro_torch.distributed.sharding.Mesh` for the
        sharded sampler kinds (as ``make_dqn``'s).
      telemetry: an :class:`repro_torch.obs.Telemetry` spec adding the
        JSONL / Prometheus exporters and the replay-health probe to the
        registry-backed run metrics.
    """

    def __init__(self, cfg: DQNConfig, *, num_actors: int = 2,
                 sync: bool = False, chunk_len: int = 32, slab: int = 4,
                 prefetch_depth: int = 2, queue_size: int = 8,
                 min_size: int | None = None,
                 max_replay_ratio: float | None = None,
                 feedback_log: bool = False, device="cuda", mesh=None,
                 telemetry: obs.Telemetry | None = None):
        if sync and num_actors != 1:
            raise ValueError("sync mode is defined for num_actors=1 "
                             f"(got {num_actors})")
        self.cfg = cfg
        self.sync = sync
        self.num_actors = num_actors
        self.chunk_len = chunk_len
        self.slab = slab
        self.prefetch_depth = prefetch_depth
        self.queue_size = queue_size
        self.device = resolve_device(device)
        self.min_size = (min_size if min_size is not None else
                         max(cfg.batch,
                             min(cfg.learn_start * cfg.num_envs,
                                 cfg.replay_size)))
        self.max_replay_ratio = max_replay_ratio
        self.feedback_log = feedback_log
        self.telemetry = telemetry
        self.dqn = make_dqn(cfg, device=self.device, mesh=mesh)
        rb = self.dqn.replay
        # Frame-deduplicated storage chains stacks through ring adjacency
        # (slot i - stride must be the previous timestep of the same env
        # stream).  Interleaved blocks from several actors would break
        # that on every chunk boundary, so pixel runs are single-actor.
        if rb.frame_store is not None and num_actors != 1:
            raise ValueError(
                "frame-store replay requires num_actors=1: stack "
                "materialization relies on single-stream ring adjacency "
                f"(got num_actors={num_actors})")
        self._rollout = make_rollout(self.dqn, chunk_len)
        self._sample = make_slab_sampler(rb, cfg.batch, slab)
        self._learn = make_slab_learner(self.dqn)
        # Actors pre-aggregate n-step rows in their own windows, so the
        # canonical buffer must not run its accumulator again.
        self._add_block = functools.partial(rb.add_block, aggregated=True)

        def apply_feedback(state, idx, td, stamp):
            # Flatten [S, batch] row-major: the stamped update resolves
            # rows duplicated across batches to their last valid
            # occurrence, so one apply reproduces sequential applies.
            return rb.update_priorities(state, idx.reshape(-1),
                                        td.reshape(-1),
                                        stamp=stamp.reshape(-1, 2))

        self._apply_feedback = apply_feedback
        self._agent_step = self.dqn.agent_step
        # The order of every operation on the canonical state (a fresh
        # one each async run) and the stream the replay thread, and a
        # snapshot's clone, enqueue on.
        self._guard: StateGuard | None = None
        self._replay_stream = None
        self._bstate = None
        # (fb_applied_at_append, host idx rows) log the replay thread
        # feeds and the COW snapshotter consumes; None when the run has
        # no checkpoint manager (zero cost on the hot path).
        self._fb_rows: collections.deque | None = None
        # (learned, synced) -> cached non-buffer sync dirty tree.
        self._sync_dirty_tpl: dict = {}

    # ------------------------------------------------------------------ #

    def run(self, key: torch.Tensor, n_steps: int,
            manager: ckpt_mod.CheckpointManager | None = None) -> RunResult:
        """Train for ``n_steps``: trainer iterations in sync mode, learner
        steps (rounded up to a whole slab) in async mode.

        With a ``manager`` the run checkpoints periodically (and on
        preemption) and AUTO-RESUMES from the manager's latest
        checkpoint; ``n_steps`` is the absolute target, so a resumed run
        executes only the remainder.  The snapshot embeds the run key;
        sync mode validates ``n_steps`` (its step keys depend on it).
        """
        if manager is not None:
            manager.install_preemption_hook()  # no-op off the main thread
        tel = _RunTelemetry(self.telemetry)
        try:
            if self.sync:
                result = self._run_sync(prng.key_data(key), n_steps, manager,
                                        tel)
            else:
                result = self._run_async(prng.key_data(key), n_steps,
                                         manager, tel)
        finally:
            tel.finish(extra={"mode": "sync" if self.sync else "async"})
        return result

    # --- checkpoint snapshot targets ----------------------------------- #

    @staticmethod
    def _key_data(key: torch.Tensor) -> np.ndarray:
        """The run key as the reference stores it: ``uint32[2]``."""
        return prng.key_data(key).numpy().astype(np.uint32)

    def _sync_target(self):
        return {"key_data": self._key_data(prng.key(0)),
                "state": self.dqn.ckpt_target()}

    def _async_target(self):
        a = self.dqn.ckpt_target()
        actor_t = {"env_state": a.env_state, "obs": a.obs,
                   "ep_ret": torch.zeros(self.cfg.num_envs,
                                         device=self.device),
                   # the actor's own n-step window (None when n_step=1),
                   # shaped as the buffer's in-state one
                   "nstep": a.buffer.nstep}
        return {"key_data": self._key_data(prng.key(0)),
                "params": a.params, "target_params": a.target_params,
                "opt_m": a.opt_m, "opt_v": a.opt_v, "buffer": a.buffer,
                "actors": [actor_t for _ in range(self.num_actors)]}

    def _restore(self, manager, target, mode: str, **expected):
        """(step, snapshot, meta) from the latest checkpoint, or Nones.

        The meta is validated BEFORE the arrays load, so a topology
        mismatch (actor count, mode, n_steps) reads as what it is.  The
        tensors land on the service's device, a dense sampler table goes
        back onto this sampler's shards by the caller
        (``rck.from_dense_view``), so a table saved on 4 shards resumes
        on 2, or on one."""
        step = manager.latest_step()
        if step is None:
            return None, None, None
        meta = ckpt_mod.load_meta(manager.directory, step)
        self._check_meta(meta, mode, **expected)
        snap = ckpt_mod.restore(manager.directory, step, target,
                                device=self.device)
        return step, snap, meta

    @staticmethod
    def _check_meta(meta: dict, mode: str, **expected) -> None:
        if meta.get("mode") != mode:
            raise ValueError(f"checkpoint was written by a "
                             f"{meta.get('mode')!r}-mode run, cannot "
                             f"resume in {mode!r} mode")
        for k, want in expected.items():
            # An absent key is as much a topology mismatch as a wrong
            # value: .get(k, want) would silently accept a checkpoint
            # written before the field existed.
            if k not in meta:
                raise ValueError(f"checkpoint meta has no {k!r} field "
                                 f"(expected {k}={want}); it was written "
                                 f"by an incompatible service version")
            if meta[k] != want:
                raise ValueError(f"checkpoint {k}={meta[k]} does not match "
                                 f"this service's {k}={want}")

    # --- strict synchronous mode -------------------------------------- #

    def _run_sync(self, key: torch.Tensor, n_steps: int,
                  manager: ckpt_mod.CheckpointManager | None,
                  tel: _RunTelemetry) -> RunResult:
        cfg, rb = self.cfg, self.dqn.replay
        start = 0
        state = None
        marks = None       # replay watermarks of the last on-disk save
        if manager is not None:
            step, snap, meta = self._restore(manager, self._sync_target(),
                                             "sync", n_steps=n_steps)
            if step is not None:
                key = torch.from_numpy(snap["key_data"].astype(np.int64))
                state = snap["state"]
                state = state._replace(
                    buffer=rck.from_dense_view(rb, state.buffer))
                start = int(meta["step"])
                # The restored state IS the manager's latest checkpoint,
                # so the next save can be a delta against it.
                marks = rck.replay_marks(state.buffer)
        if state is None:
            state = self.dqn.init(key)
        # The trainer's step-key derivation.
        keys = prng.split(prng.fold_in(key, 1), n_steps)
        key_data = self._key_data(key)
        returns = []
        preempted_at = None
        prev_save_t = start
        t0 = time.perf_counter()
        t_first_learn = None
        t_end = start
        for t in range(start, n_steps):
            if t == max(cfg.learn_start, start):
                _synchronize(self.device)
                t_first_learn = time.perf_counter()
            state, m = self._agent_step(state, keys[t])
            returns.append(m["return_mean"])
            t_end = t + 1
            if manager is not None and (manager.should_save(t + 1)
                                        or t + 1 == n_steps):
                dirty = (self._sync_dirty(state, marks, prev_save_t, t + 1)
                         if marks is not None else None)
                # Sync saves block the loop, so the whole save IS the
                # pipeline pause: the same instrument the async capture
                # uses (one schema).
                t_save = time.perf_counter()
                manager.save(t + 1,
                             {"key_data": key_data,
                              "state": state._replace(
                                  buffer=rck.dense_view(rb, state.buffer))},
                             meta={"mode": "sync", "step": t + 1,
                                   "n_steps": n_steps},
                             dirty=dirty)
                tel.snap_pause.observe(
                    (time.perf_counter() - t_save) * 1e6)
                tel.event("checkpoint", step=t + 1,
                          delta=dirty is not None)
                marks = rck.replay_marks(state.buffer)
                prev_save_t = t + 1
                if manager.preempted and t + 1 < n_steps:
                    preempted_at = t + 1
                    break
        _synchronize(self.device)
        wall_end = time.perf_counter()
        learner_steps = sum(
            1 for t in range(start, t_end)
            if t >= cfg.learn_start and t % cfg.train_every == 0)
        learn_wall = (wall_end - t_first_learn if t_first_learn is not None
                      else float("nan"))
        curve = (torch.stack(returns).cpu().numpy() if returns
                 else np.zeros(0))
        snap = tel.diff()
        pause = _hstats(snap, "snapshot_pause_us")
        metrics = {
            "mode": "sync",
            "learner_steps": learner_steps,
            "learner_steps_per_sec": (learner_steps / learn_wall
                                      if learner_steps else 0.0),
            "wall_time": wall_end - t0,
            "frames": (t_end - start) * cfg.num_envs,
            "frames_per_sec": ((t_end - start) * cfg.num_envs
                               / max(wall_end - t0, 1e-9)),
            "return_mean": float(curve[-1]) if len(curve) else 0.0,
            "return_curve": curve,
            # beta the last executed step's draw used (annealed).
            "beta": float(self.dqn.beta_at(max(t_end - 1, 0))),
            # Sync draws apply feedback inline: staleness is zero by
            # construction; the keys exist so both modes share a schema.
            "staleness": {"count": 0, "mean": 0.0, "max": 0,
                          "p50": 0, "p95": 0, "p99": 0},
            "queue_depth": {"work_mean": 0.0, "batch_mean": 0.0},
            "resumed_from": start if start else None,
            "preempted_at": preempted_at,
            # Every sync save blocks the loop, so count == saved and the
            # pause histogram holds whole save latencies.
            "snapshot": {
                "count": pause["count"],
                "saved": pause["count"],
                "pause_us_mean": pause["mean"],
                "pause_us_max": pause["max"],
                "drain_cycles": 0,
            },
            "checkpoint": self._checkpoint_metrics(snap, manager),
        }
        return RunResult(params=state.params,
                         target_params=state.target_params,
                         buffer=state.buffer, metrics=metrics)

    @staticmethod
    def _checkpoint_metrics(snap: obs.Snapshot, manager) -> dict:
        """Checkpoint overhead view shared by both modes (zeros when the
        run had no manager)."""
        save = _hstats(snap, "span_checkpoint_save_ms")
        return {
            "saves": save["count"],
            "save_ms_mean": save["mean"],
            "save_ms_max": save["max"],
            "full_bytes": _cval(snap, "checkpoint_full_bytes"),
            "delta_bytes": _cval(snap, "checkpoint_delta_bytes"),
            "chain_len": (manager._chain_len if manager is not None else 0),
        }

    def _sync_dirty(self, state, marks: dict, t0: int, t1: int):
        """Dirty tree for the sync snapshot covering steps ``[t0, t1)``.

        Step t learns iff ``t >= learn_start and t % train_every == 0``
        and target-syncs iff ``t % target_sync == 0``, so whether params,
        moments, target and priority tables changed in the window is
        decided on the host without reading a tensor.  Storage and write
        stamps are dirty exactly on the window's ring arc; priority
        tables on the arc when no step learned, whole otherwise.
        Everything small (counters, env state) is always saved.
        """
        cfg = self.cfg
        learned = any(t >= cfg.learn_start and t % cfg.train_every == 0
                      for t in range(t0, t1))
        synced = any(t % cfg.target_sync == 0 for t in range(t0, t1))
        tpl = self._sync_dirty_tpl.get((learned, synced))
        if tpl is None:
            tpl = ckpt_mod.dirty_like(state, True)._replace(
                params=ckpt_mod.dirty_like(state.params, learned),
                target_params=ckpt_mod.dirty_like(state.target_params,
                                                  synced),
                opt_m=ckpt_mod.dirty_like(state.opt_m, learned),
                opt_v=ckpt_mod.dirty_like(state.opt_v, learned))
            self._sync_dirty_tpl[(learned, synced)] = tpl
        bd = rck.replay_dirty(self.dqn.replay, state.buffer, marks)
        if learned:
            bd = bd._replace(sampler_state=ckpt_mod.dirty_like(
                bd.sampler_state, True))
        return {"key_data": True, "state": tpl._replace(buffer=bd)}

    # --- asynchronous mode -------------------------------------------- #

    def _run_async(self, key: torch.Tensor, n_steps: int,
                   manager: ckpt_mod.CheckpointManager | None,
                   tel: _RunTelemetry) -> RunResult:
        cfg, dev, rb = self.cfg, self.device, self.dqn.replay
        start_steps, prefetch_draw, frames0, blocks0 = 0, 0, 0, 0
        actor_resume = None
        snap = None
        resume_marks = None
        # The caller's thread is the learner's: its stream makes (or
        # restores) the starting state, and one event marks it for every
        # stage that reads it.
        learn_stream = stage_stream(dev)
        with on_stream(learn_stream):
            if manager is not None:
                step, snap, meta = self._restore(
                    manager, self._async_target(), "async",
                    num_actors=self.num_actors)
                if step is not None:
                    key = torch.from_numpy(snap["key_data"].astype(np.int64))
                    start_steps = int(meta["learner_steps"])
                    prefetch_draw = int(meta["prefetch_draw"])
                    frames0 = int(meta["frames"])
                    blocks0 = int(meta["blocks"])
            if snap is not None:
                params0, target0 = snap["params"], snap["target_params"]
                opt_m0, opt_v0 = snap["opt_m"], snap["opt_v"]
                self._bstate = rck.from_dense_view(rb, snap["buffer"])
                # The restored buffer IS the manager's latest on-disk
                # state: the first snapshot of this run can be a delta
                # against it.  fb_applied is 0 in THIS run's counter
                # space (fresh log).
                resume_marks = {**rck.replay_marks(self._bstate),
                                "fb_applied": 0}
            else:
                state0 = self.dqn.init(key)
                params0, target0 = state0.params, state0.target_params
                opt_m0, opt_v0 = state0.opt_m, state0.opt_v
                self._bstate = state0.buffer      # canonical replay state
            ready = mark(learn_stream)
        if snap is not None:
            actor_resume = [
                {**a, "step": meta["actor_steps"][i],
                 "chunk": meta["actor_chunks"][i], "event": ready}
                for i, a in enumerate(snap["actors"])]
        self._guard = StateGuard()
        self._guard.event = ready
        self._replay_stream = stage_stream(dev)
        # Actors read (params, event); the learner swaps the pair whole.
        params_box = [(params0, ready)]
        work_q: queue.Queue = tracked_queue("runtime.work_q", self.queue_size)
        batch_q: queue.Queue = tracked_queue(
            "runtime.batch_q", self.prefetch_depth)
        stop = threading.Event()
        self._fb_rows = collections.deque() if manager is not None else None
        # The rec dict is the CONTROL PLANE: counters the COW snapshot
        # consistency contract and the replay-ratio budget read (the
        # state-before-counter ordering in _replay_loop depends on them
        # staying plain same-thread ints).  Pure observability aggregates
        # live in the telemetry registry's lock-free instruments.
        rec = {"frames": 0, "blocks": 0,
               "fb_enqueued": 0, "fb_applied": 0,
               "feedback_seqs": [] if self.feedback_log else None,
               "returns": collections.deque(maxlen=256), "error": None}

        def feedback_put(fb):
            ok = put_with_stop(work_q, ("feedback", fb), stop)
            if ok:
                rec["fb_enqueued"] += 1
                tel.fb_enqueued.add()
            return ok

        last_saved = [start_steps]
        snapper: _CowSnapshotter | None = None

        def on_slab(params, target_params, opt_m, opt_v):
            """Checkpoint hook, on the learner (caller) thread: the
            snapshotter only clones the buffer and grabs references here;
            the serialization runs on its own thread.  Returns True to
            stop the learner early (preemption)."""
            if manager is None:
                return False
            steps = learner.steps_done
            preempt = manager.preempted
            due = steps - last_saved[0] >= manager.save_interval
            if not (preempt or due):
                return False
            if steps != last_saved[0] and snapper.capture(
                    steps, params, target_params, opt_m, opt_v):
                last_saved[0] = steps
            return preempt and steps < n_steps

        learner = Learner(
            self._learn, in_q=batch_q, feedback_put=feedback_put,
            publish=lambda p, ev: params_box.__setitem__(0, (p, ev)),
            target_sync=cfg.target_sync, stop=stop, stream=learn_stream,
            start_steps=start_steps, on_slab=on_slab)
        replay_thread = threading.Thread(
            target=self._replay_loop, name="replay-core",
            args=(work_q, batch_q, stop, learner, rec, tel), daemon=True)
        budget_fn = None
        if self.max_replay_ratio is not None:
            ratio, head = self.max_replay_ratio, self.min_size

            def budget_fn():
                return (frames0 + rec["frames"]
                        < head + ratio * max(learner.steps_done, 1))

        # No PauseGate: snapshots are copy-on-write, nothing ever parks.
        pool = ActorPool(
            self.dqn, self._rollout, num_actors=self.num_actors,
            params_fn=lambda: params_box[0], out_q=work_q, stop=stop,
            base_key=key, chunk_len=self.chunk_len, budget_fn=budget_fn,
            resume_states=actor_resume)
        prefetch = PrefetchPipeline(
            self._sample,
            state_fn=lambda: (self._bstate, learner.steps_done),
            out_q=batch_q, stop=stop, base_key=key, slab=self.slab,
            min_size=self.min_size, guard=self._guard, device=dev,
            beta_fn=self.dqn.beta_at,
            start_draw=prefetch_draw, start_seq=start_steps,
            probe=tel.probe_hook(rb.sampler, cfg.batch * self.slab),
            probe_every=tel.spec.probe_every)
        if manager is not None:
            snapper = _CowSnapshotter(self, manager, pool, prefetch, key,
                                      rec, frames0, blocks0,
                                      learn_stream=learn_stream,
                                      resume_marks=resume_marks, tel=tel)

        def shutdown():
            stop.set()
            pool.join(timeout=10.0)
            prefetch.join(timeout=10.0)
            replay_thread.join(timeout=10.0)
            if snapper is not None:
                snapper.drain()  # finish any in-flight snapshot write
            _synchronize(dev)

        def raise_worker_errors():
            if rec["error"] is not None:
                raise RuntimeError("replay thread failed") from rec["error"]
            if prefetch.error is not None:
                raise RuntimeError(
                    "prefetch pipeline failed") from prefetch.error
            if snapper is not None and snapper.error is not None:
                raise RuntimeError(
                    "snapshot writer failed") from snapper.error
            pool.raise_errors()

        t0 = time.perf_counter()
        replay_thread.start()
        pool.start()
        prefetch.start()
        try:
            params, target_params = learner.run(
                params0, target0, opt_m0, opt_v0, n_steps)
            _synchronize(dev)
            t_end = time.perf_counter()
        except BaseException:
            # Join first, then surface the root cause: a learner failure
            # is often secondary to a worker-thread fault, and raising
            # from it here chains both tracebacks.
            shutdown()
            raise_worker_errors()
            raise
        shutdown()
        raise_worker_errors()
        preempted_at = None
        if manager is not None:
            if manager.preempted and learner.steps_done < n_steps:
                preempted_at = learner.steps_done
            if learner.steps_done != last_saved[0]:
                # Final checkpoint: the threads are joined, the replay
                # thread drained every queue before exiting and the card
                # is synchronized, so the state is quiescent.
                run_states = pool.run_states()
                manager.save(
                    int(learner.steps_done),
                    self._snapshot_tree(key, params, target_params,
                                        learner.opt_m, learner.opt_v,
                                        self._bstate, run_states),
                    meta=self._snapshot_meta(learner.steps_done, prefetch,
                                             rec, frames0, blocks0,
                                             run_states))

        learn_wall = (t_end - learner.first_step_time
                      if learner.first_step_time else float("nan"))
        wall = t_end - t0
        returns = np.asarray(rec["returns"])
        snap = tel.diff()
        stale = _hstats(snap, "staleness_steps")
        workd = _hstats(snap, "work_queue_depth")
        batchd = _hstats(snap, "batch_queue_depth")
        pause = _hstats(snap, "snapshot_pause_us")
        metrics = {
            "mode": "async",
            "learner_steps": learner.steps_done - start_steps,
            "total_learner_steps": learner.steps_done,
            "learner_steps_per_sec": (
                (learner.steps_done - start_steps) / learn_wall
                if learner.steps_done > start_steps else 0.0),
            "wall_time": wall,
            "frames": rec["frames"],
            "total_frames": frames0 + rec["frames"],
            "frames_per_sec": rec["frames"] / max(wall, 1e-9),
            "blocks": rec["blocks"],
            "return_mean": (float(returns[-64:].mean())
                            if returns.size else 0.0),
            "recent_returns": returns[-64:],
            # beta of the prefetcher's latest draw (annealed), else the
            # schedule at the last executed learner step.
            "beta": (prefetch.last_beta if prefetch.last_beta is not None
                     else float(self.dqn.beta_at(
                         max(learner.steps_done - 1, 0)))),
            "feedback_seqs": rec["feedback_seqs"],
            # A view over the registry's staleness histogram: count, sum
            # and max exact, percentiles exact for staleness <= 64.
            "staleness": {
                "count": stale["count"],
                "mean": stale["mean"],
                "max": int(stale["max"]),
                "p50": int(stale["p50"]),
                "p95": int(stale["p95"]),
                "p99": int(stale["p99"]),
            },
            "queue_depth": {
                "work_mean": workd["mean"],
                "batch_mean": batchd["mean"],
            },
            "losses": [float(l) for l in learner.losses],
            "resumed_from": start_steps if start_steps else None,
            "preempted_at": preempted_at,
            # COW snapshot accounting: "pause" is the learner-thread
            # capture cost (the clone's enqueue, its lock wait and the
            # reference grabs).  drain_cycles counts pause->drain quiesce
            # protocols: structurally zero, kept as the reference's
            # column.
            "snapshot": {
                "count": pause["count"],
                "saved": snapper.saved if snapper is not None else 0,
                "pause_us_mean": pause["mean"],
                "pause_us_max": pause["max"],
                "drain_cycles": 0,
            },
            "checkpoint": self._checkpoint_metrics(snap, manager),
        }
        if tel.health is not None:
            metrics["health"] = {
                "kl_nats": tel.health.monitor.kl(),
                "chi2": tel.health.monitor.chi_square(),
                "csp_occupancy": _cval(snap, "csp_occupancy"),
                "fallback_draws": _cval(snap, "fallback_draws"),
                "probe_draws": _cval(snap, "probe_draws"),
            }
        return RunResult(params=params, target_params=target_params,
                         buffer=self._bstate, metrics=metrics)

    # --- snapshot protocol -------------------------------------------- #

    def _snapshot_tree(self, key, params, target_params, opt_m, opt_v,
                       bstate, run_states) -> dict:
        """The async checkpoint tree, the buffer in its saved form."""
        return {"key_data": self._key_data(key),
                "params": params, "target_params": target_params,
                "opt_m": opt_m, "opt_v": opt_v,
                "buffer": rck.dense_view(self.dqn.replay, bstate),
                "actors": [{"env_state": rs["env_state"], "obs": rs["obs"],
                            "ep_ret": rs["ep_ret"], "nstep": rs["nstep"]}
                           for rs in run_states]}

    def _snapshot_meta(self, steps, prefetch, rec, frames0, blocks0,
                       run_states) -> dict:
        return {"mode": "async", "learner_steps": int(steps),
                "num_actors": self.num_actors,
                "prefetch_draw": int(prefetch.draws),
                "frames": int(frames0 + rec["frames"]),
                "blocks": int(blocks0 + rec["blocks"]),
                "actor_steps": [int(rs["step"]) for rs in run_states],
                "actor_chunks": [int(rs["chunk"]) for rs in run_states]}

    def _async_dirty(self, bstate, snap: dict, marks: dict, rows):
        """Dirty tree for an async snapshot relative to ``marks``: the
        buffer's exact ring-arc + touched-priority-row set; every other
        component (params, moments, actor states, the key) changes every
        slab or is tiny, so it is always saved whole."""
        bd = rck.replay_dirty(self.dqn.replay, bstate, marks,
                              priority_rows=rows)
        return {k: (bd if k == "buffer" else ckpt_mod.dirty_like(v, True))
                for k, v in snap.items()}

    def _replay_loop(self, work_q: queue.Queue, batch_q: queue.Queue,
                     stop: threading.Event, learner: Learner,
                     rec: dict, tel: _RunTelemetry) -> None:
        """The one writer of the canonical replay state: applies transition
        blocks and deferred priority feedback in arrival order, each as
        one guarded operation on the replay stream.  The new state is
        published (``self._bstate``) inside the guard, BEFORE the applied
        counters move, so "counters say applied" implies the state a
        snapshot clones already holds the counted item."""
        stream = self._replay_stream
        guard = self._guard
        try:
            with on_stream(stream):
                while True:
                    try:
                        tag, item = work_q.get(timeout=0.05)
                    except queue.Empty:
                        if (stop.is_set() and learner.finished
                                and work_q.empty()):
                            return
                        continue
                    if tag == "block":
                        if item.transitions is not None:  # None: all rows
                            with guard.use(stream):       # in the warm-up
                                accept(stream, item.event, item.transitions,
                                       self._bstate)
                                with obs.span("add_block"):
                                    self._bstate = self._add_block(
                                        self._bstate, item.transitions)
                        rec["frames"] += item.frames
                        rec["blocks"] += 1
                        tel.frames.add(item.frames)
                        tel.blocks.add()
                        rec["returns"].extend(item.completed_returns.tolist())
                    else:  # deferred priority feedback (one slab)
                        fb: Feedback = item
                        with guard.use(stream):
                            accept(stream, fb.event, fb.idx, fb.td, fb.stamp,
                                   self._bstate)
                            if self._fb_rows is not None:
                                # Dirty-row log for incremental snapshots,
                                # appended BEFORE the apply, so any feedback
                                # a captured state holds has its rows in
                                # the log: the dirty set is a superset.
                                # Stale (stamp-dropped) rows are logged too;
                                # they only re-write identical bytes.
                                self._fb_rows.append(
                                    (rec["fb_applied"],
                                     fb.idx.cpu().numpy().ravel()))
                            with obs.span("apply_feedback"):
                                self._bstate = self._apply_feedback(
                                    self._bstate, fb.idx, fb.td, fb.stamp)
                        s = int(fb.idx.shape[0])
                        if rec["feedback_seqs"] is not None:
                            rec["feedback_seqs"].extend(
                                range(fb.seq0, fb.seq0 + s))
                        # The slab's S batches share one staleness value.
                        tel.staleness.observe_n(
                            learner.steps_done - fb.version, s)
                        rec["fb_applied"] += 1
                        tel.fb_applied.add()
                    tel.work_depth.observe(work_q.qsize())
                    tel.batch_depth.observe(batch_q.qsize())
        except BaseException as e:
            rec["error"] = e
            stop.set()


class _CowSnapshotter:
    """Copy-on-write checkpoint writer for the async runtime.

    The learner-thread half (:meth:`capture`) clones the buffer under the
    replay-state guard on the replay stream and grabs the params, moments
    and actor states by reference with their events; a worker thread,
    under its own stream, waits on those events and serializes while
    actors, prefetcher, learner and replay thread keep running.

    Consistency contract:

    * **state ⊇ counters.**  Capture reads the applied-feedback counter
      BEFORE it clones the state, and the replay thread publishes the
      state BEFORE bumping the counter, so the dirty rows computed from
      the previous save's watermark are a superset of what changed
      between the two saves; a superset only re-writes identical bytes.
    * **in-flight work is absent, not torn.**  Blocks and feedback slabs
      still queued at capture are not in the snapshot.  On resume the
      stamped exactly-once feedback contract makes the missing applies
      safe: priorities are one slab staler.
    * **one save in flight.**  ``capture`` skips (returns False) while the
      worker is still writing, so the manager's chain bookkeeping and the
      row-log pruning are strictly serialized.
    """

    def __init__(self, service: ReplayService, manager, pool, prefetch,
                 key, rec: dict, frames0: int, blocks0: int, *,
                 learn_stream=None, resume_marks: dict | None = None,
                 tel: _RunTelemetry | None = None):
        self._svc = service
        self._manager = manager
        self._pool = pool
        self._prefetch = prefetch
        self._key = key
        self._rec = rec
        self._tel = tel
        self._frames0 = frames0
        self._blocks0 = blocks0
        self._learn_stream = learn_stream
        self._stream = stage_stream(service.device)
        # Watermarks of the last successful on-disk save (None -> the
        # next save is full).  Only the worker thread writes this after
        # construction.
        self.marks = resume_marks
        self.saved = 0
        self.error: BaseException | None = None
        self._busy = threading.Event()
        self._q: queue.Queue = tracked_queue("runtime.snapshot_q", 1)
        self._thread = threading.Thread(target=self._worker,
                                        name="replay-snapshot", daemon=True)
        self._thread.start()

    def capture(self, steps, params, target_params, opt_m, opt_v) -> bool:
        """Learner-thread half: the buffer's device clone enqueued under
        the guard, references and host counters grabbed; no device sync.
        The dirty set and the checkpoint's host copies are the worker's.
        False = skipped (previous snapshot still writing, an error is
        pending, or an actor has not published its first run state)."""
        if self.error is not None or self._busy.is_set():
            return False
        run_states = self._pool.run_states()
        if any(rs is None for rs in run_states):
            return False
        t0 = time.perf_counter()
        svc = self._svc
        a_now = self._rec["fb_applied"]   # read BEFORE the state clone
        events = [mark(self._learn_stream)]   # the params and moments
        stream = svc._replay_stream
        with svc._guard.use(stream) as op:
            accept(stream, None, svc._bstate)
            bstate = clone(svc._bstate)
        events += [op.event] + [rs["event"] for rs in run_states]
        trees = {"params": params, "target_params": target_params,
                 "opt_m": opt_m, "opt_v": opt_v, "buffer": bstate,
                 "run_states": run_states}
        meta = svc._snapshot_meta(steps, self._prefetch, self._rec,
                                  self._frames0, self._blocks0, run_states)
        # Pause accounting covers the capture itself; the worker's
        # overlapped serialization shows in the wall time, not here.
        pause_us = (time.perf_counter() - t0) * 1e6
        if self._tel is not None:
            self._tel.snap_pause.observe(pause_us)
        self._busy.set()
        self._q.put((int(steps), trees, meta, a_now, events))
        return True

    def _worker(self) -> None:
        with on_stream(self._stream):
            while True:
                job = self._q.get()
                if job is None:
                    return
                steps, trees, meta, a_now, events = job
                try:
                    self._write(steps, trees, meta, a_now, events)
                except BaseException as e:
                    self.error = e   # surfaced by raise_worker_errors
                finally:
                    self._busy.clear()

    def _write(self, steps, trees, meta, a_now, events) -> None:
        svc = self._svc
        for event in events:
            accept(self._stream, event)
        accept(self._stream, None, trees)
        bstate = trees["buffer"]
        snap = svc._snapshot_tree(self._key, trees["params"],
                                  trees["target_params"], trees["opt_m"],
                                  trees["opt_v"], bstate,
                                  trees["run_states"])
        dirty = None
        if self.marks is not None:
            # Reading the row log here (after capture) can only see MORE
            # entries than existed at capture: extra rows widen the dirty
            # set, which is always safe.
            a_base = self.marks["fb_applied"]
            rows = [r for seq, arr in list(svc._fb_rows)
                    if seq >= a_base for r in arr]
            dirty = svc._async_dirty(bstate, snap, self.marks, rows)
        next_marks = {**rck.replay_marks(bstate), "fb_applied": a_now}
        self._manager.save(steps, snap, meta=meta, dirty=dirty)
        self.marks = next_marks
        self.saved += 1
        if self._tel is not None:
            self._tel.event("checkpoint", step=steps,
                            delta=dirty is not None)
        # Entries older than the new watermark can never be dirty again:
        # prune (popleft racing the replay thread's append is deque-safe).
        log = svc._fb_rows
        while log and log[0][0] < next_marks["fb_applied"]:
            log.popleft()

    def drain(self, timeout: float = 120.0) -> None:
        """Wait out any in-flight save, then stop the worker thread.
        After this returns the manager is safe to use from the caller
        (the final quiescent save)."""
        deadline = time.monotonic() + timeout
        while self._busy.is_set() and time.monotonic() < deadline:
            time.sleep(0.002)
        try:
            self._q.put_nowait(None)
        except queue.Full:
            pass
        self._thread.join(timeout=10.0)
