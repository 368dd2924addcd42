"""Host-thread actor pool driving ``VectorEnv`` rollout chunks.

Counterpart of ``repro/runtime/actor.py``.  Each actor owns an
independent ``VectorEnv`` state (its own reset key, its own episode
accounting and n-step window) and repeatedly runs one rollout chunk
(``chunk_len`` vectorized epsilon-greedy steps of the DQN's ``act``) on
its own CUDA stream, then enqueues the ``[chunk_len, num_envs]``
transition block for the replay service with an event recorded after
the chunk (:mod:`repro_torch.runtime.streams`).

The reference runs the chunk as one jitted ``lax.scan``, and XLA
releases the GIL during the dispatch, which its overlap rests on.  Here
the chunk is a Python loop of eager calls, which hold the GIL while they
dispatch, so how far actors overlap the learner is measured, not
assumed.  The completed episode returns come to the host once a chunk,
as in the reference; the n-step window says on the host which rows are
valid, so the warm-up trim needs no device sync.

Exploration schedule: each actor drives ``eps`` with its *local* step
counter, so with A actors the schedule advances per actor-iteration
rather than per global frame, the per-worker schedule of distributed
DQN variants.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.analysis.locks import make_condition
from repro_torch.obs import span
from repro_torch.prng import fold_in
from repro_torch.runtime import prng
from repro_torch.runtime.streams import accept, mark, on_stream, stage_stream


class TransitionBlock(NamedTuple):
    """One rollout chunk handed from an actor to the replay service.

    With n-step replay the rows are already aggregated by the actor's own
    :class:`~repro_torch.core.replay_buffer.NStepAccumulator`; the
    leading dim is then the number of *emitted* rows: ``chunk_len`` once
    warm, fewer for the chunk that spans the warm-up, and
    ``transitions`` is None when the whole chunk fell inside it.
    ``frames`` always counts raw env frames.
    """

    transitions: Any            # dict, leaves [emitted, num_envs, ...]
    frames: int                 # chunk_len * num_envs
    actor_id: int
    chunk_id: int
    completed_returns: np.ndarray  # episodes that finished in this chunk
    event: Any = None           # recorded on the actor's stream after it


def put_with_stop(q: queue.Queue, item, stop: threading.Event,
                  timeout: float = 0.05) -> bool:
    """Blocking put that aborts (returns False) once ``stop`` is set."""
    while not stop.is_set():
        try:
            q.put(item, timeout=timeout)
            return True
        except queue.Full:
            continue
    return False


class PauseGate:
    """Cooperative quiesce point for the pipeline threads (optional).

    An orchestrator calls :meth:`pause`; each worker parks at its next
    :meth:`wait_if_paused` (registering itself, so :meth:`wait_parked`
    can await full quiescence) until :meth:`resume`.  Parking happens
    only at loop boundaries, after a worker's in-flight put completed.
    The service's snapshots are copy-on-write and never use it; it stays
    as a general quiesce utility (e.g. debugging a live pipeline).
    """

    def __init__(self):
        self._cond = make_condition("runtime.pause_gate")
        self._paused = False
        self._parked = 0

    @property
    def paused(self) -> bool:
        return self._paused

    def pause(self) -> None:
        with self._cond:
            self._paused = True

    def resume(self) -> None:
        with self._cond:
            self._paused = False
            self._cond.notify_all()

    def wait_if_paused(self, stop: threading.Event) -> None:
        """Worker side: park here while the gate is paused."""
        if not self._paused:
            return
        with self._cond:
            self._parked += 1
            self._cond.notify_all()
            try:
                while self._paused and not stop.is_set():
                    self._cond.wait(timeout=0.05)
            finally:
                self._parked -= 1
                self._cond.notify_all()

    def wait_parked(self, n: int, stop: threading.Event,
                    timeout: float = 60.0) -> bool:
        """Orchestrator side: block until ``n`` workers are parked."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while self._parked < n:
                if stop.is_set() or time.monotonic() > deadline:
                    return False
                self._cond.wait(timeout=0.05)
        return True


def make_rollout(dqn, chunk_len: int) -> Callable:
    """The chunk function
    ``(params, env_state, obs, step0, ep_ret, nstep, key) ->
    (env_state, obs, ep_ret, nstep, transitions, valid, finished)``.

    ``transitions`` leaves lead with ``[emitted, num_envs]``: the rows
    of the steps whose ``valid`` is True (all of them for 1-step; for
    n-step a warm-up prefix is invalid, since envs run in lockstep), or
    None when none is.  ``valid`` is a host list of ``chunk_len`` bools
    and ``finished`` is ``float32[chunk_len, num_envs]`` holding
    completed episode returns (NaN where no episode ended).  ``nstep``
    threads the actor's own window (None when ``cfg.n_step == 1``).
    Step ``i`` of the chunk acts on ``fold_in(key, i)``, as the
    reference's scan body."""
    act = dqn.act
    acc = dqn.replay.accumulator   # None for n_step == 1

    def rollout(params, env_state, obs, step0: int, ep_ret, nstep, key):
        rows, valid, finished = [], [], []
        for i in range(chunk_len):
            env_state, obs, tr = act(params, env_state, obs, step0 + i,
                                     fold_in(key, i))
            ret = ep_ret + tr["reward"]
            done = tr["done"] > 0.5
            finished.append(torch.where(done, ret,
                                        torch.full_like(ret, float("nan"))))
            ep_ret = torch.where(done, torch.zeros_like(ret), ret)
            if acc is not None:
                nstep, out, ok = acc.push(nstep, tr)
            else:
                out, ok = tr, True
            valid.append(bool(ok))
            if ok:
                rows.append(out)
        transitions = ({k: torch.stack([r[k] for r in rows])
                        for k in rows[0]} if rows else None)
        return (env_state, obs, ep_ret, nstep, transitions, valid,
                torch.stack(finished))

    return rollout


class Actor(threading.Thread):
    """One host thread: params snapshot -> rollout chunk -> block queue.

    ``params_fn()`` returns the latest published ``(params, event)``; the
    actor's stream waits on the event before the chunk reads them.
    """

    def __init__(self, actor_id: int, dqn, rollout: Callable,
                 params_fn: Callable[[], Any], out_q: queue.Queue,
                 stop: threading.Event, base_key: torch.Tensor,
                 chunk_len: int, budget_fn: Callable[[], bool] | None = None,
                 gate: PauseGate | None = None,
                 resume_state: dict | None = None):
        super().__init__(name=f"replay-actor-{actor_id}", daemon=True)
        self.actor_id = actor_id
        self._dqn = dqn
        self._rollout = rollout
        self._params_fn = params_fn
        self._out_q = out_q
        self._stop_evt = stop
        self._base_key = base_key
        self._chunk_len = chunk_len
        self._budget_fn = budget_fn
        self._gate = gate
        self._resume_state = resume_state
        self._stream = stage_stream(dqn.venv.device)
        self.chunks_done = (0 if resume_state is None
                            else int(resume_state["chunk"]))
        self.error: BaseException | None = None
        # Exact-resume snapshot slot: REPLACED (never mutated) with a
        # fresh dict after every completed chunk's enqueue, so the COW
        # snapshotter can capture it from another thread without parking
        # this actor.  Its tensors are never written in place after (the
        # env step, the window push and the return bookkeeping all make
        # new tensors), and its ``event`` marks the work that made them.
        # The PRNG stream is captured by the two integers: chunk c's key
        # is fold_in(roll_key, c) and never depends on wall history.
        self.run_state: dict | None = None

    def run(self) -> None:
        try:
            with on_stream(self._stream):
                self._loop()
        except BaseException as e:  # surfaced by the service after join
            self.error = e
            self._stop_evt.set()

    def _publish_run_state(self, env_state, obs, ep_ret, nstep, step, chunk):
        self.run_state = {"env_state": env_state, "obs": obs,
                          "ep_ret": ep_ret, "nstep": nstep,
                          "step": step, "chunk": chunk,
                          "event": mark(self._stream)}

    def _loop(self) -> None:
        dqn, chunk_len = self._dqn, self._chunk_len
        k_reset, k_roll = prng.actor_keys(self._base_key, self.actor_id)
        if self._resume_state is None:
            env_state = dqn.venv.reset(k_reset)
            obs = dqn.init_obs(env_state)  # raw obs, or seeded frame stack
            ep_ret = torch.zeros(dqn.cfg.num_envs, device=dqn.venv.device)
            # This actor's own n-step window (None for n_step == 1): an
            # independent env stream must not share the buffer's.
            nstep = dqn.replay.nstep_init(dqn.example_transition)
            step, chunk = 0, 0
        else:
            # Exact continuation: env state, episode accounting, the
            # n-step window and the PRNG stream position (chunk counter)
            # come from the snapshot, restored on the service's stream.
            rs = self._resume_state
            env_state, obs, ep_ret = rs["env_state"], rs["obs"], rs["ep_ret"]
            nstep = rs.get("nstep")
            accept(self._stream, rs.get("event"), env_state, obs, ep_ret,
                   nstep)
            step, chunk = int(rs["step"]), int(rs["chunk"])
        self._publish_run_state(env_state, obs, ep_ret, nstep, step, chunk)
        while not self._stop_evt.is_set():
            if self._gate is not None:
                self._gate.wait_if_paused(self._stop_evt)
            # Replay-ratio throttle: don't burn host cores producing frames
            # the learner can't consume.
            while (self._budget_fn is not None and not self._budget_fn()
                   and not self._stop_evt.is_set()
                   and not (self._gate is not None and self._gate.paused)):
                self._stop_evt.wait(0.002)
            if self._gate is not None and self._gate.paused:
                continue  # park at the loop-top gate before rolling out
            if self._stop_evt.is_set():
                return
            params, p_event = self._params_fn()
            accept(self._stream, p_event, params)
            with span("rollout"):
                (env_state, obs, ep_ret, nstep, transitions, _valid,
                 finished) = self._rollout(
                    params, env_state, obs, step, ep_ret, nstep,
                    prng.chunk_key(k_roll, chunk))
            # The rollout already dropped the warm-up rows; the returns
            # cross to the host once a chunk (a sync on this stream).
            fin = finished.cpu().numpy().ravel()
            block = TransitionBlock(
                transitions=transitions,
                frames=chunk_len * dqn.cfg.num_envs,
                actor_id=self.actor_id, chunk_id=chunk,
                completed_returns=fin[~np.isnan(fin)],
                event=mark(self._stream))
            if not put_with_stop(self._out_q, ("block", block),
                                 self._stop_evt):
                return
            step += chunk_len
            chunk += 1
            self.chunks_done = chunk
            self._publish_run_state(env_state, obs, ep_ret, nstep, step,
                                    chunk)


class ActorPool:
    """A fixed pool of :class:`Actor` threads sharing one block queue."""

    def __init__(self, dqn, rollout: Callable, *, num_actors: int,
                 params_fn: Callable[[], Any], out_q: queue.Queue,
                 stop: threading.Event, base_key: torch.Tensor,
                 chunk_len: int, budget_fn: Callable[[], bool] | None = None,
                 gate: PauseGate | None = None,
                 resume_states: list | None = None):
        self.actors = [
            Actor(i, dqn, rollout, params_fn, out_q, stop, base_key,
                  chunk_len, budget_fn, gate=gate,
                  resume_state=(resume_states[i] if resume_states else None))
            for i in range(num_actors)
        ]

    @property
    def chunks_done(self) -> int:
        return sum(a.chunks_done for a in self.actors)

    def run_states(self) -> list:
        """Per-actor exact-resume snapshots (see ``Actor.run_state``)."""
        return [a.run_state for a in self.actors]

    def start(self) -> None:
        for a in self.actors:
            a.start()

    def join(self, timeout: float | None = None) -> None:
        for a in self.actors:
            a.join(timeout)

    def raise_errors(self) -> None:
        for a in self.actors:
            if a.error is not None:
                raise RuntimeError(
                    f"actor {a.actor_id} failed") from a.error
