"""Experience-replay ring buffer with a pluggable priority sampler.

Counterpart of ``repro/core/replay_buffer.py``, both storage modes: the
flat ring of whole transitions, and the frame-deduplicated pixel store
(:class:`FrameStore`: one uint8 frame a transition, the stacked float
``obs`` / ``next_obs`` and the n-step return materialized at sample
time).  Any registry sampler plugs in, the sharded kinds included: the
buffer reads the priorities only through the sampler's dense
``priorities`` view, and keeps the transitions themselves on the
sampler's (lead) device.

The buffer stores a dict of tensors with a leading capacity dim.  New
transitions enter with the running maximum priority; sampled ones get
their priority rewritten from the fresh TD error.  Every slot carries a
write stamp pair ``(stamp, gen)``: the int32 add counter at its last
write and the count of that counter's signed rollovers, so a deferred
priority update can tell the slot it sampled from a recycled one across
2^64 adds.

Counters that never depend on data (ring position, live size, the add
counter and its generation) are host ints, so writing and sampling never
wait on the device.  The large tensors (storage, stamps, sampler state)
are updated in place: a method returns the state it was given, with new
host counters, and the state passed in must not be used afterwards.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core.per import importance_from_selected
from repro_torch.core.samplers import masked_update
from repro_torch.obs.tracing import span
from repro_torch.xla_float import fma32

_I32 = 2 ** 31


def wrap_i32(x: int) -> int:
    """Python int -> the int32 value with the same low 32 bits."""
    return (x + _I32) % (2 * _I32) - _I32


class NStepState(NamedTuple):
    """Window of the last ``n`` 1-step transitions of one env stream."""

    ring: dict   # leaves [n, num_envs, ...]
    count: int   # pushes so far, saturating at n
    pos: int     # next ring slot (== oldest entry once full)


class NStepAccumulator:
    """n-step transition aggregator (per env stream).

    Once the window holds ``n`` steps, each push also emits the n-step
    transition whose first step is the oldest window entry: the reward is
    the discounted return truncated at the first ``done`` in the window,
    ``next_obs`` the pre-reset observation of that step (or of the newest
    step), ``done`` whether any window step ended, and ``terminated`` 0
    unless a ``done`` falls inside the window, where the learner's fixed
    ``gamma**n`` bootstrap would be at the wrong scale (see the reference
    class for the full argument).
    """

    def __init__(self, n_step: int, gamma: float):
        if n_step < 2:
            raise ValueError(f"NStepAccumulator needs n_step >= 2, got "
                             f"{n_step} (use the buffer directly for 1)")
        self.n = n_step
        self.gamma = gamma

    def init(self, example: dict, num_envs: int, device) -> NStepState:
        ring = {k: torch.zeros((self.n, num_envs) + tuple(v.shape),
                               dtype=v.dtype, device=device)
                for k, v in example.items()}
        return NStepState(ring=ring, count=0, pos=0)

    def push(self, state: NStepState, transitions: dict
             ) -> tuple[NStepState, dict, bool]:
        """-> (state, emitted n-step rows [num_envs, ...], valid)."""
        ring = {k: buf.clone() for k, buf in state.ring.items()}
        for k, x in transitions.items():
            ring[k][state.pos] = x
        pos = (state.pos + 1) % self.n
        count = min(state.count + 1, self.n)
        new = NStepState(ring=ring, count=count, pos=pos)
        order = [(pos + i) % self.n for i in range(self.n)]
        w = {k: buf[order] for k, buf in ring.items()}
        d = w["done"]                                     # [n, E]
        cont = torch.cumprod(1.0 - d, dim=0)
        cont_before = torch.cat([torch.ones_like(cont[:1]), cont[:-1]], 0)
        disc = (self.gamma ** torch.arange(self.n, dtype=torch.float32,
                                           device=d.device))[:, None]
        reward = (disc * cont_before * w["reward"]).sum(0)
        done = 1.0 - cont[-1]
        any_done = (d > 0.5).any(0)
        first_done = (d > 0.5).to(torch.int64).argmax(0)
        horizon = torch.where(any_done, first_done,
                              torch.full_like(first_done, self.n - 1))
        cols = torch.arange(d.shape[1], device=d.device)
        emitted = {"obs": w["obs"][0], "action": w["action"][0],
                   "reward": reward, "next_obs": w["next_obs"][horizon, cols],
                   "done": done}
        if "terminated" in w:
            last = w["terminated"][self.n - 1]
            emitted["terminated"] = torch.where(
                any_done,
                torch.where(first_done == self.n - 1, last,
                            torch.ones_like(last)),
                torch.zeros_like(last))
        return new, emitted, count >= self.n


class FrameStore(NamedTuple):
    """Configuration of the frame-deduplicated pixel storage mode.

    history_len: frames stacked into one observation (the conv head's
      channel dim).
    frame_shape: shape of one stored frame, e.g. ``(H, W)``.
    stride: ring distance between consecutive timesteps of one env (the
      writer's lockstep width, ``num_envs``).
    n_step: n-step return aggregated at sample time (the stored stream
      stays 1-step).
    gamma: discount of the sample-time n-step return.
    scale: uint8 -> float factor; the actor converts its stack with the
      same ``frame.float() * scale``, so materialized stacks equal what
      the policy saw bit for bit.
    """

    history_len: int
    frame_shape: tuple
    stride: int = 1
    n_step: int = 1
    gamma: float = 0.99
    scale: float = 1.0 / 255.0


_FRAME_KEYS = ("frame", "action", "reward", "done")


class ReplayState(NamedTuple):
    storage: dict            # leaves with leading dim = capacity
    sampler_state: Any
    pos: int                 # next write slot
    size: int                # live count
    max_priority: torch.Tensor  # float32 scalar, running max
    write_stamp: torch.Tensor   # int32[capacity], -1 = never written
    total_adds: int          # int32 add counter (wraps; see add_gen)
    write_gen: torch.Tensor  # int32[capacity] rollover generation per slot
    add_gen: int             # rollovers of total_adds so far
    nstep: Any = None        # NStepState when n_step > 1


class ReplayBuffer:
    """Ring buffer + priority sampler.

    Args:
      capacity: number of transitions.
      sampler: a registry sampler; its ``device`` is the buffer's.
      alpha: PER exponent; priorities stored as (|td| + eps)^alpha.
      beta: importance-sampling exponent.
      n_step: store n-step transitions (1 = the classic 1-step buffer);
        ``add_batch`` then takes exactly ``num_envs`` rows per call.
      gamma: discount of the n-step return.
      num_envs: env-stream width the accumulator is sized for.
      frame_store: switch to frame-deduplicated uint8 pixel storage.  It
        needs ``n_step == 1`` here (the n-step return is aggregated at
        sample time from ``FrameStore.n_step``) and a schema holding at
        least ``frame`` (uint8, ``frame_shape``), ``action``, ``reward``
        and ``done``.  Frame chaining needs ring adjacency: the row
        ``stride`` slots before a row is the same env's previous step,
        which stamp differences check at gather time.
    """

    def __init__(self, capacity: int, sampler, alpha: float = 0.6,
                 beta: float = 0.4, eps: float = 1e-2, n_step: int = 1,
                 gamma: float = 0.99, num_envs: int = 1,
                 frame_store: FrameStore | None = None):
        self.capacity = capacity
        self.sampler = sampler
        self.device = sampler.device
        self.alpha = alpha
        self.beta = beta
        self.eps = eps
        self.n_step = n_step
        self.num_envs = num_envs
        self.frame_store = frame_store
        if frame_store is not None:
            if n_step != 1:
                raise ValueError(
                    "frame-store buffers aggregate n-step returns at sample "
                    "time: construct with n_step=1 and set "
                    f"FrameStore(n_step={n_step}) instead")
            if (frame_store.history_len < 1 or frame_store.n_step < 1
                    or frame_store.stride < 1):
                raise ValueError(f"invalid FrameStore config: {frame_store}")
            window = ((frame_store.history_len + frame_store.n_step)
                      * frame_store.stride)
            if window >= capacity:
                raise ValueError(
                    f"capacity {capacity} too small for FrameStore window "
                    f"span {window} (stack + n-step would always cross the "
                    "write head)")
        self.accumulator = (NStepAccumulator(n_step, gamma)
                            if n_step > 1 else None)

    def nstep_init(self, example: dict):
        if self.accumulator is None:
            return None
        return self.accumulator.init(example, self.num_envs, self.device)

    def init(self, example: dict) -> ReplayState:
        """Empty buffer for transitions shaped like ``example`` (a dict of
        per-transition tensors)."""
        if self.frame_store is not None:
            missing = [k for k in _FRAME_KEYS if k not in example]
            if missing:
                raise ValueError(f"frame-store schema missing keys {missing}: "
                                 f"needs at least {list(_FRAME_KEYS)}")
            frame = torch.as_tensor(example["frame"])
            if frame.dtype != torch.uint8:
                raise ValueError(
                    f"frame leaf must be uint8, got {frame.dtype}")
            if tuple(frame.shape) != tuple(self.frame_store.frame_shape):
                raise ValueError(
                    f"frame leaf shape {tuple(frame.shape)} != "
                    f"FrameStore.frame_shape "
                    f"{tuple(self.frame_store.frame_shape)}")
        storage = {k: torch.zeros((self.capacity,) + tuple(v.shape),
                                  dtype=v.dtype, device=self.device)
                   for k, v in example.items()}
        return ReplayState(
            storage=storage, sampler_state=self.sampler.init(), pos=0, size=0,
            max_priority=torch.tensor(1.0, device=self.device),
            write_stamp=torch.full((self.capacity,), -1, dtype=torch.int32,
                                   device=self.device),
            total_adds=0,
            write_gen=torch.zeros(self.capacity, dtype=torch.int32,
                                  device=self.device),
            add_gen=0, nstep=self.nstep_init(example))

    def add(self, state: ReplayState, transition: dict) -> ReplayState:
        """Store one transition at the ring position with max priority."""
        return self.add_batch(
            state, {k: torch.as_tensor(v)[None] for k, v in transition.items()})

    def _write_arc(self, state: ReplayState, transitions: dict) -> ReplayState:
        """Ring-arc write of B final rows at ``(pos + arange(B)) % capacity``."""
        b = next(iter(transitions.values())).shape[0]
        if b > self.capacity:
            raise ValueError(
                f"add_batch of {b} transitions exceeds capacity "
                f"{self.capacity}: ring slots would collide within one write")
        idx = (state.pos + torch.arange(b, device=self.device)) % self.capacity
        for k, x in transitions.items():
            state.storage[k][idx] = x.to(self.device,
                                         state.storage[k].dtype)
        sampler_state = self.sampler.update(
            state.sampler_state, idx, state.max_priority.expand(b))
        # int32 stamps wrap; the generation words count signed rollovers.
        lo = state.total_adds
        stamps = [wrap_i32(lo + i) for i in range(b)]
        row_gen = [wrap_i32(state.add_gen + (s < lo)) for s in stamps]
        new_total = wrap_i32(lo + b)
        state.write_stamp[idx] = torch.tensor(stamps, dtype=torch.int32,
                                              device=self.device)
        state.write_gen[idx] = torch.tensor(row_gen, dtype=torch.int32,
                                            device=self.device)
        return state._replace(
            sampler_state=sampler_state,
            pos=(state.pos + b) % self.capacity,
            size=min(state.size + b, self.capacity),
            total_adds=new_total,
            add_gen=wrap_i32(state.add_gen + (new_total < lo)))

    def add_batch(self, state: ReplayState, transitions: dict) -> ReplayState:
        """Store B transitions (leading dim B) as one contiguous ring arc.

        With ``n_step > 1`` the rows are one lockstep env step (B must be
        ``num_envs``); the accumulator's emitted n-step rows are written
        instead, once its window has warmed up.
        """
        if self.accumulator is None:
            return self._write_arc(state, transitions)
        b = next(iter(transitions.values())).shape[0]
        if b != self.num_envs:
            raise ValueError(
                f"n_step={self.n_step} add_batch expects one vectorized env "
                f"step of num_envs={self.num_envs} rows, got {b} "
                f"(pre-aggregated rows go through add_block(..., "
                f"aggregated=True))")
        nstate, emitted, valid = self.accumulator.push(state.nstep,
                                                       transitions)
        state = state._replace(nstep=nstate)
        return self._write_arc(state, emitted) if valid else state

    def add_block(self, state: ReplayState, block: dict,
                  aggregated: bool = False) -> ReplayState:
        """Store a ``[T, B, ...]`` rollout block in chronological order;
        ``aggregated=True`` marks rows as already n-step."""
        t, b = next(iter(block.values())).shape[:2]
        if self.accumulator is not None and not aggregated:
            for i in range(t):
                state = self.add_batch(state, {k: v[i] for k, v in block.items()})
            return state
        flat = {k: v.reshape((t * b,) + tuple(v.shape[2:]))
                for k, v in block.items()}
        return self._write_arc(state, flat)

    def _stack_frames(self, state: ReplayState, slot0: torch.Tensor,
                      ref: torch.Tensor, base_ok: torch.Tensor
                      ) -> torch.Tensor:
        """``history_len``-stacks ending at ``slot0`` (int64 [B]), float32
        ``[B, *frame_shape, history_len]``, oldest frame first.

        Frame ``j`` sits ``j * stride`` slots back.  Its link holds when
        its stamp is exactly ``j * stride`` adds older than ``ref`` (an
        int32 difference that wraps as the stamps do, so a recycled or
        foreign slot fails), it is a written slot, and it closes no
        episode; a broken link zeroes that frame and every older one, the
        zero padding a float buffer records at episode starts and
        warm-up.  All shapes are static: no host sync.
        """
        fs = self.frame_store
        st, lo = state.storage, state.write_stamp
        back = torch.arange(fs.history_len, device=slot0.device) * fs.stride
        slots = (slot0[:, None] - back) % self.capacity          # [B, K]
        links = ((lo[slots] - ref[:, None] == -back.to(torch.int32))
                 & (slots < state.size) & (st["done"][slots] < 0.5))
        links[:, 0] = base_ok
        ok = links.to(torch.int32).cumprod(1).to(torch.float32)
        mask = ok.reshape(ok.shape + (1,) * len(fs.frame_shape))
        frames = st["frame"][slots].to(torch.float32) * fs.scale * mask
        return frames.flip(1).movedim(1, -1)

    def materialize(self, state: ReplayState, idx: torch.Tensor) -> dict:
        """Frame mode: the float batch a flat buffer would hold at ``idx``.

        For each anchor slot: the stacked ``obs`` ending at its frame, the
        sample-time n-step return, and the stacked ``next_obs`` ending
        ``n_step * stride`` slots later.  A window cut by an episode end,
        the write head or unwritten slots is terminal (``terminated = 1``,
        ``next_obs = 0``): the TD target reduces to the observed return.
        """
        fs = self.frame_store
        st, lo = state.storage, state.write_stamp
        anchor = idx.to(torch.int64) % self.capacity
        ref = lo[anchor]
        written = anchor < state.size
        obs = self._stack_frames(state, anchor, ref, written)
        # The forward arc of the n-step return: step k counts while the
        # window is still in the anchor's episode and backed by in-sequence
        # rows (products of 0/1 flags, exact in any order).
        fwd = torch.arange(fs.n_step, device=anchor.device) * fs.stride
        slots = (anchor[:, None] + fwd) % self.capacity          # [B, N]
        avail = ((lo[slots] - ref[:, None] == fwd.to(torch.int32))
                 & (slots < state.size)).to(torch.float32)
        carry = torch.cumprod(avail * (1.0 - st["done"][slots]), 1)
        carry = written.to(torch.float32)[:, None] * carry     # enter k + 1
        enter = torch.cat([written.to(torch.float32)[:, None],
                           carry[:, :-1]], 1)
        use = enter * avail
        rew = st["reward"][slots]
        # sum_k use_k * gamma^k * r_k in the jitted reference's float32
        # order: XLA drops the add to zero and the multiply by 1 of step 0,
        # and from step 2 on LLVM fuses each multiply-add.
        reward = use[:, 0] * rew[:, 0]
        for k in range(1, fs.n_step):
            term = use[:, k] * float(fs.gamma ** k)
            reward = (reward + term * rew[:, k] if k == 1
                      else fma32(term, rew[:, k], reward))
        boot = (anchor + fs.n_step * fs.stride) % self.capacity
        has_boot = ((carry[:, -1] > 0.5)
                    & (lo[boot] - ref == fs.n_step * fs.stride)
                    & (boot < state.size))
        next_obs = self._stack_frames(state, boot, lo[boot], has_boot)
        term = 1.0 - has_boot.to(torch.float32)
        return {"obs": obs, "action": st["action"][anchor],
                "reward": reward, "next_obs": next_obs,
                "done": term, "terminated": term}

    def sample(self, state: ReplayState, key: torch.Tensor, batch: int,
               beta=None):
        """Returns ``(indices, transitions, is_weights)``; ``beta``
        overrides the constructor's IS exponent for this draw.  In frame
        mode ``transitions`` is the materialized float batch
        (:meth:`materialize`); the uint8 frames never leave the buffer."""
        with span("replay_sample"):
            idx = self.sampler.sample(state.sampler_state, key, batch)
        idx_l = idx.to(torch.int64)
        if self.frame_store is not None:
            batch_tree = self.materialize(state, idx_l)
        else:
            batch_tree = {k: buf[idx_l] for k, buf in state.storage.items()}
        prios = self.sampler.priorities(state.sampler_state)
        w = importance_from_selected(prios[idx_l], prios.sum(),
                                     max(state.size, 1),
                                     self.beta if beta is None else beta)
        return idx, batch_tree, w

    def stamps(self, state: ReplayState, idx: torch.Tensor) -> torch.Tensor:
        """Write stamp pairs ``int32[..., 2]`` (counter, generation) of
        ``idx`` at sample time, for a stale-safe deferred update."""
        i = idx.to(torch.int64)
        return torch.stack([state.write_stamp[i], state.write_gen[i]], -1)

    def update_priorities(self, state: ReplayState, idx: torch.Tensor,
                          td_error: torch.Tensor,
                          stamp: torch.Tensor | None = None) -> ReplayState:
        """Rewrite priorities from fresh TD errors.  With ``stamp`` (the
        pairs :meth:`stamps` returned at sample time) rows whose slot was
        rewritten since are dropped instead of clobbering the newcomer."""
        idx = idx.to(torch.int64)
        p = (td_error.abs() + self.eps) ** self.alpha
        if stamp is None:
            sampler_state = self.sampler.update(state.sampler_state, idx, p)
            p_max = p.max()
        else:
            valid = ((state.write_stamp[idx] == stamp[..., 0])
                     & (state.write_gen[idx] == stamp[..., 1]))
            sampler_state = masked_update(self.sampler, state.sampler_state,
                                          idx, p, valid)
            p_max = torch.where(valid, p, torch.zeros_like(p)).max()
        return state._replace(
            sampler_state=sampler_state,
            max_priority=torch.maximum(state.max_priority, p_max))


def dirty_arcs(capacity: int, base_pos: int, n_new: int
               ) -> list[tuple[int, int]]:
    """Half-open ring row ranges written since a base snapshot at write
    position ``base_pos``, after ``n_new`` further transitions."""
    base_pos, n_new = int(base_pos), int(n_new)
    if n_new <= 0:
        return []
    if n_new >= capacity:
        return [(0, capacity)]
    end = base_pos + n_new
    if end <= capacity:
        return [(base_pos, end)]
    return [(base_pos, capacity), (0, end - capacity)]


def rows_to_ranges(rows) -> list[tuple[int, int]]:
    """Collapse touched row indices into sorted, merged half-open ranges."""
    out: list[tuple[int, int]] = []
    for r in sorted({int(r) for r in rows}):
        if out and r == out[-1][1]:
            out[-1] = (out[-1][0], r + 1)
        else:
            out.append((r, r + 1))
    return out
