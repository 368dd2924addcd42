"""Replay-aware checkpointing: exact-resume serialization of the replay stack.

Counterpart of ``repro/train/replay_checkpoint.py``, on the generic layer
(:mod:`repro_torch.train.checkpoint`) and in its on-disk format:

* **Sampler-state coverage.**  :func:`replay_target` builds the restore
  target from the target buffer's ``init`` on the meta device
  (:func:`~repro_torch.core.samplers.on_meta` for the sampler),
  so restore validates a checkpoint against the sampler kind, capacity
  and n-step horizon configured now.
* **Elastic sharded restore.**  A sharded sampler's per-shard state is
  saved as its dense global table (``to_dense``, the reference's layout)
  and restored through the target sampler's ``from_dense``: a table
  saved on 4 shards restores onto 2, or onto 1, membership-exactly.
* **Exact dirty sets for incremental saves.**  :func:`replay_marks`
  captures the ring position and the add counter at a save;
  :func:`replay_dirty` turns the next state plus those marks (and any
  priority-feedback rows) into the dirty tree ``save_incremental``
  takes: storage and stamps dirty on the written ring arc only, priority
  tables on arc ∪ touched rows.
* **Whole-ReplayState save/restore** (:func:`save_replay` /
  :func:`restore_replay`), including the write stamps and generations,
  the add counter, ``max_priority``, the ring position and the n-step
  window, and the uint8 frame store's ring.  The port's host counters
  (``pos``, ``size``, ``total_adds``, ``add_gen``, the window's ``count``
  and ``pos``) are written as the reference's 0-d int32 leaves and come
  back as Python ints.
"""
from __future__ import annotations

import copy
from typing import Any

import torch

from repro_torch.core.replay_buffer import (ReplayState, dirty_arcs,
                                            rows_to_ranges)
from repro_torch.core.samplers import abstract_state, on_meta
from repro_torch.train import checkpoint as ck

_U32 = 1 << 32


def replay_marks(state: Any) -> dict:
    """Host watermarks of ``state`` that a later delta save must cover:
    the ring write position, the add counter (its unsigned 32-bit value:
    the counter is a wrapping int32) and its rollover generation.
    Capture at each save; pass back to :func:`replay_dirty` at the next."""
    return {"pos": int(state.pos),
            "total_adds": int(state.total_adds) & (_U32 - 1),
            "add_gen": int(state.add_gen)}


def replay_dirty(rb, state: Any, marks: dict, priority_rows=None) -> Any:
    """Exact dirty tree for ``state`` relative to the ``marks`` snapshot.

    * storage leaves and the write-stamp tables are dirty exactly on the
      ring arc written since ``marks`` (two ranges when it wraps);
    * capacity-dim sampler leaves (priority tables, AMPER pq/valid) are
      dirty on that arc plus ``priority_rows`` (host iterable of rows
      touched by priority feedback since the base);
    * other sampler leaves (a sum tree's inner nodes, scalars) and the
      scalars and n-step window are always saved whole.

    The tree flattens leaf for leaf against the saved form of ``state``
    (:func:`dense_view`: a sharded sampler's table dense).  Its first
    delta needs a full save of that form as its base.
    """
    capacity = rb.capacity
    # Difference the unsigned views of the wrapping int32 counter mod
    # 2^32, so a delta across the signed rollover stays exact; an equal
    # counter with a bumped generation is a whole 2^32-add lap.
    now = int(state.total_adds) & (_U32 - 1)
    base = int(marks["total_adds"]) & (_U32 - 1)
    n_new = (now - base) % _U32
    gen_delta = (int(state.add_gen) - int(marks.get("add_gen", 0))) % _U32
    if n_new == 0 and gen_delta:
        n_new = capacity
    arcs = dirty_arcs(capacity, marks["pos"], n_new)
    arc_spec: Any = ck.Rows(arcs) if arcs else False
    prio_ranges = arcs + rows_to_ranges(priority_rows or [])
    prio_spec: Any = ck.Rows(prio_ranges) if prio_ranges else False

    def sampler_leaf(leaf):
        shape = ck._leaf_shape(leaf)
        return (prio_spec if (len(shape) >= 1 and shape[0] == capacity)
                else True)

    saved = abstract_state(rb.sampler)  # the sampler state's saved form
    return ReplayState(
        storage=ck.dirty_like(state.storage, arc_spec),
        sampler_state=ck._unflatten(saved, [
            sampler_leaf(x) for x in ck._flatten_with_names(saved)[1]]),
        pos=True,
        size=True,
        max_priority=True,
        write_stamp=arc_spec,
        total_adds=True,
        write_gen=arc_spec,
        add_gen=True,
        nstep=(None if state.nstep is None
               else ck.dirty_like(state.nstep, True)),
    )


def dense_view(rb, state: ReplayState) -> ReplayState:
    """``state`` as a checkpoint stores it: a sharded sampler's per-shard
    state becomes its dense global table; anything else is unchanged."""
    if hasattr(rb.sampler, "to_dense"):
        return state._replace(
            sampler_state=rb.sampler.to_dense(state.sampler_state))
    return state


def from_dense_view(rb, state: ReplayState) -> ReplayState:
    """The inverse of :func:`dense_view` onto ``rb``'s own shards."""
    if hasattr(rb.sampler, "from_dense"):
        return state._replace(
            sampler_state=rb.sampler.from_dense(*state.sampler_state))
    return state


def replay_target(rb, example_transition: dict) -> ReplayState:
    """The restore target of ``rb``: its ``init`` on the meta device in
    the saved form (:func:`dense_view`): names, shapes, dtypes and the
    host counters, no memory."""
    meta_rb = copy.copy(rb)
    meta_rb.device = torch.device("meta")
    meta_rb.sampler = on_meta(rb.sampler)
    return dense_view(meta_rb, meta_rb.init(example_transition))


def replay_shardings(rb, target: Any):
    """The device of each leaf of ``target`` under ``rb``: the buffer's
    device for every leaf (a sharded table is restored dense onto the
    lead device, then split by ``from_dense``).  The counterpart of the
    reference's per-leaf shardings."""
    return ck._unflatten(target,
                         [rb.device] * len(ck._flatten_with_names(target)[1]))


def save_replay(directory: str, step: int, state: ReplayState,
                meta: dict | None = None, rb=None) -> str:
    """Durable atomic save of a ``ReplayState`` in the directory layout.
    The tensors are copied to the host dense, so the checkpoint is shard
    count agnostic; a sharded sampler's state needs its buffer ``rb``."""
    if rb is not None:
        state = dense_view(rb, state)
    elif any(isinstance(f, tuple) for f in state.sampler_state):
        raise ValueError("a sharded sampler state is saved dense: pass "
                         "save_replay(..., rb=buffer)")
    return ck.save(directory, step, state, meta=meta)


def restore_replay(directory: str, step: int, rb,
                   example_transition: dict) -> ReplayState:
    """Restore a ``ReplayState`` onto ``rb``'s device and shards.  ``rb``
    may have another shard count (or none) than the buffer that saved
    it: the table is split by its ``from_dense``, membership-exactly."""
    target = replay_target(rb, example_transition)
    state = ck.restore(directory, step, target,
                       replay_shardings(rb, target))
    return from_dense_view(rb, state)
