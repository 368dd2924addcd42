"""CUDA streams, stage hand-offs and the replay-state order.

The runtime's stages run on host threads, each under its own CUDA
stream on the service's device: every actor, the prefetcher, the replay
thread, the learner and the snapshot writer.  Work one thread enqueues
on its stream is not ordered before another thread's reads on another
stream, and PyTorch's caching allocator is per stream: a tensor made on
one stream and freed there can be handed out again while another
stream's kernels still read it.  So every hand-off between stages
(transition block, batch slab, feedback slab, published params, snapshot
capture) follows one protocol:

* the producer records an event on its stream after the work that made
  the item (:func:`mark`) and sends it with the item;
* the consumer makes its stream wait on that event and calls
  ``record_stream`` on every tensor it received (:func:`accept`), so the
  allocator keeps the memory until the consumer's work is done.

The canonical replay state is written in place (ring rows, stamps,
sampler tables), so a draw must never run while a write changes it.
:class:`StateGuard` orders every operation on it: a write, a feedback
apply, a draw (with its health probe) and a snapshot clone are enqueued
while its tracked lock ``runtime.replay_state`` is held, each waits on
the event of the operation before it, and records its own.  The device
then runs them in the order the lock granted them.

On the CPU there are no streams: every helper takes ``None`` for a
stream and does nothing but the host-side locking.
"""
from __future__ import annotations

import contextlib
from typing import Any, Iterator

import torch

from repro_torch.analysis.locks import make_lock


def stage_stream(device: torch.device):
    """A new stream on ``device`` for one stage (None on the CPU)."""
    return torch.cuda.Stream(device) if device.type == "cuda" else None


def on_stream(stream):
    """Context making ``stream`` this thread's current stream (a null
    context for None)."""
    return (torch.cuda.stream(stream) if stream is not None
            else contextlib.nullcontext())


def mark(stream):
    """An event recorded on ``stream`` now (None for no stream)."""
    if stream is None:
        return None
    event = torch.cuda.Event()
    event.record(stream)
    return event


def tensors(tree: Any) -> Iterator[torch.Tensor]:
    """Every tensor of a tree of dicts, lists, tuples and NamedTuples."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tensors(v)


def clone(tree: Any) -> Any:
    """``tree`` with every tensor cloned (host scalars and None kept)."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: clone(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(clone(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(clone(v) for v in tree)
    return tree


def accept(stream, event, *trees) -> None:
    """Consumer side of a hand-off: ``stream`` waits on ``event`` and every
    tensor of ``trees`` is recorded as in use on ``stream``."""
    if stream is None:
        return
    if event is not None:
        stream.wait_event(event)
    for tree in trees:
        for t in tensors(tree):
            if t.device.type == "cuda":
                t.record_stream(stream)


class StateGuard:
    """The one order of every operation on the in-place replay state.

    ``with guard.use(stream) as op:`` takes the lock, makes ``stream``
    wait on the previous operation's event and current for the block;
    on exit it records ``op.event``, which the next operation waits on
    and which a consumer of the block's outputs accepts.
    """

    def __init__(self):
        self.lock = make_lock("runtime.replay_state")
        self.event = None   # the last operation's event

    def use(self, stream) -> "_StateOp":
        return _StateOp(self, stream)


class _StateOp:
    __slots__ = ("_guard", "_stream", "_ctx", "event")

    def __init__(self, guard: StateGuard, stream):
        self._guard = guard
        self._stream = stream
        self.event = None

    def __enter__(self) -> "_StateOp":
        self._guard.lock.acquire()
        try:
            if self._stream is not None and self._guard.event is not None:
                self._stream.wait_event(self._guard.event)
            self._ctx = on_stream(self._stream)
            self._ctx.__enter__()
        except BaseException:
            self._guard.lock.release()
            raise
        return self

    def __exit__(self, *exc) -> None:
        try:
            self._ctx.__exit__(*exc)
            # Recorded even when the block raised: later operations then
            # still wait for whatever it managed to enqueue.
            self.event = self._guard.event = mark(self._stream)
        finally:
            self._guard.lock.release()
