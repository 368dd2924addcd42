"""Spans over the metrics registry, on the host's clock and the card's.

Counterpart of ``repro/obs/tracing.py``.  ``span("csp_rebuild")`` wraps
a region and records its host time into the histogram
``span_csp_rebuild_ms`` of the *current* registry, and a record into the
registry's bounded span log (:class:`~repro_torch.obs.metrics.SpanLog`):
its id, its parent's and its root's ids (a thread-local stack of open
spans), its name, small integer attributes (``span("priority_write",
rows=n)``), its host start and end in ``time.perf_counter_ns()`` and its
host self time (less its children's).  In a process that has
initialised CUDA a span also records a pair of timing events on the
current device's current stream; a read (``Registry.spans()``, a
snapshot) turns the pair into device start and end on the host's clock
and adds ``span_<name>_device_ms``.  The port's call sites:

* the replay path's ``replay_sample``, ``csp_rebuild``,
  ``sharded_sample`` and every sampler's ``priority_write``;
* the DQN runner's ``runner_advance``, ``steady_step`` (the captured
  step's replay, or its body where there is no graph) and
  ``eager_step``;
* the runtime's ``rollout``, ``slab_draw``, ``learn``, ``add_block`` and
  ``apply_feedback``, the checkpoint manager's ``checkpoint_save``, and
  the serving engine's ``serve_prefill`` and ``serve_decode``.

* **When a span records.**  With its registry enabled; and, for the
  process's default registry (disabled), while a ``torch.profiler``
  session runs, so that a profiled window holds exactly its own spans.
  A registry installed or passed explicitly keeps its own switch.
* **Off is one branch.**  With no enabled registry and no profiler
  running, ``span()`` returns a shared no-op object: no event, no
  allocation, no clock read.
* **Never in a capture.**  Under CUDA graph capture a region's host time
  is the capture's, not a run's, and under ``torch.compile`` tracing it
  is compile time; spans no-op in both, as the reference's no-op under a
  jax trace.
* **On the profiler timeline.**  While a ``torch.profiler`` runs, a span
  also opens a ``torch.profiler.record_function`` range of its name,
  which the trace lays on the device timeline too.  There a span takes
  no event pair of its own unless it is opened with
  ``device_time=True``: the replay core's draws and writes, which
  bracket milliseconds of device work; a trainer step's span would pay
  more for the pair than a step's own Python.
* **No synchronise on the hot path**, but one: a registry's first span
  timed on a device synchronises it once, to anchor that device's
  events to the host's clock (and a full log waits for its oldest
  record's events if they are still pending when it drops them).
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Optional

import torch

from repro_torch.obs.metrics import (TIME_BUCKETS_MS, Registry, SpanLog,
                                     _SpanEntry)

# The process-wide current registry.  Disabled by default: every span is
# a cheap no-op until set_registry() installs an enabled one, or a
# profiler runs.
_default_registry = Registry(enabled=False)


class _State(threading.local):
    """A thread's registry override and its open spans (class defaults:
    a missing one reads without raising)."""

    registry: Optional[Registry] = None
    spans: Optional[list] = None


_state = _State()
_global_registry: Registry = _default_registry
_ids = itertools.count(1)


def get_registry() -> Registry:
    """The active registry (thread-local override, then process global)."""
    reg = _state.registry
    return reg if reg is not None else _global_registry


def set_registry(registry: Optional[Registry]) -> Optional[Registry]:
    """Install ``registry`` as the process-wide current registry (None
    restores the disabled default).  Returns the previously installed
    registry (None if it was the default) so callers can restore it."""
    global _global_registry
    prev = _global_registry
    _global_registry = registry if registry is not None else _default_registry
    return None if prev is _default_registry else prev


class use_registry:
    """Context manager: route this THREAD's spans/instruments to ``reg``."""

    def __init__(self, reg: Registry):
        self._reg = reg

    def __enter__(self):
        self._prev = _state.registry
        _state.registry = self._reg
        return self._reg

    def __exit__(self, *exc):
        _state.registry = self._prev
        return False


class _NullSpan:
    """Shared no-op span (nothing records, or inside a capture)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


def _open_spans() -> list:
    stack = _state.spans
    if stack is None:
        stack = _state.spans = []
    return stack


def _stream(log: SpanLog, dev: int):
    """The current stream, made into a ``torch.cuda.Stream`` once (making
    one costs more than a span's two event records)."""
    raw = torch._C._cuda_getCurrentRawStream(dev)
    s = log.streams.get(raw)
    if s is None:
        s = log.streams[raw] = torch.cuda.current_stream(dev)
    return s


def _anchor(log: SpanLog, dev: int) -> None:
    """Place ``dev``'s events on the host clock.  An event recorded on an
    idle card ran between the host's clock before its record and after
    its wait; of a few such round trips the shortest bounds it best, and
    its end is the anchor, so that a placed time is never early (and
    late by at most that round trip)."""
    torch.cuda.synchronize(dev)
    best = None
    for _ in range(5):
        ev = torch.cuda.Event(enable_timing=True)
        h0 = time.perf_counter_ns()
        ev.record()
        ev.synchronize()
        h1 = time.perf_counter_ns()
        if best is None or h1 - h0 < best[0]:
            best = (h1 - h0, ev, h1)
    log.pools[dev] = []
    log.anchors[dev] = best[1:]


def _event(log: SpanLog, dev: int):
    pool = log.pools[dev]
    return pool.pop() if pool else torch.cuda.Event(enable_timing=True)


class _Span:
    """An open span.  Its host interval holds its two event records, so
    that the card cannot reach the start event before the host start."""

    __slots__ = ("_log", "_hist", "_range", "_entry", "_dev", "_stream",
                 "_start", "_child_ns")

    def __init__(self, log, hist, rng, name, attrs, timed):
        self._log, self._hist, self._range = log, hist, rng
        if log is not None:
            e = self._entry = _SpanEntry()
            e.id, e.name, e.attrs = next(_ids), name, attrs
            e.events = e.device_ns = None
            self._child_ns = 0
            self._dev = (torch.cuda.current_device()
                         if timed and torch.cuda.is_initialized() else None)

    def __enter__(self):
        if self._range is not None:
            self._range.__enter__()
        log = self._log
        if log is None:
            return self
        e, stack = self._entry, _open_spans()
        if stack:
            e.parent, e.root = stack[-1]._entry.id, stack[-1]._entry.root
        else:
            e.parent, e.root = 0, e.id
        stack.append(self)
        dev = self._dev
        if dev is not None:
            if dev not in log.anchors:
                _anchor(log, dev)
            self._stream = _stream(log, dev)
            self._start = _event(log, dev)
            e.t0 = time.perf_counter_ns()
            self._start.record(self._stream)
        else:
            e.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        log = self._log
        if log is not None:
            e, dev = self._entry, self._dev
            if dev is not None:
                end = _event(log, dev)
                end.record(self._stream)
                e.events = (dev, self._start, end)
            e.t1 = time.perf_counter_ns()
            took = e.t1 - e.t0
            e.self_ns = took - self._child_ns
            stack = _open_spans()
            stack.pop()
            if stack:
                stack[-1]._child_ns += took
            if self._hist is not None:
                self._hist.observe(took / 1e6)
            log.append(e)
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


def _capturing() -> bool:
    """True under torch.compile tracing or while the current CUDA stream
    is being captured into a graph."""
    if torch.compiler.is_compiling():
        return True
    return (torch.cuda.is_initialized()
            and torch.cuda.is_current_stream_capturing())


def span(name: str, registry: Registry | None = None, *,
         device_time: bool = False, **attrs: int):
    """Span context manager -> histogram ``span_<name>_ms`` and a record
    with ``attrs`` in the registry's span log (with device times on a
    card), and a ``record_function`` range of ``name`` under a profiler.
    ``device_time`` keeps the device times under a profiler too.

    A shared null object when nothing would record, or inside a capture
    (see the module docstring).
    """
    reg = registry if registry is not None else get_registry()
    profiling = torch.autograd._profiler_enabled()
    if not (reg.enabled or profiling) or _capturing():
        return _NULL_SPAN
    logged = reg.enabled or reg is _default_registry
    hist = (reg.histogram(f"span_{name}_ms", help=f"wall time of {name} (ms)",
                          bounds=TIME_BUCKETS_MS) if reg.enabled else None)
    return _Span(reg.span_log if logged else None, hist,
                 torch.profiler.record_function(name) if profiling else None,
                 name, attrs, device_time or not profiling)
