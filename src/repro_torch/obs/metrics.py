"""Metrics registry: counters, gauges and histograms with per-thread
lock-free accumulation and snapshot-on-read merge.

Counterpart of ``repro/obs/metrics.py``, with the same instruments, the
same bucket bounds (``TIME_BUCKETS_MS``, ``US_BUCKETS``, ``INT_BUCKETS``)
and the same percentile rule, so that the two packages report equal
percentiles from equal observations.  All of it runs on the host.

* Every instrument keeps one *cell* per writer thread; a thread only
  ever mutates its own cell, so the write path is a plain attribute
  update under the GIL (no lock, no cross-thread cache traffic).
* The registry's lock (tracked as ``obs.registry`` by
  :mod:`repro_torch.analysis.locks`) is taken only when a thread touches
  an instrument for the first time (cell creation) and when a reader
  snapshots: reads merge all cells into one immutable :class:`Snapshot`,
  so a half-updated cell is at worst one event stale, never torn.

Instruments are cumulative (Prometheus-style); ``Snapshot.diff(base)``
subtracts counters and histogram buckets for a per-run view.

A registry also keeps the bounded log of its spans (:class:`SpanLog`,
written by :mod:`repro_torch.obs.tracing`).  A span timed on the card
holds a pair of CUDA events until a read (:meth:`Registry.spans`,
:meth:`Registry.snapshot`) turns them into device times on the host's
``perf_counter_ns`` clock; this module calls only the events' own
methods and imports no torch.
"""
from __future__ import annotations

import bisect
import collections
import itertools
import math
import threading
import time
from typing import Any, Iterable, NamedTuple

from repro_torch.analysis.locks import make_lock

# Default wall-time buckets for span histograms: 10us .. ~5.6s in
# quarter-decade steps (spans record milliseconds; slower outliers land
# in the overflow bucket, whose percentile reads back the observed max).
TIME_BUCKETS_MS = tuple(
    0.01 * (10 ** 0.25) ** i for i in range(24)
)
# Microsecond buckets for sub-millisecond pauses (COW snapshot capture).
US_BUCKETS = tuple(1.0 * (10 ** 0.25) ** i for i in range(21))
# Small-integer buckets (exact up to 64) for discrete quantities like
# feedback staleness in learner steps or queue depths.
INT_BUCKETS = tuple(range(65)) + tuple(128 * 2 ** i for i in range(8))


class _Cell:
    """One writer thread's private accumulator (no locks ever)."""

    __slots__ = ("count", "total", "vmin", "vmax", "buckets")

    def __init__(self, n_buckets: int = 0):
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self.buckets = [0] * n_buckets if n_buckets else None


class Instrument:
    """Base: per-thread cells keyed by thread id, created under the
    registry lock, written lock-free afterwards."""

    kind = "instrument"

    def __init__(self, registry: "Registry", name: str, help: str = ""):
        self._registry = registry
        self.name = name
        self.help = help
        # Append-only: a dead thread's cell stays merged forever (cells
        # are cumulative), and thread-id reuse can't alias two threads
        # onto one cell.  Bounded by writer threads over registry life.
        self._cells: list[_Cell] = []
        self._local = threading.local()

    def _new_cell(self) -> _Cell:
        return _Cell()

    def _cell(self) -> _Cell:
        cell = getattr(self._local, "cell", None)
        if cell is None:
            cell = self._new_cell()
            with self._registry._lock:
                self._cells.append(cell)
            self._local.cell = cell
        return cell

    def _merged_cells(self) -> list[_Cell]:
        with self._registry._lock:
            return list(self._cells)


class Counter(Instrument):
    """Monotone event count (optionally weighted)."""

    kind = "counter"

    def add(self, value: float = 1.0) -> None:
        if not self._registry.enabled:
            return
        cell = self._cell()
        cell.count += 1
        cell.total += value

    @property
    def value(self) -> float:
        return sum(c.total for c in self._merged_cells())

    def read(self) -> dict:
        cells = self._merged_cells()
        return {"value": sum(c.total for c in cells),
                "events": sum(c.count for c in cells)}


class Gauge(Instrument):
    """Last-written value (per thread, merged by freshest write)."""

    kind = "gauge"

    def _new_cell(self) -> _Cell:
        cell = _Cell()
        cell.total = math.nan
        return cell

    def set(self, value: float) -> None:
        if not self._registry.enabled:
            return
        cell = self._cell()
        cell.total = float(value)
        cell.count += 1
        cell.vmax = time.monotonic()  # freshness stamp for the merge

    @property
    def value(self) -> float:
        best, best_t = math.nan, -math.inf
        for c in self._merged_cells():
            if c.count and c.vmax > best_t:
                best, best_t = c.total, c.vmax
        return best

    def read(self) -> dict:
        return {"value": self.value}


class Histogram(Instrument):
    """Fixed-bound bucket histogram with exact count/sum/min/max.

    ``bounds`` are inclusive upper edges of the first ``len(bounds)``
    buckets plus an implicit overflow bucket, so percentile estimates
    come from cumulative bucket counts (exact whenever the recorded
    values land on integer bounds, as staleness and queue depths do).
    """

    kind = "histogram"

    def __init__(self, registry: "Registry", name: str, help: str = "",
                 bounds: Iterable[float] = TIME_BUCKETS_MS):
        super().__init__(registry, name, help)
        self.bounds = tuple(float(b) for b in bounds)

    def _new_cell(self) -> _Cell:
        return _Cell(n_buckets=len(self.bounds) + 1)

    def observe(self, value: float) -> None:
        if not self._registry.enabled:
            return
        value = float(value)
        cell = self._cell()
        cell.count += 1
        cell.total += value
        if value < cell.vmin:
            cell.vmin = value
        if value > cell.vmax:
            cell.vmax = value
        cell.buckets[bisect.bisect_left(self.bounds, value)] += 1

    def observe_n(self, value: float, n: int) -> None:
        """Record ``n`` identical observations in O(1) (e.g. a feedback
        slab whose S batches all share one staleness)."""
        if not self._registry.enabled or n <= 0:
            return
        value = float(value)
        cell = self._cell()
        cell.count += n
        cell.total += value * n
        if value < cell.vmin:
            cell.vmin = value
        if value > cell.vmax:
            cell.vmax = value
        cell.buckets[bisect.bisect_left(self.bounds, value)] += n

    def read(self) -> dict:
        cells = self._merged_cells()
        buckets = [0] * (len(self.bounds) + 1)
        count, total = 0, 0.0
        vmin, vmax = math.inf, -math.inf
        for c in cells:
            count += c.count
            total += c.total
            vmin = min(vmin, c.vmin)
            vmax = max(vmax, c.vmax)
            for i, b in enumerate(c.buckets):
                buckets[i] += b
        return {"count": count, "sum": total,
                "min": vmin if count else math.nan,
                "max": vmax if count else math.nan,
                "buckets": buckets}

    def percentile(self, q: float) -> float:
        return _hist_percentile(self.read(), self.bounds, q)


def _hist_percentile(data: dict, bounds: tuple, q: float) -> float:
    """Percentile estimate from cumulative bucket counts.

    Returns the upper bound of the bucket holding the q-quantile
    (clamped to the observed max), so integer-valued series recorded on
    integer bounds read back exactly; the overflow bucket reports the
    exact observed max.
    """
    count = data["count"]
    if not count:
        return math.nan
    rank = q * count
    seen = 0
    for i, b in enumerate(data["buckets"]):
        seen += b
        if seen >= rank and b:
            if i >= len(bounds):
                return data["max"]
            return min(bounds[i], data["max"])
    return data["max"]


def hist_stats(data: dict, bounds: tuple) -> dict:
    """Summary view (count/mean/min/max/p50/p95/p99) of a histogram read."""
    count = data["count"]
    return {
        "count": count,
        "mean": data["sum"] / count if count else 0.0,
        "min": data["min"] if count else 0.0,
        "max": data["max"] if count else 0.0,
        "p50": _hist_percentile(data, bounds, 0.50) if count else 0.0,
        "p95": _hist_percentile(data, bounds, 0.95) if count else 0.0,
        "p99": _hist_percentile(data, bounds, 0.99) if count else 0.0,
    }


class Snapshot:
    """Immutable point-in-time merge of every instrument in a registry."""

    def __init__(self, data: dict[str, dict], meta: dict[str, dict],
                 ts: float):
        self.data = data      # name -> instrument read()
        self.meta = meta      # name -> {"kind": ..., "bounds": ...}
        self.ts = ts

    def diff(self, base: "Snapshot | None") -> "Snapshot":
        """Per-run view: subtract a base snapshot's counters and
        histogram buckets; gauges keep their current value."""
        if base is None:
            return self
        out: dict[str, dict] = {}
        for name, cur in self.data.items():
            kind = self.meta[name]["kind"]
            prev = base.data.get(name)
            if prev is None or kind == "gauge":
                out[name] = dict(cur)
                continue
            if kind == "counter":
                out[name] = {"value": cur["value"] - prev["value"],
                             "events": cur["events"] - prev["events"]}
            else:  # histogram: bucket-wise subtraction; min/max are
                # only valid for the union window, keep current's.
                out[name] = {
                    "count": cur["count"] - prev["count"],
                    "sum": cur["sum"] - prev["sum"],
                    "min": cur["min"], "max": cur["max"],
                    "buckets": [a - b for a, b in
                                zip(cur["buckets"], prev["buckets"])],
                }
        return Snapshot(out, self.meta, self.ts)

    def summary(self) -> dict:
        """JSON-friendly rendering: histograms become stats dicts."""
        out = {}
        for name, d in self.data.items():
            kind = self.meta[name]["kind"]
            if kind == "histogram":
                out[name] = hist_stats(d, self.meta[name]["bounds"])
            else:
                out[name] = d
        return out


# The span log's bound: past it a new record drops the oldest one.
SPAN_LOG_LIMIT = 65_536


class SpanRecord(NamedTuple):
    """One closed span, as :meth:`Registry.spans` returns it.  Times are
    nanoseconds on ``time.perf_counter_ns``'s clock; the device pair is
    None where the span was not timed on a card."""

    seq: int              # position in the order spans closed
    id: int
    parent: int           # the enclosing span's id on this thread, or 0
    root: int             # the outermost enclosing span's id (own if none)
    name: str
    attrs: dict
    host_start_ns: int
    host_end_ns: int
    self_ns: int          # host time less that of the direct children
    device_start_ns: int | None
    device_end_ns: int | None

    @property
    def host_ms(self) -> float:
        return (self.host_end_ns - self.host_start_ns) / 1e6

    @property
    def device_ms(self) -> float | None:
        if self.device_start_ns is None:
            return None
        return (self.device_end_ns - self.device_start_ns) / 1e6


class _SpanEntry:
    """A record in the log; ``events`` is (device, start, end) until a
    read resolves it into ``device_ns``."""

    __slots__ = ("seq", "id", "parent", "root", "name", "attrs", "t0", "t1",
                 "self_ns", "events", "device_ns")

    def record(self) -> SpanRecord:
        d0, d1 = self.device_ns or (None, None)
        return SpanRecord(self.seq, self.id, self.parent, self.root,
                          self.name, self.attrs, self.t0, self.t1,
                          self.self_ns, d0, d1)


class SpanLog:
    """A registry's closed spans, oldest first, at most ``limit`` of them
    (``dropped`` counts the records the bound pushed out).

    A writer appends without a lock.  Timing events come from a pool per
    device and go back to it once read.  ``anchors`` maps a device to
    one event and a host time no earlier than the card ran it (taken
    after a synchronise), which places every other event of that device
    on the host's clock; ``streams`` keeps the streams they record on.
    The records that still hold a pair wait in a queue of their own, so
    a read visits only those.  Dropping a record whose end event is
    still pending waits for it, so that a pooled event is never in
    flight.
    """

    def __init__(self, registry: "Registry", limit: int = SPAN_LOG_LIMIT):
        self._registry = registry
        self.limit = limit
        self.dropped = 0
        self._records: collections.deque = collections.deque()
        self._pending: collections.deque = collections.deque()
        self._seq = itertools.count()
        self.pools: dict[int, list] = {}
        self.anchors: dict[int, tuple] = {}
        self.streams: dict[int, Any] = {}

    def __len__(self) -> int:
        return len(self._records)

    def append(self, entry: _SpanEntry) -> None:
        if len(self._records) >= self.limit:
            self._drop()
        entry.seq = next(self._seq)
        self._records.append(entry)
        if entry.events is not None:
            self._pending.append(entry)

    def _drop(self) -> None:
        with self._registry._lock:
            if len(self._records) < self.limit:
                return
            old = self._records.popleft()
            self.dropped += 1
            events, old.events = old.events, None
        if events is not None:
            dev, start, end = events
            if not end.query():
                end.synchronize()
            self.pools[dev] += (start, end)

    def resolve(self, wait: bool) -> None:
        """Turn event pairs into device times on the host clock and add
        each to ``span_<name>_device_ms``, oldest first; without ``wait``
        a read stops at the first pair still pending."""
        done = []
        with self._registry._lock:
            pending = self._pending
            while pending:
                e = pending[0]
                if e.events is not None:
                    dev, start, end = e.events
                    if not end.query():
                        if not wait:
                            break
                        end.synchronize()
                    # an elapsed time is a float32 of ms: the start's
                    # place drifts by its rounding (0.5 us at 6 s from
                    # the anchor), the duration, timed from the start,
                    # does not
                    anchor, anchor_ns = self.anchors[dev]
                    d0 = anchor_ns + round(anchor.elapsed_time(start) * 1e6)
                    e.device_ns = (d0,
                                   d0 + round(start.elapsed_time(end) * 1e6))
                    e.events = None
                    self.pools[dev] += (start, end)
                    done.append((e.name,
                                 (e.device_ns[1] - e.device_ns[0]) / 1e6))
                pending.popleft()
        for name, ms in done:
            self._registry.histogram(
                f"span_{name}_device_ms", help=f"device time of {name} (ms)",
                bounds=TIME_BUCKETS_MS).observe(ms)

    def records(self) -> list[SpanRecord]:
        return [e.record() for e in list(self._records)]


class Registry:
    """Named instrument container.

    ``enabled=False`` turns every record call into one attribute check.
    Instruments record on the host; a span timed on a card records a pair
    of CUDA events, and no instrument adds a kernel launch either way.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = make_lock("obs.registry")
        self._instruments: dict[str, Instrument] = {}
        self.span_log = SpanLog(self)

    def _get(self, name: str, factory) -> Any:
        inst = self._instruments.get(name)
        if inst is None:
            with self._lock:
                inst = self._instruments.get(name)
                if inst is None:
                    inst = factory()
                    self._instruments[name] = inst
        return inst

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(name, lambda: Counter(self, name, help))

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(name, lambda: Gauge(self, name, help))

    def histogram(self, name: str, help: str = "",
                  bounds: Iterable[float] = TIME_BUCKETS_MS) -> Histogram:
        return self._get(
            name, lambda: Histogram(self, name, help, bounds=bounds))

    def instruments(self) -> dict[str, Instrument]:
        with self._lock:
            return dict(self._instruments)

    def spans(self) -> list[SpanRecord]:
        """Every span in the log, oldest first, device times resolved
        (waiting for the card where a pair is still pending)."""
        self.span_log.resolve(wait=True)
        return self.span_log.records()

    def snapshot(self) -> Snapshot:
        self.span_log.resolve(wait=False)
        insts = self.instruments()
        data = {name: inst.read() for name, inst in insts.items()}
        meta = {name: {"kind": inst.kind,
                       "bounds": getattr(inst, "bounds", None)}
                for name, inst in insts.items()}
        return Snapshot(data, meta, ts=time.time())
