"""Lockdep: a lock-order-graph recorder for the runtime.

Counterpart of ``repro/analysis/locks.py`` (its recorder half).  The
async runtime keeps few locks (the work and batch queue mutexes, the
snapshot hand-off queue, the replay-state lock that orders draws against
writes on the card, the metrics registry's registration lock, the JSONL
exporter's write lock, the pause gate's condition), but two threads that
ever take two of them in opposite orders can deadlock.  As Linux lockdep
does, record an edge A -> B whenever B is acquired while A is held; a
cycle in that digraph is a potential deadlock even if no run deadlocked.

* Instrumentation sites call :func:`make_lock` / :func:`make_condition`
  / :func:`tracked_queue` instead of the bare ``threading`` / ``queue``
  constructors.  With no recorder installed (the default) an acquire
  costs one global read more.
* Tests call :func:`enable`, exercise the runtime, then assert
  ``not recorder.cycles()``.
* :func:`cycle_findings` turns cycles into ``LOCK-ORDER`` findings, and
  :func:`check_log` rebuilds the graph offline from a recorded JSONL
  acquisition log (``python -m repro_torch.analysis --lock-log PATH``).
  The log's format is the reference's, so either package reads a log
  either wrote, with the same findings.
"""
from __future__ import annotations

import json
import queue
import threading
from typing import Iterable

from repro_torch.analysis.findings import Finding

# Module-global recorder.  ``None`` means disabled: TrackedLock's hot
# path is then a single global load + ``is None`` test.
_recorder: "LockGraph | None" = None


class TrackedLock:
    """A named wrapper around a ``threading.Lock`` (or compatible).

    Not reentrant, as the wrapped primitive.  All the waiting happens in
    the wrapped lock; the recorder sees an acquisition only once it
    succeeded, so recording can never deadlock itself.
    """

    __slots__ = ("name", "_lock")

    def __init__(self, name: str, lock=None):
        self.name = name
        self._lock = lock if lock is not None else threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._lock.acquire(blocking, timeout)
        rec = _recorder
        if ok and rec is not None:
            rec.on_acquire(self.name)
        return ok

    def release(self) -> None:
        rec = _recorder
        if rec is not None:
            rec.on_release(self.name)
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> "TrackedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"TrackedLock({self.name!r})"


def make_lock(name: str) -> TrackedLock:
    """A tracked ``threading.Lock`` replacement."""
    return TrackedLock(name)


def make_condition(name: str) -> threading.Condition:
    """A ``threading.Condition`` whose lock is tracked; ``wait`` releases
    and re-acquires through the wrapper, so lockdep sees it too."""
    return threading.Condition(TrackedLock(name))


def tracked_queue(name: str, maxsize: int = 0) -> queue.Queue:
    """A ``queue.Queue`` whose internal mutex is tracked: its three
    conditions are rebuilt on the tracked mutex, so every ``put`` /
    ``get`` / ``join`` shows in the lock graph."""
    q = queue.Queue(maxsize)
    mutex = TrackedLock(name, q.mutex)
    q.mutex = mutex
    q.not_empty = threading.Condition(mutex)
    q.not_full = threading.Condition(mutex)
    q.all_tasks_done = threading.Condition(mutex)
    return q


class LockGraph:
    """Per-thread held-lock stacks + the global acquisition-order digraph."""

    def __init__(self, log_path: str | None = None):
        self._tls = threading.local()
        # (held, acquired) -> witness: thread name + full held stack at
        # the moment the edge was first seen.
        self._edges: dict[tuple[str, str], dict] = {}
        # lock name -> successful acquisitions (an empty edge set means
        # something only if the locks fired).
        self._counts: dict[str, int] = {}
        # Plain, deliberately untracked guard for the shared structures.
        self._guard = threading.Lock()
        self._log = open(log_path, "a") if log_path else None

    def _stack(self) -> list[str]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def on_acquire(self, name: str) -> None:
        st = self._stack()
        held = list(st)
        st.append(name)
        new = [(h, name) for h in held
               if h != name and (h, name) not in self._edges]
        thread = threading.current_thread().name
        with self._guard:
            self._counts[name] = self._counts.get(name, 0) + 1
            for edge in new:
                self._edges.setdefault(
                    edge, {"thread": thread, "held": held})
            if self._log is not None:
                self._log.write(json.dumps(
                    {"ev": "acquire", "lock": name, "held": held,
                     "thread": thread}) + "\n")

    def on_release(self, name: str) -> None:
        st = self._stack()
        # Remove the innermost matching hold (out-of-order releases of
        # distinct locks are legal and common with queues).
        for i in range(len(st) - 1, -1, -1):
            if st[i] == name:
                del st[i]
                break
        if self._log is not None:
            with self._guard:
                self._log.write(json.dumps(
                    {"ev": "release", "lock": name,
                     "thread": threading.current_thread().name}) + "\n")

    def edges(self) -> set[tuple[str, str]]:
        with self._guard:
            return set(self._edges)

    def counts(self) -> dict[str, int]:
        """Successful acquisitions per lock name."""
        with self._guard:
            return dict(self._counts)

    def witness(self, edge: tuple[str, str]) -> dict:
        with self._guard:
            return dict(self._edges.get(edge, {}))

    def cycles(self) -> list[list[str]]:
        return find_cycles(self.edges())

    def flush(self) -> None:
        if self._log is not None:
            with self._guard:
                self._log.flush()

    def close(self) -> None:
        if self._log is not None:
            with self._guard:
                self._log.close()
                self._log = None


def enable(log_path: str | None = None) -> LockGraph:
    """Install a fresh recorder (replacing any active one)."""
    global _recorder
    old, _recorder = _recorder, LockGraph(log_path)
    if old is not None:
        old.close()
    return _recorder


def disable() -> LockGraph | None:
    """Uninstall the recorder and return it (the graph stays readable)."""
    global _recorder
    rec, _recorder = _recorder, None
    if rec is not None:
        rec.close()
    return rec


def current() -> LockGraph | None:
    return _recorder


def find_cycles(edges: Iterable[tuple[str, str]]) -> list[list[str]]:
    """Elementary cycles of the acquisition digraph (DFS back-edges), each
    once, rotated so its lexicographically smallest lock comes first."""
    adj: dict[str, list[str]] = {}
    for a, b in edges:
        adj.setdefault(a, []).append(b)
        adj.setdefault(b, [])
    seen_cycles: set[tuple[str, ...]] = set()
    cycles: list[list[str]] = []
    state: dict[str, int] = {}  # 0 unvisited / 1 on stack / 2 done
    path: list[str] = []

    def dfs(u: str) -> None:
        state[u] = 1
        path.append(u)
        for v in sorted(adj[u]):
            if state.get(v, 0) == 0:
                dfs(v)
            elif state.get(v) == 1:
                cyc = path[path.index(v):]
                k = min(range(len(cyc)), key=lambda i: cyc[i])
                canon = tuple(cyc[k:] + cyc[:k])
                if canon not in seen_cycles:
                    seen_cycles.add(canon)
                    cycles.append(list(canon))
        path.pop()
        state[u] = 2

    for node in sorted(adj):
        if state.get(node, 0) == 0:
            dfs(node)
    return cycles


def cycle_findings(cycles: list[list[str]],
                   source: str = "<lockdep>") -> list[Finding]:
    out = []
    for cyc in cycles:
        ring = " -> ".join(cyc + [cyc[0]])
        out.append(Finding(
            rule="LOCK-ORDER", path=source, line=0,
            message=f"lock acquisition cycle (potential deadlock): {ring}"))
    return out


def check_log(path: str) -> list[Finding]:
    """Offline lockdep: rebuild the order graph from a recorded JSONL
    acquisition log and report cycles.  Needs only the log — no runtime
    import, so it works on logs shipped from another machine."""
    edges: set[tuple[str, str]] = set()
    findings: list[Finding] = []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                findings.append(Finding(
                    rule="LOCK-ORDER", path=path, line=lineno,
                    message="unparseable lockdep log line"))
                continue
            if rec.get("ev") != "acquire":
                continue
            lock = rec["lock"]
            for held in rec.get("held", ()):
                if held != lock:
                    edges.add((held, lock))
    findings.extend(cycle_findings(find_cycles(edges), source=path))
    return findings
