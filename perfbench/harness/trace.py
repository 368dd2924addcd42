"""A torch.profiler trace of the measured window, reduced to what the
per-layer readers take.

The window is the host range ``bench.window`` that the harness opens
around the traced loop, after a synchronise and up to one.  Inside it:

* device operations (kernels, copies, fills), each with its interval
  (a ``record_function`` range of the harness or a span of the program,
  which the profiler also lays on the device timeline, is none);
* ``busy_s``: the union of the device operations' intervals;
* idle gaps: the stretches of the window in which no device operation
  ran, each labelled by what the host was doing at its start (the
  innermost annotation and the innermost host operation open there).
"""
from __future__ import annotations

import bisect
from collections import defaultdict

WINDOW = "bench.window"
NAME_CHARS = 160  # a templated kernel's name runs to thousands


def _is_annotation(e, names: set) -> bool:
    return bool(getattr(e, "is_user_annotation", False)) or e.name in names


class Trace:
    def __init__(self, events, annotation_names: set):
        from torch.autograd import DeviceType

        cpu = [e for e in events if e.device_type == DeviceType.CPU]
        wins = [e for e in cpu if e.name == WINDOW]
        if len(wins) != 1:
            raise RuntimeError(f"{len(wins)} '{WINDOW}' ranges in the trace")
        w0, w1 = wins[0].time_range.start, wins[0].time_range.end
        self.window_s = (w1 - w0) / 1e6
        names = set(annotation_names) | {
            e.name for e in cpu if getattr(e, "is_user_annotation", False)}
        dev = [e for e in events if e.device_type == DeviceType.CUDA
               and w0 <= e.time_range.start <= w1]
        self.ops = [(e.name, e.time_range.start, e.time_range.end)
                    for e in dev if not _is_annotation(e, names)]
        busy, gaps = 0.0, []
        cur_s = cur_e = None
        for _, s, e in sorted(self.ops, key=lambda o: o[1]):
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                    gaps.append((cur_e, s))
                else:
                    gaps.append((w0, s))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
            gaps.append((cur_e, w1))
        self.busy_s = busy / 1e6
        self._cpu = sorted((e for e in cpu if e.name != WINDOW),
                           key=lambda e: e.time_range.start)
        self._starts = [e.time_range.start for e in self._cpu]
        self._names = names
        self.gaps = [(a, b) for a, b in gaps if b > a]

    def _open_at(self, t: float, annotation: bool):
        """The latest-starting host event open at ``t`` (an annotation, or
        any event)."""
        i = bisect.bisect_right(self._starts, t)
        for e in reversed(self._cpu[max(0, i - 4000):i]):
            if e.time_range.end >= t and (
                    not annotation or _is_annotation(e, self._names)):
                return e.name
        return None

    def op_seconds(self, substring: str) -> list[float]:
        """Durations of the device operations whose name holds
        ``substring``."""
        return [(e - s) / 1e6 for n, s, e in self.ops if substring in n]

    def breakdown(self, top: int = 10) -> dict:
        by_op = defaultdict(float)
        for n, s, e in self.ops:
            by_op[n] += (e - s) / 1e6
        by_gap = defaultdict(float)
        for a, b in self.gaps:
            ann = self._open_at(a, True) or "-"
            op = self._open_at(a, False) or "host idle"
            by_gap[f"{ann} | {op}"] += (b - a) / 1e6
        return {"device_ops": [[n[:NAME_CHARS], s] for n, s in sorted(
                    by_op.items(), key=lambda x: -x[1])[:top]],
                "idle_gaps": [[n, s] for n, s in sorted(
                    by_gap.items(), key=lambda x: -x[1])[:top]]}
