"""The timed window every cell shares, and the device clock it reads.

Set-up (process start to the first timed operation) builds the cell's
driver and warms up every shape it will use.  The window then issues
the cell driver's work unit after unit, with no synchronisation of its own,
until the host clock passes the run's length, and ends with one
synchronise: a rate is all the work over all that time.  With a trace
the window is shorter (the cell's ``trace_seconds``) and runs under
torch.profiler inside the host range ``bench.window``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

from perfbench.harness.trace import WINDOW, Trace


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Stamp:
    """A point on the device's stream (a CUDA event), or on the host clock
    where there is no card (the CPU tests)."""

    def __init__(self, device: torch.device):
        self.event = (torch.cuda.Event(enable_timing=True)
                      if device.type == "cuda" else None)
        self.host = None

    def record(self) -> "Stamp":
        if self.event is not None:
            self.event.record()
        else:
            self.host = time.perf_counter()
        return self

    def ms_to(self, later: "Stamp") -> float:
        if self.event is not None:
            return self.event.elapsed_time(later.event)
        return (later.host - self.host) * 1e3


class Phases:
    """Set-up's phases, each timed to a synchronise at its end, for the
    run's standard error."""

    def __init__(self, device: torch.device):
        self.device, self.t, self.done = device, time.perf_counter(), []

    def mark(self, name: str) -> None:
        sync(self.device)
        now = time.perf_counter()
        self.done.append((name, now - self.t))
        self.t = now

    def __str__(self) -> str:
        return ", ".join(f"{n} {s:.3f} s" for n, s in self.done)


@dataclass
class Observation:
    """What a run saw, for the metrics' readers."""

    config: dict
    cell: dict
    catalog: object
    setup_s: float = 0.0
    window_s: float = 0.0
    units: dict = field(default_factory=dict)
    latencies_ms: list = field(default_factory=list)
    phases_ms: dict = field(default_factory=dict)
    host_issue_s: list = field(default_factory=list)
    precision: str = "float32"
    trace: Trace | None = None


def run_window(driver, device: torch.device, seconds: float,
               traced: bool) -> tuple[float, list, Trace | None]:
    """Issue ``driver.step()`` until ``seconds`` of host time have passed
    (or the cell's driver has no more work); returns the window's length
    (synchronised), each step's host issue time and, traced, the
    reduced trace."""
    profiler = None
    if traced:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        profiler = profile(activities=acts)
        profiler.__enter__()
    issue = []
    try:
        sync(device)
        with torch.profiler.record_function(WINDOW):
            t0 = time.perf_counter()
            while True:
                h0 = time.perf_counter()
                more = driver.step()
                h1 = time.perf_counter()
                if not more:
                    break
                issue.append(h1 - h0)
                if h1 - t0 >= seconds:
                    break
            sync(device)
            window_s = time.perf_counter() - t0
    finally:
        if profiler is not None:
            profiler.__exit__(None, None, None)
    trace = (Trace(profiler.events(), set(driver.annotations))
             if profiler is not None else None)
    return window_s, issue, trace
