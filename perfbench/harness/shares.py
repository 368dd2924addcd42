"""What the share readers share: a kernel's least time over its measured
one, and the idle share of the traced window."""

import statistics

from perfbench.harness.peaks import least_seconds


def kernel_roofline(obs, roofline: str, kernel: str):
    """A kernel's least time (``rooflines/<roofline>.py``) over its mean
    device time a call in the trace, in percent; None where the trace
    holds no call."""
    if obs.trace is None:
        return None
    calls = obs.trace.op_seconds(kernel)
    if not calls:
        return None
    least = least_seconds(obs.catalog.roofline(roofline).counts(
        obs.config, obs.cell))
    return 100.0 * least / statistics.fmean(calls)


def idle(obs):
    if obs.trace is None:
        return None
    return 100.0 * (1.0 - obs.trace.busy_s / obs.trace.window_s)
