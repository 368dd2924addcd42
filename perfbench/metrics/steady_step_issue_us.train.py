"""The host's time to issue a replayed DQN step: the median host time of
the runner's ``steady_step`` span, the graph's launch and the runner's
bookkeeping around it, as the traced window's profiler slows them: its
range and its tracing of the launch are inside
(``perfbench/harness/spans.py``: the default registry holds the traced
window's spans alone)."""

from perfbench.harness.spans import median, spans


def read(obs):
    ms = median([s.host_ms for s in spans("steady_step")])
    return None if ms is None else 1e3 * ms
