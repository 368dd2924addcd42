"""The device time of a request's priority writes: every
``priority_write`` span of the window (``ShardedAmperSampler.update``,
the drawn rows' new priorities and the inserts, timed by the CUDA events
it records on the stream) over the requests completed
(``perfbench/harness/spans.py``: the default registry holds the traced
window's spans alone)."""

from perfbench.harness.spans import device_ms


def read(obs):
    ms = device_ms("priority_write")
    requests = len(obs.latencies_ms)
    if not ms or not requests:
        return None
    return sum(ms) / requests
