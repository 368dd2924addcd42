"""The priority writes' share of their roofline: the drawn rows' new
priorities and the inserts (``rooflines/priority_write.py``) over the
median device time of a request's writes (CUDA events on the stream
from the end of the draw to the end of the inserts)."""

import statistics

from perfbench.harness.peaks import least_seconds


def read(obs):
    write = obs.phases_ms.get("write")
    if obs.trace is None or not write:
        return None
    least = least_seconds(obs.catalog.roofline("priority_write").counts(
        obs.config, obs.cell))
    return 100.0 * least * 1e3 / statistics.median(write)
