"""The sharded draw's share of its roofline, whatever kernels it runs:
the table read once and the rows written (``rooflines/sharded_draw.py``,
0.40 ms for 2^28 rows) over the median device time of a request's draw
(CUDA events on the stream around ``sample``)."""

import statistics

from perfbench.harness.peaks import least_seconds


def read(obs):
    draw = obs.phases_ms.get("draw")
    if obs.trace is None or not draw:
        return None
    least = least_seconds(obs.catalog.roofline("sharded_draw").counts(
        obs.config, obs.cell))
    return 100.0 * least * 1e3 / statistics.median(draw)
