"""The median device time of one sharded draw: the program's span
``sharded_sample`` around ``ShardedAmperSampler.sample``, timed by the
CUDA events it records on the stream (``perfbench/harness/spans.py``:
the default registry holds the traced window's spans alone)."""

from perfbench.harness.spans import device_ms, median


def read(obs):
    return median(device_ms("sharded_sample"))
