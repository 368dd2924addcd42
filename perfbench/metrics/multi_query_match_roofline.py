"""``multi_query_match_kernel``'s share of its roofline: the least time of
one call on one shard (``rooflines/multi_query_match.py``) over its mean
device time a call in the trace."""

from perfbench.harness.shares import kernel_roofline


def read(obs):
    return kernel_roofline(obs, "multi_query_match",
                           "multi_query_match_kernel")
