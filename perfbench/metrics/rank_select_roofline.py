"""``rank_select_kernel``'s share of its roofline: the least time of one
call on one shard (``rooflines/rank_select.py``) over its mean device
time a call in the trace."""

from perfbench.harness.shares import kernel_roofline


def read(obs):
    return kernel_roofline(obs, "rank_select", "rank_select_kernel")
