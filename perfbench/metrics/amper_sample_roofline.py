"""``amper_sample_kernel``'s share of its roofline: the least time of one
call (``rooflines/amper_sample.py``) over its mean device time a call
in the trace."""

from perfbench.harness.shares import kernel_roofline


def read(obs):
    return kernel_roofline(obs, "amper_sample", "amper_sample_kernel")
