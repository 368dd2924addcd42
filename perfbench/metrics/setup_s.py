"""Seconds from process start to the first timed operation: imports,
building the program's kernels where a checkout has none yet, making
the cell's data on the card, and the warm-up."""


def read(obs):
    return obs.setup_s
