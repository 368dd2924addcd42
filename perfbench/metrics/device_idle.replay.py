"""The share of the traced window in which no operation ran on the
device, in the replay memory's cell."""

from perfbench.harness.shares import idle


def read(obs):
    return idle(obs)
