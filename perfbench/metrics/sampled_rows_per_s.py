"""Rows drawn a second: every request completed in the window times its
batch, over the whole window (host clock, synchronised at the end)."""


def read(obs):
    rows = obs.units.get("rows")
    return None if rows is None else rows / obs.window_s
