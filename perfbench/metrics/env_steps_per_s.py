"""Env steps a second: iterations completed in the window times the
envs stepped in each, over the whole window (host clock, synchronised
at the end)."""


def read(obs):
    steps = obs.units.get("env_steps")
    return None if steps is None else steps / obs.window_s
