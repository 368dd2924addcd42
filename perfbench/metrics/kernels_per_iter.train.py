"""Device operations (kernels, copies, fills) a DQN iteration, counted
in the traced window: what the captured graph and the eager steps
between its replays launch."""


def read(obs):
    iters = obs.units.get("iterations")
    if obs.trace is None or not iters:
        return None
    return len(obs.trace.ops) / iters
