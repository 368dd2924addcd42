"""The runner's own Python a DQN iteration: the host time of the
``runner_advance`` spans less the part their child spans (each step's
``steady_step`` or ``eager_step``) cover, over the iterations completed
(``perfbench/harness/spans.py``: the default registry holds the traced
window's spans alone)."""

from perfbench.harness.spans import spans


def read(obs):
    adv = spans("runner_advance")
    iters = obs.units.get("iterations")
    if not adv or not iters:
        return None
    return sum(s.self_ns for s in adv) / 1e3 / iters
