"""The DQN step's share of the card's peak: the Q-head's matrix-product
operations of every iteration in the traced window (``rooflines/
qhead_step.py``) over the window, against the peak of the precision the
products run in: float32's 67 TFLOP/s, or TF32's 495 where the program
lets float32 products use TF32 (``torch.backends.cuda.matmul.
allow_tf32``)."""

from perfbench.harness.peaks import FLOPS


def read(obs):
    iters = obs.units.get("iterations")
    if obs.trace is None or not iters:
        return None
    flops = obs.catalog.roofline("qhead_step").counts(
        obs.config, obs.cell)["flops"]
    return 100.0 * flops * iters / obs.trace.window_s / FLOPS[obs.precision]
