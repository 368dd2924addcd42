"""Fixture: the clean twins of every flagged pattern — must lint clean."""
import time

import numpy as np
import torch

from repro_torch import prng


def fold_loop(key, n):
    """fold_in derives fresh keys; re-using the parent is fine."""
    outs = []
    for i in range(n):
        k = prng.fold_in(key, i)
        outs.append(prng.uniform(k, (2,)))
    return outs


def split_then_draw(key):
    k1, k2 = prng.split(key)
    return prng.uniform(k1, (2,)), prng.normal(k2, (2,))


def rebound(key):
    """A key re-bound by its own split is a fresh key."""
    key, sub = prng.split(key)
    a = prng.bits(sub, (2,))
    key, sub = prng.split(key)
    return a, prng.randint(sub, (), 0, 10)


def deliberate_replay(key):
    """Intentional same-key draw, suppressed inline."""
    a = prng.uniform(key, (2,))
    b = prng.uniform(key, (2,))  # repro: noqa[PRNG-REUSE]
    return a, b


def early_return_draw(key, fast):
    """A draw inside an early-return arm does not poison the fallthrough."""
    if fast:
        return prng.uniform(key, (2,))
    return prng.normal(key, (4,))


def timed(fn):
    """Durations come from the monotonic clock."""
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def provenance():
    """A wall-clock *timestamp* (no arithmetic) is legitimate."""
    return {"ts": time.time()}


def host_side(x):
    """Host syncs are fine outside a captured body."""
    return float(x.sum()), x.cpu().numpy(), np.asarray(x), x.tolist()


def body(x, out):
    """A captured body: structural branches only, values kept on the card."""
    if x is None or out is None:
        return
    if x.dim() == 2 and x.shape[0] > 1 and isinstance(x, torch.Tensor):
        x = x.sum(0)
    out.copy_(torch.where(x.sum() > 0, x, -x))


def run(x, out):
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        body(x, out)
    torch.cuda.synchronize()
    return out.sum().item()
