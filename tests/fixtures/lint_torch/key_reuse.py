"""Fixture: PRNG-REUSE — one key of the port's prng feeds two draws."""
from repro_torch import prng


def two_draws(key):
    noise = prng.uniform(key, (4,))
    jitter = prng.normal(key, (4,))  # BUG: key already consumed
    return noise + jitter


def split_after_draw(key):
    bits = prng.bits(key, (2,))
    k1, k2 = prng.split(key)  # BUG: split of a consumed key
    return bits, k1, k2


def loop_reuse(key, n):
    out = []
    for _ in range(n):
        out.append(prng.randint(key, (), 0, 10))  # BUG: every iteration
    return out


def one_arm(key, flag):
    a = prng.bernoulli(key, 0.5) if flag else None
    if flag:
        a = prng.uniform(key)  # BUG: drawn from above on this arm
    return a
