"""Fixture: WALL-CLOCK — time.time() in duration math and deadlines."""
import time


def measure(fn):
    t0 = time.time()
    fn()
    return time.time() - t0  # BUG: wall clock is not monotonic


def until(fn, budget):
    end = time.time() + budget  # BUG: a deadline on the wall clock
    while time.time() < end:  # BUG: compared as a deadline
        fn()
