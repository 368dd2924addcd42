"""Suite-wide configuration.

The host-device override MUST happen here, before any module imports
jax: XLA reads XLA_FLAGS at first backend init, so setting it inside a
test file is import-order fragile (anything importing jax earlier wins).
With 8 forced host devices every test sees the same topology and the
sharded-replay suite runs real multi-device meshes in-process instead of
via subprocesses.

Test taxonomy (see README "Testing"):

* ``tier1`` — fast must-pass gates that run on every push (the
  statistical sampling gates opt in explicitly; everything unmarked is
  tier-1 by default).
* ``slow``  — long-running integration tests (full smoke-scale training
  runs); CI runs them in the separate ``extended`` job.
* ``stats`` — statistical-distribution tests (chi-square / KS); the
  fast ones are double-marked ``tier1`` so the push gate still pins the
  sampling laws, while the heavyweight sweeps stay in ``extended``.

CI selects ``-m "tier1 or not (slow or stats)"`` for the push gate and
``-m "slow or stats"`` for the extended job, so every test runs in
exactly one job (tier1+stats double-marks run in both — they are the
regression gate for the paper's sampling-distribution claim).
"""
import os

if "host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8").strip()

import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "tier1: fast must-pass gate, runs on every push")
    config.addinivalue_line("markers", "slow: long-running integration test")
    config.addinivalue_line(
        "markers", "stats: statistical-distribution test (chi-square/KS)")
    config.addinivalue_line(
        "markers", "analysis: static-analysis gate tests "
                   "(repro.analysis fixtures, lockdep, trace checks)")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (the PyTorch port's CUDA "
                   "kernels); skips itself without one")


@pytest.fixture(scope="session")
def mesh():
    """2x4 ("pod", "data") mesh over the 8 forced host devices."""
    import jax

    if jax.device_count() < 8:
        pytest.skip("needs 8 devices (XLA_FLAGS was set before jax init?)")
    return jax.make_mesh((2, 4), ("pod", "data"))
