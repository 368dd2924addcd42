"""What the benchmark's CPU tests share: the checkout's root on the
import path, the catalog, and the two cells at a size the CPU holds."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from perfbench.harness.catalog import Catalog  # noqa: E402

CELLS = ("amper-2e28.b65536", "dqn-cartpole.captured")


@pytest.fixture(scope="session")
def catalog():
    return Catalog(ROOT)


@pytest.fixture(scope="session")
def small(catalog):
    """``{cell: (config, traffic)}`` at sizes the CPU holds: 4 shards of
    2^10 rows, and a 4,096-row ring that learns from iteration 10."""
    c1 = dict(catalog.config("amper-fr-2e28"), capacity_log2=12, shards=4)
    t1 = dict(catalog.cell(CELLS[0]), batch=256, inserts=32,
              warm_requests=1, max_requests_per_s=20)
    c2 = dict(catalog.config("dqn-cartpole-amper-fr"), replay_size=4096,
              learn_start=10)
    t2 = dict(catalog.cell(CELLS[1]), fill_chunk=1024, max_iters_per_s=40,
              warm_iters=20)
    return {CELLS[0]: (c1, t1), CELLS[1]: (c2, t2)}
