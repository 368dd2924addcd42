"""The roofline counts against the bounds PERF.md's kernel table gives:
5 MB for amper_sample at 1e6 rows (0.001493 ms), 100.7 MB for
multi_query_match and 84.4 MB for rank_select on a 2^24-row shard, and
0.40 ms for reading the 2^28-row table once."""
import pytest
from perfbench_testkit import CELLS, catalog  # noqa: F401

from perfbench.harness.peaks import FLOPS, least_seconds


def _counts(catalog, name, cell):
    wl = catalog.workload(cell)
    return catalog.roofline(name).counts(catalog.config(wl["config"]),
                                         catalog.cell(cell))


@pytest.mark.parametrize("name, cell, mb, ms", [
    ("amper_sample", CELLS[1], 5.0, 0.001493),
    ("multi_query_match", CELLS[0], 100.7, 0.03005),
    ("rank_select", CELLS[0], 84.4, 0.02519),
    ("sharded_draw", CELLS[0], 1342.4, 0.4007),
])
def test_bytes_bound(catalog, name, cell, mb, ms):
    c = _counts(catalog, name, cell)
    assert c["bytes"] / 1e6 == pytest.approx(mb, rel=2e-3)
    assert least_seconds(c) * 1e3 == pytest.approx(ms, rel=2e-3)


def test_qhead_step_flops(catalog):
    c = _counts(catalog, "qhead_step", CELLS[1])
    # 16 actor rows, then 64 rows forward, backward (weights and the
    # input gradients of the last two layers) and the target's forward
    fwd = 2 * (4 * 128 + 128 * 128 + 128 * 2)
    assert c["flops"] == 16 * fwd + 64 * (3 * fwd + 2 * (128 * 128
                                                         + 128 * 2))
    assert c["flops"] / FLOPS["float32"] * 1e9 == pytest.approx(138.3,
                                                                rel=1e-3)


def test_priority_write_bytes(catalog):
    c = _counts(catalog, "priority_write", CELLS[0])
    assert c["bytes"] == 65536 * 13 + 4 + 8192 * 5
