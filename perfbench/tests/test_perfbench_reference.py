"""The plain reference against the port on the CPU, at small sizes:
the PRNG, the ranges, both AMPER-fr draws, the priority write and the
two cells' whole checks (4 shards of 2^10 rows; a 4,096-row ring)."""
import time

import pytest
import torch
from perfbench_testkit import CELLS, catalog, small  # noqa: F401

from perfbench.harness.main import run_cell
from perfbench.reference import amper as ra
from perfbench.reference import threefry as tf
from repro_torch import prng
from repro_torch.core.amper import (AmperConfig, AmperSampler, AmperState,
                                    fr_intervals, group_representatives)
from repro_torch.core.sharded import ShardedAmperSampler, ShardedAmperState
from repro_torch.distributed.sharding import Mesh

SEEDS = (0, 7, 2 ** 31 + 12345)


@pytest.mark.parametrize("seed", SEEDS)
def test_threefry(seed):
    k = prng.key(seed)
    kn = tf.key(seed)
    assert (kn == k.numpy()).all()
    assert (tf.split(kn, 5) == prng.split(k, 5).numpy()).all()
    assert (tf.fold_in(kn, 1) == prng.fold_in(k, 1).numpy()).all()
    assert (tf.bits(kn, (9,)) == prng.bits(k, (9,)).numpy()).all()
    ks = prng.split(k, 16)
    assert (tf.uniform(ks.numpy(), (4,), -0.05, 0.05)
            == prng.uniform(ks, (4,), -0.05, 0.05).numpy()).all()
    for hi in (2, 1_000_000, 40_265_318):
        assert (tf.randint(kn, (100,), 0, hi)
                == prng.randint(k, (100,), 0, hi).numpy()).all()


@pytest.mark.parametrize("seed", SEEDS)
def test_ranges(seed):
    cfg = AmperConfig(capacity=1 << 12, m=20, lam_fr=2.0, v_max=8.0)
    k = prng.key(seed)
    v = group_representatives(k, cfg)
    assert (v.numpy() == ra.representatives(k.numpy(), 20, 8.0)).all()
    lo, hi = fr_intervals(v, cfg)
    rcfg = {"m": 20, "lam_fr": 2.0, "v_max": 8.0, "frac_bits": 24}
    assert list(zip(lo.tolist(), hi.tolist())) == ra.ranges(v.numpy(), rcfg)


def _table(seed, n, v_max, dead=0.1):
    g = torch.Generator().manual_seed(seed)
    p = torch.rand(n, generator=g) * v_max
    p[torch.rand(n, generator=g) < dead] = 0.0
    return p


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("csp_ratio", [0.15, 0.01])
def test_sharded_draw(seed, csp_ratio):
    n, shards, batch = 1 << 12, 4, 512
    p = _table(seed, n, 1.0)
    rcfg = {"m": 20, "lam_fr": 2.0, "v_max": 1.0, "frac_bits": 24,
            "csp_ratio": csp_ratio}
    pq, valid = ra.quantize(p, 1.0, 24), p > 0
    cfg = AmperConfig(capacity=n, m=20, lam_fr=2.0, v_max=1.0,
                      csp_capacity=int(n * csp_ratio), fr_mode="fused")
    s = ShardedAmperSampler(cfg, Mesh([torch.device("cpu")] * shards,
                                      ("data",)), axis_names=("data",))
    st = ShardedAmperState(pq=tuple(pq.clone().view(shards, -1)),
                           valid=tuple(valid.clone().view(shards, -1)))
    got = s.sample(st, prng.key(seed), batch)
    want = ra.sharded_draw(pq, valid, tf.key(seed), batch, rcfg, shards)
    assert torch.equal(got.to(torch.int64), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_table_draw(seed):
    n, batch = 1 << 12, 256
    p = _table(seed, n, 8.0)
    cfg = AmperConfig(capacity=n, m=20, lam_fr=2.0, v_max=8.0,
                      csp_capacity=int(n * 0.15), fr_mode="fused")
    st = AmperState(pq=ra.quantize(p, 8.0, 24), valid=p > 0)
    got = AmperSampler(cfg, device="cpu").sample(st, prng.key(seed), batch)
    rcfg = {"m": 20, "lam_fr": 2.0, "v_max": 8.0, "frac_bits": 24}
    want = ra.table_draw(st.pq, st.valid, tf.key(seed), batch, rcfg,
                         int(n * 0.15))
    assert torch.equal(got.to(torch.int64), want)


def test_write_last_wins():
    n = 64
    cfg = AmperConfig(capacity=n, v_max=1.0)
    idx = torch.tensor([3, 5, 3, 9, 5, 3])
    p = torch.tensor([0.1, 0.2, 0.3, 0.0, 0.5, 0.6])
    st = AmperSampler(cfg, device="cpu").update(
        AmperState(torch.zeros(n, dtype=torch.int32),
                   torch.zeros(n, dtype=torch.bool)), idx, p)
    pq, valid = torch.zeros(n, dtype=torch.int32), torch.zeros(
        n, dtype=torch.bool)
    ra.write_priorities(pq, valid, idx, p, {"v_max": 1.0, "frac_bits": 24})
    assert torch.equal(pq, st.pq) and torch.equal(valid, st.valid)
    assert int(pq[3]) == int(ra.quantize(torch.tensor(0.6), 1.0, 24))


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", (3, 2 ** 31 + 99))
def test_cell_correct(catalog, small, cell, seed):
    config, traffic = small[cell]
    out = run_cell(catalog, cell, seed, 0.2, False, torch.device("cpu"),
                   time.perf_counter(), config=config, cell=traffic)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert all(c["value"] == 0 for c in out["checks"].values())
