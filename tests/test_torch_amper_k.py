"""The port's AMPER-k, its other AMPER-fr modes, the probes and the
Fig. 7 twin against the JAX reference.

Inputs come from numpy with fixed seeds and go to both packages on the
CPU; the reference runs jitted.  Every comparison here is exact: the
CSP build is an integer path (quantized priorities, counts, radii,
masks, compaction), and the probes are the same numpy arithmetic.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.amper as ja
import repro.core.quantize as jqz
import repro.core.samplers as jsm
import repro.obs.probes as jprobes
from benchmarks import fig7_sampling_error as jfig7
from benchmarks import torch_fig7_sampling_error as tfig7
from repro_torch import prng
from repro_torch.core import amper as ta
from repro_torch.core import samplers as tsm
from repro_torch.obs import probes as tprobes


@pytest.fixture(autouse=True)
def partitionable():
    with jax.threefry_partitionable(True):
        yield


def _eq(a, b) -> bool:
    a = np.asarray(a)
    b = b.numpy()
    return a.shape == b.shape and (a == b).all()


def _quantized(p, v_max):
    return np.array(jax.jit(lambda x: jqz.quantize(x, v_max))(p))


def _case(name: str):
    """(pq, valid, config kwargs) of one table."""
    rng = np.random.default_rng(sum(map(ord, name)))
    n = 3000
    kw = dict(capacity=n, m=20, lam=0.05, v_max=8.0, csp_capacity=600)
    p = rng.exponential(1.0, n).astype(np.float32)
    valid = rng.random(n) < 0.9
    if name == "ties":             # few distinct values: ties everywhere
        p = (rng.integers(0, 6, n) * 0.8).astype(np.float32)
        kw.update(lam=0.2)
    elif name == "uniform_m7":     # Fig. 7's law, another m, a wider lam
        p = rng.random(n).astype(np.float32)
        kw.update(m=7, v_max=1.0, lam=0.3)
    elif name == "truncated":      # more members than the CSP holds
        kw.update(lam=0.4, csp_capacity=40)
    elif name == "empty":
        valid[:] = False
    elif name == "one_live":
        valid[:] = False
        valid[1234] = True
    elif name == "n_i_zero":       # round(lam V C) = 0 for every group
        kw.update(lam=0.0)
    return _quantized(p, kw["v_max"]), valid, kw


CASES = ["exp", "ties", "uniform_m7", "truncated", "empty", "one_live",
         "n_i_zero"]


@pytest.mark.parametrize("mode", ta.KNN_MODES)
@pytest.mark.parametrize("case", CASES)
def test_build_csp_k_bit_exact(case, mode):
    pq, valid, kw = _case(case)
    jc = ja.AmperConfig(**kw, knn_mode=mode)
    tc = ta.AmperConfig(**kw, knn_mode=mode)

    @jax.jit
    def reference(pq, valid, key):
        kv, _ = jax.random.split(key)
        v_rep = ja.group_representatives(kv, jc)
        counts = ja.group_counts(pq, valid, jc)
        return (ja.build_csp_k(pq, valid, key, jc), counts,
                ja.knn_sizes(v_rep, counts, jc))

    tpq, tvalid = torch.from_numpy(pq), torch.from_numpy(valid)
    for seed in (3, 4):
        csp, counts, n_i = reference(jnp.asarray(pq), jnp.asarray(valid),
                                     jax.random.key(seed))
        tcounts = ta.group_counts(tpq, tvalid, tc)
        kv, _ = prng.split(prng.key(seed))
        assert _eq(counts, tcounts)
        assert _eq(n_i, ta.knn_sizes(ta.group_representatives(kv, tc),
                                     tcounts, tc))
        tcsp = ta.build_csp_k(tpq, tvalid, prng.key(seed), tc)
        assert _eq(csp.selected, tcsp.selected)
        assert _eq(csp.indices, tcsp.indices) and _eq(csp.count, tcsp.count)
        if case == "n_i_zero" or case == "empty":
            assert int(tcsp.count) == 0


@pytest.mark.parametrize("mode", ta.KNN_MODES)
def test_amper_k_sampler_draws_bit_exact(mode):
    pq, valid, kw = _case("exp")
    jsmp = ja.AmperSampler(ja.AmperConfig(**kw, knn_mode=mode), "k")
    tsmp = ta.AmperSampler(ta.AmperConfig(**kw, knn_mode=mode), "k",
                           device="cpu")
    draw = jax.jit(lambda st, k: jsmp.sample(st, k, 64))
    jst = ja.AmperState(jnp.asarray(pq), jnp.asarray(valid))
    tst = ta.AmperState(torch.from_numpy(pq), torch.from_numpy(valid))
    for seed in range(3):
        got = tsmp.sample(tst, prng.key(seed), 64)
        assert _eq(draw(jst, jax.random.key(seed)), got)
        assert got.dtype == torch.int32


def test_knn_modes_differ_in_what_they_keep():
    """Sort ranks by distance (ties by index); bisect and hist take every
    row within the radius that reaches N_i and keep the first N_i by
    index.  Rows 10, 12, 11 around V = 11 with N = 2: sort keeps rows 2
    and 0, the bisections rows 0 and 1, as the reference does."""
    pq = np.array([10, 12, 11], np.int32)
    valid = np.ones(3, bool)
    vq, n_i = np.array([11], np.int32), np.array([2], np.int32)
    want = {"sort": [True, False, True], "bisect": [True, True, False],
            "hist": [True, True, False]}
    args = [torch.from_numpy(x) for x in (pq, valid, vq, n_i)]
    got = {"sort": ta._knn_select_sort(*args),
           "bisect": ta._knn_select_bisect(*args, 24),
           "hist": ta._knn_select_hist(*args, 24)}
    for mode in ta.KNN_MODES:
        assert got[mode][0].tolist() == want[mode], mode
    jargs = [jnp.asarray(x) for x in (pq, valid, vq, n_i)]
    assert np.asarray(ja._knn_select_sort(*jargs))[0].tolist() == want["sort"]
    assert np.asarray(ja._knn_select_bisect(*jargs, 24))[0].tolist() == \
        want["bisect"]
    assert np.asarray(ja._knn_select_hist(*jargs, 24))[0].tolist() == \
        want["hist"]


@pytest.mark.parametrize("mode", ["interval", "window"])
@pytest.mark.parametrize("case", ["exp", "uniform_m7", "truncated", "empty",
                                  "one_live", "exact_radius"])
def test_fr_interval_and_window_bit_exact(case, mode):
    """The two AMPER-fr modes against the reference's same mode, and
    against the port's broadcast mode."""
    pq, valid, kw = _case("exp" if case == "exact_radius" else case)
    kw = {k: v for k, v in kw.items() if k != "lam"}
    kw.update(lam_fr=2.0, exact_radius=case == "exact_radius")
    jc = ja.AmperConfig(**kw, fr_mode=mode)
    tc = ta.AmperConfig(**kw, fr_mode=mode)
    build = jax.jit(lambda p, v, k: ja.build_csp_fr(p, v, k, jc))
    tpq, tvalid = torch.from_numpy(pq), torch.from_numpy(valid)
    for seed in (5, 6):
        csp = build(jnp.asarray(pq), jnp.asarray(valid), jax.random.key(seed))
        tcsp = ta.build_csp_fr(tpq, tvalid, prng.key(seed), tc)
        plain = ta.build_csp_fr(tpq, tvalid, prng.key(seed),
                                tc._replace(fr_mode="broadcast"))
        for got in (tcsp, plain):
            assert _eq(csp.selected, got.selected)
            assert _eq(csp.indices, got.indices)
            assert _eq(csp.count, got.count)


def test_amper_k_registered_with_the_reference_vocabulary():
    assert tsm.available_samplers() == jsm.available_samplers()
    smp = tsm.make_sampler("amper-k", 500, device="cpu", csp_ratio=0.2,
                           m=8, v_max=8.0, min_csp=16)
    assert isinstance(smp, tsm.Sampler) and smp.variant == "k"
    for kw in ({}, dict(csp_ratio=0.2, m=8, v_max=8.0, min_csp=16),
               dict(lam=0.3, knn_mode="hist", fr_mode="window",
                    csp_capacity=77)):
        jcfg = jsm._amper_config(500, **kw)
        assert tsm._amper_config(500, **kw)._asdict() == jcfg._asdict()
    assert smp.cfg.lam == 0.1 and smp.cfg.knn_mode == "bisect"
    st = smp.update(smp.init(), torch.arange(10),
                    torch.linspace(0.1, 2.0, 10))
    idx = smp.sample(st, prng.key(0), 32)
    assert idx.shape == (32,) and bool((idx < 10).all())
    assert float(smp.total(st)) == pytest.approx(10.5, rel=1e-5)
    with pytest.raises(ValueError, match="knn_mode"):
        ta.AmperSampler(ta.AmperConfig(capacity=8, knn_mode="nope"), "k",
                        device="cpu")
    with pytest.raises(ValueError, match="variant"):
        ta.AmperSampler(ta.AmperConfig(capacity=8), "x", device="cpu")


def test_probes_equal_the_reference():
    rng = np.random.default_rng(0)
    assert tprobes.BINS == jprobes.BINS
    values = rng.random(5000)
    assert (tprobes.priority_bin_counts(values)
            == jprobes.priority_bin_counts(values)).all()
    for p, q in ((rng.integers(0, 50, 64), rng.integers(0, 50, 64)),
                 (np.zeros(64), rng.integers(0, 9, 64))):
        assert tprobes.kl_nats(p, q) == jprobes.kl_nats(p, q)
        assert tprobes.chi_square(p, q) == jprobes.chi_square(p, q)


@pytest.mark.parametrize("variant", ["k", "fr"])
def test_fig7_twin_counts_equal_the_reference(variant):
    """At n = 1,000, m = 8, lambda' = 2.0 (lambda = 0.2): the twin's
    priorities are the reference's bit for bit, and its AMPER sample
    counts over the 100 draws equal the reference's exactly."""
    n, m, lam = 1000, 8, 2.0
    key = jax.random.key(0)
    prio = jax.random.uniform(jax.random.fold_in(key, 99), (n,))
    prio_np = np.asarray(prio)
    cfg = ja.AmperConfig(capacity=n, m=m, lam=lam / 10.0, lam_fr=lam,
                         v_max=1.0, csp_capacity=max(int(0.2 * n), 64),
                         knn_mode="bisect")
    s = ja.AmperSampler(cfg, variant)
    want = jfig7.sample_counts(s, s.update(s.init(), jnp.arange(n), prio),
                               jax.random.fold_in(key, 7), prio_np)

    tkey, tprio, tprio_np = tfig7._table(n, 0, "cpu")
    assert (tprio_np == prio_np).all()
    ts = tfig7.amper_sampler(n, m, lam, variant, 0.2, "cpu")
    got = tfig7.sample_counts(ts, tfig7._filled(ts, tprio),
                              prng.fold_in(tkey, 7), tprio_np)
    assert (got == want).all() and got.sum() == 64 * 100
