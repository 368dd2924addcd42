"""The port's AMPER-fr modules and kernel wrappers against the JAX reference.

Inputs come from numpy with fixed seeds and go to both packages on the
CPU.  Integer paths (quantize, ranges, match, CSP, draws) must agree bit
for bit.  The reference is held on its jnp path (``fr_mode="broadcast"``
and ``kernels/ref.py``): its fused Pallas draw assumes the older threefry
layout and disagrees with its own jnp path under the partitionable one.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.amper as ja
import repro.core.quantize as jqz
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import prng
from repro_torch.core import amper as ta
from repro_torch.core import quantize as tqz
from repro_torch.kernels import build, ops
from repro_torch.kernels.amper_sample import amper_sample_ref
from repro_torch.kernels.ref import multi_query_match_ref, nonzero_static


@pytest.fixture(autouse=True)
def partitionable():
    with jax.threefry_partitionable(True):
        yield


def _eq(a, b) -> bool:
    a = np.asarray(a)
    b = b.numpy()
    return a.shape == b.shape and (a == b).all()


def _table(n: int, seed: int, frac_valid: float = 0.9, v_max: float = 8.0):
    rng = np.random.default_rng(seed)
    p = rng.exponential(1.0, n).astype(np.float32)
    valid = rng.random(n) < frac_valid
    pq = np.asarray(jax.jit(lambda x: jqz.quantize(x, v_max))(p))
    return pq, valid


# --- quantize -----------------------------------------------------------------


def test_quantize_edges_bit_exact():
    v_max = 8.0
    top = (1 << 24) - 1
    step = v_max / top
    p = np.array([0.0, -1.0, step / 2, step * 1.5, step * 2.5, 1e-9, 0.5, 1.0,
                  v_max - step / 2, v_max, v_max * 2, np.inf], np.float32)
    p = np.concatenate([p, np.random.default_rng(0).uniform(
        -1, 9, 4096).astype(np.float32)])
    q = tqz.quantize(torch.from_numpy(p), v_max)
    assert _eq(jqz.quantize(p, v_max), q)
    assert int(q.max()) == top  # the top code, never 2**24
    assert _eq(jqz.dequantize(np.asarray(q), v_max), tqz.dequantize(q, v_max))
    for fb, vm in ((16, 1.0), (24, 1.0), (20, 3.0)):
        assert _eq(jqz.quantize(p, vm, fb), tqz.quantize(torch.from_numpy(p), vm, fb))


def test_prefix_mask_and_ranges_bit_exact():
    d = np.array([-5, -1, 0, 1, 2, 3, 4, 7, 8, 255, 256, 2 ** 24 - 1, 2 ** 24,
                  2 ** 30, 2 ** 31 - 1], np.int32)
    d = np.concatenate([d, np.random.default_rng(1).integers(
        0, 2 ** 31 - 1, 2048).astype(np.int32)])
    m = tqz.prefix_mask(torch.from_numpy(d))
    assert _eq(jqz.prefix_mask(d), m)
    q = np.random.default_rng(2).integers(0, 2 ** 24, d.shape[0]).astype(np.int32)
    lo, hi = tqz.prefix_range(torch.from_numpy(q), m)
    jlo, jhi = jqz.prefix_range(q, np.asarray(m))
    assert _eq(jlo, lo) and _eq(jhi, hi)
    s = np.random.default_rng(3).integers(0, 2 ** 24, d.shape[0]).astype(np.int32)
    assert _eq(jqz.ternary_match(s, q, np.asarray(m)),
               tqz.ternary_match(torch.from_numpy(s), torch.from_numpy(q), m))


# --- group representatives and ranges ------------------------------------------


@pytest.mark.parametrize("m,v_max,lam_fr,exact", [
    (20, 8.0, 2.0, False), (7, 1.0, 1.0, False), (20, 1.0, 0.5, True)])
def test_representatives_and_intervals_bit_exact(m, v_max, lam_fr, exact):
    jc = ja.AmperConfig(capacity=100, m=m, v_max=v_max, lam_fr=lam_fr,
                        exact_radius=exact)
    tc = ta.AmperConfig(capacity=100, m=m, v_max=v_max, lam_fr=lam_fr,
                        exact_radius=exact)
    reps = jax.jit(lambda k: ja.group_representatives(k, jc))
    ivals = jax.jit(lambda v: ja.fr_intervals(v, jc))
    for seed in range(8):
        v = reps(jax.random.key(seed))
        vt = ta.group_representatives(prng.key(seed), tc)
        assert np.asarray(v).view(np.uint32).tolist() == \
            vt.numpy().view(np.uint32).tolist()
        lo, hi = ivals(v)
        tlo, thi = ta.fr_intervals(vt, tc)
        assert _eq(lo, tlo) and _eq(hi, thi)


# --- multi_query_match ----------------------------------------------------------


@pytest.mark.parametrize("n", [1, 128, 1000, 10_001])
def test_multi_query_match_plain_vs_pallas_interpret(n):
    pq, valid = _table(n, seed=n)
    jc = ja.AmperConfig(capacity=n, m=20, v_max=8.0, lam_fr=2.0)
    lo, hi = jax.jit(lambda k: ja.fr_intervals(
        ja.group_representatives(k, jc), jc))(jax.random.key(n))
    sel, counts = jops.multi_query_match(jnp.asarray(pq), jnp.asarray(valid),
                                         lo, hi, interpret=True)
    tsel, tcounts = ops.multi_query_match(
        torch.from_numpy(pq), torch.from_numpy(valid),
        torch.from_numpy(np.asarray(lo)), torch.from_numpy(np.asarray(hi)))
    assert _eq(sel, tsel) and _eq(counts, tcounts)
    rsel, rcounts = jref.multi_query_match_ref(jnp.asarray(pq),
                                               jnp.asarray(valid), lo, hi)
    assert _eq(rsel, tsel) and _eq(rcounts, tcounts)


def _multi_query_match_emulated(pq, valid, lo, hi, threads, loads, grid_cap):
    """csrc/multi_query_match.cu in plain torch: a grid of
    min(tiles, grid_cap) blocks walks the tiles of 4 x threads x loads
    rows (block b takes tiles b, b + grid, ...); thread t's load l covers
    rows 4 threads l + 4 t .. +3; each thread counts its rows per range
    across all its tiles, warps and then the block sum them into the
    block's partial (range-major scratch), and the last block to take a
    ticket, whichever it is, sums every block's partial per range."""
    n, m = pq.shape[0], lo.shape[0]
    rows = 4 * threads * loads
    ntiles = -(-n // rows)
    grid = max(1, min(ntiles, grid_cap))
    pad = ntiles * rows - n
    p = torch.cat([pq, torch.full((pad,), -1, dtype=torch.int32)])
    v = torch.cat([valid, torch.zeros(pad, dtype=torch.bool)])
    sel = torch.zeros(ntiles * rows, dtype=torch.bool)
    partial = torch.zeros(m * grid, dtype=torch.int64)
    for b in range(grid):
        per_thread = torch.zeros(m, threads, dtype=torch.int64)
        for t in range(b, ntiles, grid):
            rs = slice(t * rows, (t + 1) * rows)
            hit = (v[rs][None] & (p[rs][None] >= lo[:, None])
                   & (p[rs][None] <= hi[:, None]))       # (m, rows)
            sel[rs] = hit.any(0)
            per_thread += hit.reshape(m, loads, threads, 4).sum((1, 3))
        per_warp = per_thread.reshape(m, threads // 32, 32).sum(2)
        partial[torch.arange(m) * grid + b] = per_warp.sum(1)
    counts = partial.reshape(m, grid).sum(1)
    return sel[:n], counts.to(torch.int32)


@pytest.mark.parametrize("threads,loads,grid_cap",
                         [(256, 2, 264), (32, 1, 3), (64, 4, 5)])
@pytest.mark.parametrize("n,m", [(1, 1), (700, 20), (10_001, 20),
                                 (4097, 64), (3001, 1), (0, 20)])
def test_multi_query_match_decomposition_vs_pallas_interpret(n, m, threads,
                                                             loads, grid_cap):
    """The kernel's one-launch decomposition (the built grid of 2 blocks
    an SM on 132 SMs, and small grids whose blocks walk several tiles)
    equals the reference's Pallas kernel in interpret mode and the plain
    version, at m = 1, 20 and 64, ragged tails and an empty table."""
    pq, valid = _table(max(n, 1), seed=n + m)
    pq, valid = np.array(pq[:n]), np.array(valid[:n])
    jc = ja.AmperConfig(capacity=max(n, m), m=m, v_max=8.0, lam_fr=2.0)
    lo, hi = jax.jit(lambda k: ja.fr_intervals(
        ja.group_representatives(k, jc), jc))(jax.random.key(n + 1))
    tlo, thi = (torch.from_numpy(np.array(x)) for x in (lo, hi))
    got = _multi_query_match_emulated(torch.from_numpy(pq),
                                      torch.from_numpy(valid), tlo, thi,
                                      threads, loads, grid_cap)
    plain = multi_query_match_ref(torch.from_numpy(pq),
                                  torch.from_numpy(valid), tlo, thi)
    assert torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])
    if n:  # the reference's kernel takes no empty table
        sel, counts = jops.multi_query_match(jnp.asarray(pq),
                                             jnp.asarray(valid), lo, hi,
                                             interpret=True)
        assert _eq(sel, got[0]) and _eq(counts, got[1])


I32_MIN, I32_MAX = -2 ** 31, 2 ** 31 - 1


def _float_range_test(pq, valid, lo, hi):
    """onepass.cuh's range test in float32: the window [A, B] of the
    non-empty ranges; when B - A < 2^24, x = valid ? clamp(p, A - 1,
    B + 1) - A : -1, L = 1 - (lo - A), H = hi - A + 1 (empty ranges:
    -inf), and a hit is sat(x + L) * sat(H - x).  Returns the (m, n)
    hits, or None where the kernels take the integer test."""
    live = lo <= hi
    if not bool(live.any()):
        return None
    a, b = int(lo[live].min()), int(hi[live].max())
    if b - a >= 1 << 24:
        return None
    x = torch.where(valid, (pq.long().clamp(a - 1, b + 1) - a).float(),
                    torch.tensor(-1.0))
    inf = torch.tensor(float("-inf"))
    l = torch.where(live, (1 - (lo.long() - a)).float(), inf)
    h = torch.where(live, (hi.long() - a + 1).float(), inf)
    assert x.dtype == l.dtype == h.dtype == torch.float32
    t1 = (x[None] + l[:, None]).clamp(0.0, 1.0)  # add.sat.f32
    t2 = (h[:, None] - x[None]).clamp(0.0, 1.0)  # sub.sat.f32
    return t1 * t2


@pytest.mark.parametrize("case", ["amper_m20", "amper_m64", "edges",
                                  "span_2p24_minus_1", "span_2p24",
                                  "negative", "empty_mixed", "int_max",
                                  "all_empty"])
def test_float_range_test_is_exact(case):
    """The kernels' float form of lo <= p <= hi gives exactly the integer
    test, or hands the call to the integer test, on AMPER tables and on
    rows at and beside every window edge and int32 extreme."""
    if case.startswith("amper"):
        m = int(case[-2:])
        pq, valid = (torch.from_numpy(x) for x in _table(5000, seed=m))
        cfg = ta.AmperConfig(capacity=5000, m=m, v_max=8.0, lam_fr=2.0)
        lo, hi = ta.fr_intervals(ta.group_representatives(prng.key(m), cfg),
                                 cfg)
        want_fp = True
    else:
        a = {"negative": -3000, "int_max": I32_MAX - 40}.get(case, 10_000)
        span = {"span_2p24_minus_1": (1 << 24) - 1, "span_2p24": 1 << 24,
                "int_max": 40}.get(case, 500)
        b = a + span
        lo = torch.tensor([a, a + 7, b, a + 3], dtype=torch.int32)
        hi = torch.tensor([a + 5, b - 1, b, a + 3], dtype=torch.int32)
        if case in ("empty_mixed", "all_empty"):
            lo = torch.cat([lo, torch.tensor([I32_MAX, a + 9, 0],
                                             dtype=torch.int32)])
            hi = torch.cat([hi, torch.tensor([I32_MIN, a + 8, -1],
                                             dtype=torch.int32)])
        if case == "all_empty":
            lo, hi = hi[4:] + 1, hi[4:]
        near = [v + d for v in (a, a + 3, a + 5, a + 7, b - 1, b)
                for d in range(-2, 3)]
        rows = [r for r in near + [I32_MIN, I32_MAX, 0, -1]
                if I32_MIN <= r <= I32_MAX]
        pq = torch.tensor(rows * 2, dtype=torch.int32)
        valid = torch.tensor([True] * len(rows) + [False] * len(rows))
        want_fp = case not in ("span_2p24", "all_empty")
    hits = _float_range_test(pq, valid, lo, hi)
    assert (hits is not None) == want_fp
    if hits is not None:
        exact = (valid[None] & (pq[None] >= lo[:, None])
                 & (pq[None] <= hi[:, None])).float()
        assert torch.equal(hits, exact)


def test_nonzero_static_matches_jnp():
    rng = np.random.default_rng(4)
    for n, size, frac in ((50, 10, 0.5), (50, 80, 0.3), (7, 3, 0.0), (9, 9, 1.0)):
        mask = rng.random(n) < frac
        (want,) = jnp.nonzero(mask, size=size, fill_value=-1)
        assert _eq(want.astype(jnp.int64), nonzero_static(torch.from_numpy(mask), size))


# --- the fused draw's plain version and the samplers -------------------------------


CASES = [  # n, csp_capacity, batch, frac_valid
    (20_000, 3_000, 64, 0.9),    # ordinary CSP
    (5_000, 64, 300, 1.0),       # truncated CSP, batch > CSP
    (3_000, 100, 16, 0.0),       # empty table: uniform fallback
    (1_001, 2_000, 50, 0.5),     # CSP capacity > table
]


@pytest.mark.parametrize("n,cap,batch,frac", CASES)
def test_amper_sample_plain_vs_reference_pipeline(n, cap, batch, frac):
    """amper_sample_ref == the reference's _compact + sample_from_csp under
    the same rotation and key (the kernel's contract)."""
    pq, valid = _table(n, seed=cap, frac_valid=frac)
    jc = ja.AmperConfig(capacity=n, m=20, v_max=8.0, lam_fr=2.0,
                        csp_capacity=cap)
    kv, kroll, kpick = jax.random.split(jax.random.key(n), 3)

    @jax.jit
    def reference(pq, valid, kv, kroll, kpick):
        lo, hi = ja.fr_intervals(ja.group_representatives(kv, jc), jc)
        sel, _ = jref.multi_query_match_ref(pq, valid, lo, hi)
        csp = ja._compact(sel, cap, kroll)
        idx = ja.sample_from_csp(csp, kpick, batch,
                                 jnp.sum(valid.astype(jnp.int32)))
        shift = jax.random.randint(kroll, (), 0, n)
        return idx, lo, hi, shift, csp.count

    idx, lo, hi, shift, count = reference(jnp.asarray(pq), jnp.asarray(valid),
                                          kv, kroll, kpick)
    tidx, stats = ops.amper_sample(
        torch.from_numpy(pq), torch.from_numpy(valid),
        torch.from_numpy(np.asarray(lo)), torch.from_numpy(np.asarray(hi)),
        int(shift), prng.key_data(jax.random.key_data(kpick)),
        batch=batch, csp_capacity=cap)
    assert _eq(idx, tidx)
    assert int(stats[3]) == int(count)
    assert int(stats[2]) == int(valid.sum())


@pytest.mark.parametrize("n,cap,batch,frac", CASES)
def test_sampler_every_fr_mode_vs_reference_broadcast(n, cap, batch, frac):
    pq, valid = _table(n, seed=batch, frac_valid=frac)
    jc = ja.AmperConfig(capacity=n, m=20, v_max=8.0, lam_fr=2.0,
                        csp_capacity=cap)
    smp = ja.AmperSampler(jc)
    draw = jax.jit(lambda st, k: smp.sample(st, k, batch))
    jstate = ja.AmperState(jnp.asarray(pq), jnp.asarray(valid))
    want = [np.asarray(draw(jstate, jax.random.key(s))) for s in range(2)]
    for mode in ta.FR_MODES:
        tc = ta.AmperConfig(capacity=n, m=20, v_max=8.0, lam_fr=2.0,
                            csp_capacity=cap, fr_mode=mode)
        tsmp = ta.AmperSampler(tc, device="cpu")
        tstate = ta.AmperState(torch.from_numpy(pq), torch.from_numpy(valid))
        for s in range(2):
            assert (want[s] == tsmp.sample(tstate, prng.key(s), batch).numpy()).all(), mode


def test_build_csp_matches_reference():
    n, cap = 4_000, 500
    pq, valid = _table(n, seed=11)
    jc = ja.AmperConfig(capacity=n, m=20, v_max=8.0, lam_fr=2.0, csp_capacity=cap)
    csp = jax.jit(lambda p, v, k: ja.build_csp_fr(p, v, k, jc))(
        jnp.asarray(pq), jnp.asarray(valid), jax.random.key(5))
    for mode in ta.FR_MODES:
        tc = ta.AmperConfig(capacity=n, m=20, v_max=8.0, lam_fr=2.0,
                            csp_capacity=cap, fr_mode=mode)
        tcsp = ta.build_csp_fr(torch.from_numpy(pq), torch.from_numpy(valid),
                               prng.key(5), tc)
        assert _eq(csp.indices, tcsp.indices) and _eq(csp.count, tcsp.count)
        assert _eq(csp.selected, tcsp.selected)


def test_update_priorities_and_uniform_sampler():
    n = 64
    rng = np.random.default_rng(6)
    idx = rng.integers(0, n, 40).astype(np.int32)   # with duplicates
    prio = rng.uniform(0, 2, 40).astype(np.float32)
    prio[::7] = 0.0
    jc = ja.AmperConfig(capacity=n, v_max=2.0)
    jsmp = ja.AmperSampler(jc)
    js = jax.jit(jsmp.update)(jsmp.init(), idx, prio)
    tsmp = ta.AmperSampler(ta.AmperConfig(capacity=n, v_max=2.0), device="cpu")
    ts = tsmp.update(tsmp.init(), torch.from_numpy(idx).long(),
                     torch.from_numpy(prio))
    assert _eq(js.pq, ts.pq) and _eq(js.valid, ts.valid)
    np.testing.assert_array_equal(np.asarray(jsmp.priorities(js)),
                                  tsmp.priorities(ts).numpy())
    ju = ja.UniformSampler(n)
    us = jax.jit(ju.update)(ju.init(), idx, prio)
    tu = ta.UniformSampler(n, device="cpu")
    uts = tu.update(tu.init(), torch.from_numpy(idx).long(), torch.from_numpy(prio))
    assert _eq(us.valid, uts.valid)
    assert _eq(jax.jit(lambda s, k: ju.sample(s, k, 33))(us, jax.random.key(2)),
               tu.sample(uts, prng.key(2), 33))


def test_fused_refuses_wide_fractions_like_the_reference():
    cfg = ta.AmperConfig(capacity=256, frac_bits=28, fr_mode="fused")
    smp = ta.AmperSampler(cfg, device="cpu")
    with pytest.raises(ValueError, match="frac_bits"):
        smp.sample(smp.init(), prng.key(0), 8)


# --- wrappers: no silent fallback -----------------------------------------------------


def _meta_table(n=256, m=20):
    return (torch.empty(n, dtype=torch.int32, device="meta"),
            torch.empty(n, dtype=torch.bool, device="meta"),
            torch.empty(m, dtype=torch.int32, device="meta"),
            torch.empty(m, dtype=torch.int32, device="meta"))


def test_wrappers_raise_without_a_kernel_device():
    """A tensor that is not on the CPU asks for the kernel; with no CUDA
    kernel for it the wrapper raises instead of running the plain version."""
    before = dict(ops.launches)
    pq, valid, lo, hi = _meta_table()
    with pytest.raises(RuntimeError, match="no kernel"):
        ops.multi_query_match(pq, valid, lo, hi)
    with pytest.raises(RuntimeError, match="no kernel"):
        ops.amper_sample(pq, valid, lo, hi, 3, prng.key(0), batch=4,
                         csp_capacity=8)
    assert ops.launches == before


def test_wrappers_check_shapes_and_dtypes():
    pq = torch.zeros(16, dtype=torch.int32)
    valid = torch.ones(16, dtype=torch.bool)
    lo = hi = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(TypeError):
        ops.multi_query_match(pq.long(), valid, lo, hi)
    with pytest.raises(ValueError):
        ops.multi_query_match(pq, valid[:8], lo, hi)
    with pytest.raises(ValueError):
        ops.amper_sample(pq, valid, lo, hi, 16, prng.key(0), batch=4,
                         csp_capacity=8)


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "BUILD", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build_all()


def test_plain_path_takes_offset_views():
    """Only the kernels need aligned tables; on the CPU an offset view is
    matched like a fresh copy of it."""
    pq, valid = (torch.from_numpy(x) for x in _table(1001, seed=5))
    cfg = ta.AmperConfig(capacity=1001, m=20, v_max=8.0, lam_fr=2.0)
    lo, hi = ta.fr_intervals(ta.group_representatives(prng.key(5), cfg), cfg)
    got = ops.multi_query_match(pq[1:], valid[1:], lo, hi)
    want = ops.multi_query_match(pq[1:].clone(), valid[1:].clone(), lo, hi)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_kernel_build_tracks_shared_headers(monkeypatch, tmp_path):
    """A library is named by its source and the shared headers, so editing
    ``common.cuh`` rebuilds every kernel."""
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("// v1\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = build._target(tmp_path / "k.cu")
    (tmp_path / "common.cuh").write_text("// v2\n")
    assert build._target(tmp_path / "k.cu") != before


# --- on the card ---------------------------------------------------------------------


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("n,m", [(1, 20), (1000, 20), (100_003, 20),
                                 (250_000, 20), (250_000, 64), (4097, 1),
                                 (0, 20)])
def test_cuda_multi_query_match_equals_plain(n, m):
    _need_cuda()
    pq, valid = _table(max(n, 1), seed=n)
    cfg = ta.AmperConfig(capacity=max(n, m), m=m, v_max=8.0, lam_fr=2.0)
    lo, hi = ta.fr_intervals(ta.group_representatives(prng.key(n), cfg), cfg)
    args = [torch.from_numpy(np.array(x[:n])).cuda() for x in (pq, valid)] \
        + [lo.cuda(), hi.cuda()]
    sel, counts = ops.multi_query_match(*args)
    psel, pcounts = multi_query_match_ref(*args)
    assert torch.equal(sel, psel) and torch.equal(counts, pcounts)


@pytest.mark.cuda
def test_cuda_multi_query_match_back_to_back():
    """Calls queued with no sync in between, over three range sets, each
    equal to the plain version: the per-range words a call leaves behind
    must be zero for the next."""
    _need_cuda()
    pq, valid = (torch.from_numpy(x).cuda() for x in _table(250_000, seed=3))
    cfg = ta.AmperConfig(capacity=250_000, m=20, v_max=8.0, lam_fr=2.0)
    sets = [tuple(x.cuda() for x in ta.fr_intervals(
        ta.group_representatives(prng.key(s), cfg), cfg)) for s in range(3)]
    want = [multi_query_match_ref(pq, valid, *r) for r in sets]
    got = [ops.multi_query_match(pq, valid, *sets[i % 3]) for i in range(300)]
    for i, (sel, counts) in enumerate(got):
        assert torch.equal(sel, want[i % 3][0])
        assert torch.equal(counts, want[i % 3][1])


@pytest.mark.cuda
@pytest.mark.parametrize("n,cap,batch,frac", CASES)
def test_cuda_amper_sample_equals_plain(n, cap, batch, frac):
    _need_cuda()
    pq, valid = _table(n, seed=cap, frac_valid=frac)
    cfg = ta.AmperConfig(capacity=n, m=20, v_max=8.0, lam_fr=2.0)
    lo, hi = ta.fr_intervals(ta.group_representatives(prng.key(1), cfg), cfg)
    args = [torch.from_numpy(x).cuda() for x in (pq, valid)] + [lo.cuda(), hi.cuda()]
    got = ops.amper_sample(*args, n // 3, prng.key(2), batch=batch,
                           csp_capacity=cap)
    want = amper_sample_ref(*args, n // 3, prng.key(2), batch=batch,
                            csp_capacity=cap)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_cuda_wrappers_refuse_offset_views():
    _need_cuda()
    pq, valid = (torch.from_numpy(x).cuda() for x in _table(1001, seed=5))
    lo = hi = torch.zeros(3, dtype=torch.int32, device="cuda")
    before = dict(ops.launches)
    with pytest.raises(ValueError, match="boundary"):
        ops.multi_query_match(pq[1:], valid[1:], lo, hi)
    with pytest.raises(ValueError, match="boundary"):
        ops.amper_sample(pq[1:], valid[1:], lo, hi, 3, prng.key(0), batch=4,
                         csp_capacity=8)
    assert ops.launches == before
