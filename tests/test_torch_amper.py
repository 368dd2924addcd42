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
from repro_torch.kernels import amper_sample as tsample
from repro_torch.kernels import build, ops
from repro_torch.kernels.amper_sample import amper_sample_ref
from repro_torch.kernels.ref import multi_query_match_ref, nonzero_static


CPU = torch.device("cpu")


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


# --- the one-launch kernels' decompositions, emulated in torch ----------------
#
# csrc/onepass.cuh in plain Python: tiles of 4 x threads x loads rows;
# membership words built from each (thread, load)'s 4-row nibble; word
# prefixes; tile prefixes by decoupled look-back over epoch-tagged status
# words that blocks publish in a random interleaving, over stale words of
# earlier calls; the card-side epoch, ticket and done counter of a scratch
# that lives across calls (finish_call).  test_torch_sharded.py emulates
# csrc/rank_select.cu with these; csrc/amper_sample.cu is emulated below.

AGG, INC = 1, 2
MAX_EPOCH = (1 << 30) - 1
ZERO_WORD = (0, 0, 0)  # (epoch, flag, count) of a status word


def _member_words(sel_tile, threads, loads):
    """The kernel's shared words: thread t's load l covers rows
    4 threads l + 4 t .. +3, whose nibble lands in bits 4 (t % 8) .. of
    word l threads / 8 + t // 8 (ORed over 8 lanes by shuffles)."""
    words = [0] * (threads * loads // 8)
    for l in range(loads):
        for t in range(threads):
            nib = 0
            for k in range(4):
                nib |= int(sel_tile[4 * threads * l + 4 * t + k]) << k
            words[l * threads // 8 + t // 8] |= nib << (4 * (t % 8))
    return words


def _nth_set_bit(x, k):
    pos = 0
    for w in (16, 8, 4, 2, 1):
        low = x & ((1 << w) - 1)
        c = bin(low).count("1")
        if k >= c:
            k, x, pos = k - c, x >> w, pos + w
        else:
            x = low
    return pos


def _resolve(words, pre, lr):
    lo, hi = 0, len(words) - 1
    while lo < hi:  # the largest word whose prefix is <= lr
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if pre[mid] <= lr else (lo, mid - 1)
    return 32 * lo + _nth_set_bit(words[lo], lr - pre[lo])


def _members(pq, valid, lo, hi):
    """Membership as the kernels test it: the float test where the
    window allows it, else the integer one."""
    hits = _float_range_test(pq, valid, lo, hi)
    if hits is None:
        hits = (valid[None] & (pq[None] >= lo[:, None])
                & (pq[None] <= hi[:, None]))
    return hits.bool().any(0)


def _tiles(pq, valid, lo, hi, threads, loads):
    """Per tile: (words, word prefixes, members, live rows)."""
    n, rows = pq.shape[0], 4 * threads * loads
    nblk = -(-n // rows)
    sel = torch.zeros(nblk * rows, dtype=torch.bool)
    sel[:n] = _members(pq, valid, lo, hi)
    out = []
    for t in range(nblk):
        tile = sel[t * rows:(t + 1) * rows]
        words = _member_words(tile, threads, loads)
        # the words hold the tile's membership in index order
        assert [(words[r // 32] >> (r % 32)) & 1 for r in range(rows)] == \
            tile.int().tolist()
        pc = [bin(w).count("1") for w in words]
        out.append((words, [sum(pc[:i]) for i in range(len(pc))], sum(pc),
                    int(valid[t * rows:(t + 1) * rows].sum())))
    return out


class _Scratch:
    """A kernel's scratch words as the card keeps them across calls: the
    ticket, the done counter (blocks, and amper_sample's live rows), the
    epoch word, a status word a tile and amper_sample's s_shift word, all
    zero when made."""

    def __init__(self, capacity):
        self.ticket = self.done = self.live = self.epoch_word = 0
        self.status = [ZERO_WORD] * capacity
        self.shift_word = ZERO_WORD

    def plant(self, rng, epochs):
        """Every status word set to a word of one of ``epochs`` with a
        random flag and count."""
        self.status = [(int(rng.choice(epochs)), int(rng.integers(1, 3)),
                        int(rng.integers(0, 99))) for _ in self.status]

    def finish(self, epoch):
        """finish_call, by the block that completed the done count."""
        if epoch == MAX_EPOCH:
            self.status = [ZERO_WORD] * len(self.status)
            self.shift_word = ZERO_WORD
            self.epoch_word = 0
        else:
            self.epoch_word = epoch


def _flag(word, epoch):
    return word[1] if word[0] == epoch else 0


def _walk(t, status, members, epoch, rng):
    """Tile t's look-back (onepass::lookback), a generator that yields
    where the warp spins or ends a round: 32 predecessors a round, nearest
    first; the nearest inclusive word ends it, every aggregate nearer adds
    in.  A lane may read a predecessor's aggregate after that tile has
    gone inclusive.  Returns the exclusive prefix."""
    end, excl = t - 1, 0
    while True:
        window = []
        for lane in range(32):
            pred = end - lane
            word = status[pred] if pred >= 0 else (epoch, INC, 0)
            flag, v = _flag(word, epoch), word[2]
            if pred >= 0 and flag == INC and rng.random() < 0.3:
                flag, v = AGG, members[pred]  # read before it went inclusive
            window.append((flag, v))
        if any(f == 0 for f, _ in window):
            yield  # spins
            continue
        stop = next((i for i, (f, _) in enumerate(window) if f == INC), None)
        excl += sum(v for _, v in window[:32 if stop is None else stop + 1])
        if stop is not None:
            return excl
        end -= 32
        yield


def _interleave(blocks, rng, in_order):
    """Runs the block generators in a random interleaving until all end.
    ``in_order``: blocks start in ticket order (rank_select); else any
    block may move at any time (a cooperative grid, all resident)."""
    running, todo, steps = [], list(range(len(blocks))), 0
    while running or todo:
        steps += 1
        assert steps < 1_000_000, "the blocks deadlock"
        i = int(rng.integers(0, len(running) + bool(todo)))
        if i == len(running):
            k = todo.pop(0 if in_order else int(rng.integers(0, len(todo))))
            running.append(blocks[k]())
        try:
            next(running[i])
        except StopIteration:
            running.pop(i)


def _amper_sample_emulated(pq, valid, lo, hi, shift, key, batch, cap,
                           threads, loads, grid, seed=0, scratch=None,
                           tiles=None):
    """csrc/amper_sample.cu in plain Python: a cooperative grid of
    min(grid, tiles) blocks, block b over tiles b, b + G, ...; each
    publishes its tiles' aggregates, then their inclusive prefixes by
    look-back in tile order; the tile holding ``shift`` publishes the
    members below it; every block reads the total and s_shift, draws the
    ranks by threefry and resolves those in its tiles from their words;
    the block completing the done word writes the stats and the
    fallbacks and moves the scratch's epoch on."""
    rng = np.random.default_rng(seed)
    n, rows = pq.shape[0], 4 * threads * loads
    tiles = tiles or _tiles(pq, valid, lo, hi, threads, loads)
    nblk = len(tiles)
    sc = scratch or _Scratch(nblk)
    if scratch is None:
        sc.plant(rng, [sc.epoch_word])  # an earlier call's words
    members = [tm for _, _, tm, _ in tiles]
    g = min(grid, nblk)
    shift = min(max(int(shift), 0), n)  # members at index < shift
    k_pick, k_fb = prng.split(key)
    pick_bits = prng.bits(k_pick, (batch,)).tolist()
    idx, stats = [None] * batch, None

    def block(b):
        nonlocal stats
        own = list(range(b, nblk, g))
        epoch = sc.epoch_word + 1
        for t in own:  # rows, tests, words: the aggregate
            sc.status[t] = (epoch, INC if t == 0 else AGG, members[t])
            yield
        tpre, below, total = {}, 0 if shift == 0 else None, None
        for t in own:
            prefix = 0
            if t > 0:
                prefix = yield from _walk(t, sc.status, members, epoch, rng)
                sc.status[t] = (epoch, INC, prefix + members[t])
            tpre[t] = prefix
            if t == nblk - 1:
                total = prefix + members[t]
            if 0 < shift < n and t == shift // rows:
                words, pre, _, _ = tiles[t]
                off = shift - t * rows
                below = prefix + pre[off // 32] + bin(
                    words[off // 32] & ((1 << (off % 32)) - 1)).count("1")
                sc.shift_word = (epoch, INC, below)
            yield
        while total is None:
            word = sc.status[nblk - 1]
            if _flag(word, epoch) == INC:
                total = word[2]
            else:
                yield
        if below is None and shift >= n:
            below = total
        while below is None:
            if _flag(sc.shift_word, epoch) == INC:
                below = sc.shift_word[2]
            else:
                yield
        # arrive: this block reads no status word again
        sc.done += 1
        sc.live += sum(tiles[t][3] for t in own)
        if sc.done == g:
            stats = [total, below, sc.live, min(total, cap)]
            if total == 0:
                fb = prng.bits(k_fb, (batch,)).tolist()
                for j in range(batch):
                    idx[j] = fb[j] % max(sc.live, 1)
            sc.done = sc.live = 0
            sc.finish(epoch)
        if total == 0:
            return
        count = min(total, cap)
        for j in range(batch):
            r = (pick_bits[j] % max(count, 1) + below) % total
            for t in own:
                if tpre[t] <= r < tpre[t] + members[t]:
                    assert idx[j] is None  # one writer per draw
                    words, pre, _, _ = tiles[t]
                    idx[j] = t * rows + _resolve(words, pre, r - tpre[t])
        yield

    _interleave([lambda b=b: block(b) for b in range(g)], rng,
                in_order=False)
    assert None not in idx and stats is not None
    return (torch.tensor(idx, dtype=torch.int32).reshape(-1),
            torch.tensor(stats, dtype=torch.int32))


def _draw_table(name):
    """(pq, valid, lo, hi, csp_capacity) of the draw's cases."""
    n = {"n1": 1, "n1023": 1023, "n1024": 1024, "n1025": 1025}.get(name,
                                                                  10_001)
    frac = {"no_live_rows": 0.0, "all_members": 1.0}.get(name, 0.9)
    m = {"m1": 1, "m64": 64}.get(name, 20)
    pq, valid = (torch.from_numpy(np.array(x))
                 for x in _table(n, seed=n + m, frac_valid=frac))
    cfg = ta.AmperConfig(capacity=n, m=m, v_max=8.0, lam_fr=2.0)
    lo, hi = ta.fr_intervals(ta.group_representatives(prng.key(m), cfg), cfg)
    if name == "empty_csp":  # no member, live rows: the fallback draw
        lo, hi = torch.tensor([9, 4], dtype=torch.int32), \
            torch.tensor([3, 2], dtype=torch.int32)
    if name == "all_members":
        lo = torch.tensor([I32_MIN], dtype=torch.int32)
        hi = torch.tensor([I32_MAX], dtype=torch.int32)
    cap = {"truncated_csp": 64}.get(name, 3 * n)
    return pq, valid, lo, hi, cap


DRAW_CASES = ["n1", "n1023", "n1024", "n1025", "n10001", "truncated_csp",
              "empty_csp", "no_live_rows", "all_members", "m1", "m64"]
_draw_want: dict = {}  # (case, shift, batch) -> (idx, stats) of the reference


def _reference_draw(case, pq, valid, lo, hi, shift, seed, batch, cap):
    """The reference's jnp pipeline at a given rotation: _compact of the
    selection rolled by -shift (as _compact rolls it for its key), the
    indices rotated back, then sample_from_csp; held against
    amper_sample_ref.  Cached per case, shift and batch."""
    if (case, shift, batch) not in _draw_want:
        n = pq.shape[0]
        sel, _ = jref.multi_query_match_ref(
            jnp.asarray(pq.numpy()), jnp.asarray(valid.numpy()),
            jnp.asarray(lo.numpy()), jnp.asarray(hi.numpy()))
        csp = ja._compact(jnp.roll(sel, -shift), cap)
        csp = csp._replace(indices=jnp.where(
            csp.indices >= 0, (csp.indices + shift) % n, -1))
        jidx = ja.sample_from_csp(csp, jax.random.key(seed), batch,
                                  jnp.sum(valid.numpy().astype(np.int32)))
        want = amper_sample_ref(pq, valid, lo, hi, shift, prng.key(seed),
                                batch=batch, csp_capacity=cap)
        assert _eq(jidx, want[0]) and int(want[1][3]) == int(csp.count)
        _draw_want[(case, shift, batch)] = want
    return _draw_want[(case, shift, batch)]


@pytest.mark.parametrize("threads,loads", [(128, 2), (32, 1)])
@pytest.mark.parametrize("case", DRAW_CASES)
def test_amper_sample_decomposition_equals_plain_and_reference(case, threads,
                                                                loads):
    """The cooperative draw's decomposition, at the kernel's 1024-row
    tiles and at 128-row tiles (whose look-back crosses 32-tile windows),
    on grids of 1, 3 and 132 x 8 blocks, with shift at 0, n - 1, a tile
    boundary and inside a tile, equals amper_sample_ref and the
    reference's _compact + sample_from_csp exactly (max |err| 0)."""
    pq, valid, lo, hi, cap = _draw_table(case)
    n, rows = pq.shape[0], 4 * threads * loads
    tiles = _tiles(pq, valid, lo, hi, threads, loads)
    shifts = sorted({0, n - 1, min(rows, n - 1), n // 2})
    for i, (shift, grid) in enumerate(
            (s, g) for s in shifts for g in (1, 3, 132 * 8)):
        batch = (1, 64, 300)[i % 3]
        seed = 1000 + shift
        want = _reference_draw(case, pq, valid, lo, hi, shift, seed, batch,
                               cap)
        got = _amper_sample_emulated(pq, valid, lo, hi, shift,
                                     prng.key(seed), batch, cap, threads,
                                     loads, grid, seed=i, tiles=tiles)
        assert torch.equal(got[0], want[0]), (shift, grid)
        assert torch.equal(got[1], want[1]), (shift, grid)


def test_amper_sample_decomposition_over_calls_and_the_epoch_wrap():
    """One scratch over a sequence of draws of varying table sizes, each
    on the words the last one left, across the epoch that wraps: after
    epoch 2^30 - 1 the words are zeroed and the epochs start at 1, so the
    words planted at epoch 1 (a tile no call touched since) never pass for
    the new epoch-1 call's."""
    rng = np.random.default_rng(3)
    pq, valid, lo, hi, cap = _draw_table("n10001")
    sc = _Scratch(-(-pq.shape[0] // 128))
    sc.plant(rng, [1])
    sc.epoch_word = MAX_EPOCH - 3
    for call in range(6):
        # the calls before the wrap leave most planted words in place
        n = int(rng.integers(1, 2000)) if call < 3 else \
            int(rng.integers(5000, pq.shape[0] + 1))
        args = (pq[:n].clone(), valid[:n].clone(), lo, hi)
        shift = int(rng.integers(0, n))
        want = amper_sample_ref(*args, shift, prng.key(call), batch=64,
                                csp_capacity=cap)
        got = _amper_sample_emulated(*args, shift, prng.key(call), 64, cap,
                                     32, 1, 8, seed=call, scratch=sc)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert sc.epoch_word == (MAX_EPOCH - 2 + call) % MAX_EPOCH
        assert sc.done == sc.live == 0


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


def test_amper_sample_takes_shift_and_key_on_the_device():
    """The device form (an int32 0-d shift and an int64 (2,) key on the
    table's device) gives the host form's draw; a tensor of another type
    is refused."""
    pq, valid, lo, hi, cap = _draw_table("n10001")
    for shift in (0, 4321, 10_000):
        k = prng.key(shift)
        want = ops.amper_sample(pq, valid, lo, hi, shift, k, batch=64,
                                csp_capacity=cap)
        got = ops.amper_sample(pq, valid, lo, hi,
                               torch.tensor(shift, dtype=torch.int32),
                               k.clone(), batch=64, csp_capacity=cap)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(TypeError, match="int32"):
        ops.amper_sample(pq, valid, lo, hi, torch.tensor(3), prng.key(0),
                         batch=4, csp_capacity=8)
    with pytest.raises(ValueError, match="shift"):
        ops.amper_sample(pq, valid, lo, hi,
                         torch.tensor(10_001, dtype=torch.int32),
                         prng.key(0), batch=4, csp_capacity=8)


@pytest.mark.parametrize("case", ["host_form", "device_form",
                                  "capture_host_form",
                                  "capture_device_form", "past_max_rows",
                                  "failed_launch"])
def test_amper_sample_wrapper(monkeypatch, case):
    """The CUDA wrapper with the launch recorded instead of run: the host
    form passes shift and the key words as arguments and no pointers, the
    device form passes the tensors' addresses; under graph capture the
    host form is refused (a replay would draw with the captured key) and
    the device form is taken on the scratch its stream already has; a
    table past the kernel's shared-memory limit raises a ValueError that
    names it; a launch that raises drops the scratch."""
    calls = []

    def launch(name, argtypes, device, *args):
        calls.append(args)
        if case == "failed_launch":
            raise RuntimeError("amper_sample launch failed")

    monkeypatch.setattr(tsample.build, "_scratch", {})
    monkeypatch.setattr(tsample.build, "_retired", [])
    monkeypatch.setattr(tsample.build, "stream_key", lambda dev: 0)
    monkeypatch.setattr(tsample.build, "sm_count", lambda dev: 132)
    monkeypatch.setattr(tsample.build, "launch", launch)
    monkeypatch.setattr(tsample, "max_rows",
                        lambda dev: 1000 if case == "past_max_rows" else 1e8)
    capturing = [False]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing[0])
    pq = torch.zeros(2500, dtype=torch.int32)  # 3 tiles
    valid = torch.ones(2500, dtype=torch.bool)
    lo = hi = torch.zeros(3, dtype=torch.int32)
    shift = torch.tensor(7, dtype=torch.int32)
    key = prng.key(5)

    def call(on_card):
        return tsample.amper_sample_cuda(
            pq, valid, lo, hi, *((shift, key) if on_card else (7, key)),
            batch=64, csp_capacity=100)

    def scratch():
        return tsample.build._scratch.get(("amper_sample", CPU, 0))

    if case == "past_max_rows":
        with pytest.raises(ValueError, match="limit of 1000 rows"):
            call(True)
        assert calls == []
        return
    if case.startswith("capture"):
        call(True)  # the warm-up on the stream makes the scratch
        capturing[0] = True
    if case == "failed_launch":
        with pytest.raises(RuntimeError, match="launch failed"):
            call(False)
        assert scratch() is None and len(tsample.build._retired) == 1
        return
    if case == "capture_host_form":
        with pytest.raises(RuntimeError, match="tensors on the card"):
            call(False)
        assert len(calls) == 1
        return
    call(case != "host_form")
    sc = scratch()
    assert sc is not None and sc.numel() == 64 + 32 * 3
    # shift, shift pointer, key words, key pointer; scratch, capacity
    shift_args, tail = calls[-1][6:11], calls[-1][-3:-1]
    assert tail == (sc.data_ptr(), 3)
    k0, k1 = prng.key_data(key).tolist()
    assert shift_args == ((7, None, k0, k1, None) if case == "host_form"
                          else (0, shift.data_ptr(), 0, 0, key.data_ptr()))


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
