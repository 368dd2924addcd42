"""The port's sharded replay and its two new kernels against the JAX reference.

Inputs come from numpy with fixed seeds.  Reference meshes are built as
``jax.sharding.Mesh(devices[:S], ("data",))`` over the 8 forced host
devices (``tests/conftest.py``); the port's are S logical shards on the
CPU.  Integer paths (kernels, membership, draws, updates) must agree bit
for bit.  IS weights agree within rtol 1e-6: the two packages sum the
sharded priorities in different orders.  The
reference's sampling programs run jitted, as its replay buffer and DQN
run them.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

import repro.core.quantize as jqz
from repro.core import replay_buffer as jrb
from repro.core import samplers as jsamplers
from repro.core.amper import AmperConfig as JConfig
from repro.core.amper import AmperState as JState
from repro.core.sharded import ShardedAmperSampler as JSharded
from repro.kernels import ops as jops
from repro_torch import obs, prng
from repro_torch.core import replay_buffer as trb
from repro_torch.core import samplers as tsamplers
from repro_torch.core.amper import AmperConfig, fr_intervals, \
    group_representatives
from repro_torch.core.sharded import (ShardedAmperSampler,
                                      ShardedPERSampler, repartition,
                                      sharded_sample_fr)
from repro_torch.distributed.sharding import Mesh
from repro_torch.kernels import ops
from repro_torch.kernels import amper_sample as tsample
from repro_torch.kernels import write_last as twrite
from repro_torch.kernels.ref import (rank_select_ref, tcam_match_ref,
                                     write_last_ref)
from test_torch_amper import (INC, MAX_EPOCH, _interleave, _Scratch, _tiles,
                              _resolve, _walk)
from test_torch_dqn import thirty_agent_steps

N = 2048
BATCH = 64
CFG = dict(capacity=N, m=20, lam_fr=2.0, v_max=8.0, csp_capacity=600)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def partitionable():
    with jax.threefry_partitionable(True):
        yield


def _jmesh(s):
    if jax.device_count() < s:
        pytest.skip(f"needs {s} host devices (tests/conftest.py forces 8)")
    return JMesh(np.asarray(jax.devices()[:s]), ("data",))


def _tmesh(s):
    return Mesh([CPU] * s)


def _table(n, seed, frac_valid=0.9, v_max=8.0):
    rng = np.random.default_rng(seed)
    p = rng.exponential(1.0, n).astype(np.float32)
    valid = rng.random(n) < frac_valid
    pq = np.asarray(jax.jit(lambda x: jqz.quantize(x, v_max))(p))
    return pq, valid


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


# --- (a), (b): the plain versions against the reference's kernels ------------


def _ranks_for(count):
    return np.array([0, 1, count // 2, count - 1, count, count + 5, -1, -9],
                    np.int32)


@pytest.mark.parametrize("n,frac_valid", [(1, 1.0), (777, 0.9), (5000, 0.8),
                                          (3000, 0.0)])
def test_rank_select_ref_equals_reference_kernel(n, frac_valid):
    pq, valid = _table(n, seed=n, frac_valid=frac_valid)
    cfg = AmperConfig(capacity=n, m=20, lam_fr=2.0, v_max=8.0)
    lo, hi = fr_intervals(group_representatives(prng.key(n), cfg), cfg)
    count = int(rank_select_ref(*_t(pq, valid), lo, hi,
                                torch.zeros(1, dtype=torch.int32))[1])
    assert count > 2 or n == 1 or frac_valid == 0.0  # not a degenerate case
    ranks = _ranks_for(count)
    jidx, jcnt = jops.rank_select(pq, valid, lo.numpy(), hi.numpy(), ranks)
    tidx, tcnt = ops.rank_select(*_t(pq, valid), lo, hi, *_t(ranks))
    np.testing.assert_array_equal(np.asarray(jidx), tidx.numpy())
    assert int(jcnt) == int(tcnt) == count
    assert tidx.dtype == torch.int32 and tcnt.dtype == torch.int32


# --- the one-launch rank_select kernel's decomposition, emulated in torch ------
#
# csrc/rank_select.cu in plain torch, on test_torch_amper.py's emulation
# of onepass.cuh: blocks start in ticket order and move in a random
# interleaving, each takes its tile from the ticket, publishes, finds its
# prefix by look-back and arrives at the done counter; the last to arrive
# resets the ticket and the counter and moves the epoch on.  Each rank is
# resolved by its owning tile from the words alone; the last tile writes
# count and the zeros outside [0, count).


def _rank_call(sc, members, rng):
    """One call's bookkeeping on scratch ``sc``: the tiles' exclusive
    prefixes."""
    nblk = len(members)
    prefix = [None] * nblk

    def block():
        tile, epoch = sc.ticket, sc.epoch_word + 1  # ticket: atomicAdd
        sc.ticket += 1
        assert tile < nblk  # the last call put the ticket back
        sc.status[tile] = (epoch, INC if tile == 0 else 1, members[tile])
        yield
        p = 0
        if tile > 0:
            p = yield from _walk(tile, sc.status, members, epoch, rng)
            sc.status[tile] = (epoch, INC, p + members[tile])
        prefix[tile] = p
        sc.done += 1  # arrive: this block reads no status word again
        if sc.done == nblk:
            sc.ticket = sc.done = 0
            sc.finish(epoch)

    _interleave([block] * nblk, rng, in_order=True)
    return prefix


def _lookback(members, rng, epoch=7):
    """Exclusive tile prefixes of one call at ``epoch``, over status words
    that hold an earlier call's words (another epoch, random flags and
    counts), which must read as unpublished."""
    sc = _Scratch(len(members))
    sc.plant(rng, [epoch - 1])
    sc.epoch_word = epoch - 1
    return _rank_call(sc, members, rng)


def _rank_select_emulated(pq, valid, lo, hi, rank, threads, loads, seed=0):
    rows = 4 * threads * loads
    tiles = _tiles(pq, valid, lo, hi, threads, loads)
    nblk = len(tiles)
    prefix = _lookback([mem for _, _, mem, _ in tiles],
                       np.random.default_rng(seed))
    ranks = rank.tolist()
    idx, count = [None] * len(ranks), None
    for t, (words, pre, members, _) in enumerate(tiles):
        last, total = t == nblk - 1, prefix[t] + members
        if members == 0 and not last:
            continue  # owns no rank
        if last:
            count = total
        for j, r in enumerate(ranks):
            if prefix[t] <= r < total:
                assert idx[j] is None  # one writer per rank
                idx[j] = t * rows + _resolve(words, pre, r - prefix[t])
            elif last and (r < 0 or r >= total):
                assert idx[j] is None
                idx[j] = 0
    assert None not in idx
    return (torch.tensor(idx, dtype=torch.int32).reshape(-1),
            torch.tensor(count, dtype=torch.int32))


def _edge_table(n, members, m=1):
    """pq 7 on the member rows, 3 elsewhere, all valid; the range [7, 7]
    and m - 1 empty ranges."""
    pq = np.full(n, 3, np.int32)
    pq[list(members)] = 7
    lo = torch.tensor([7] + [9] * (m - 1), dtype=torch.int32)
    hi = torch.tensor([7] + [8] * (m - 1), dtype=torch.int32)
    return pq, np.ones(n, bool), lo, hi


def _rank_case(name):
    """(pq, valid, lo, hi, ranks) of the edge cases, tiles of 1024 rows."""
    if name == "tile_boundaries":
        rows = [0, 1023, 1024, 2047, 2048, 3071, 4095, 4096, 4100]
        pq, valid, lo, hi = _edge_table(4101, rows)
    elif name == "last_tile_only":
        pq, valid, lo, hi = _edge_table(3500, range(3072, 3500, 7))
    elif name == "single_member":
        pq, valid, lo, hi = _edge_table(2500, [1777])
    elif name == "empty_tiles_between":
        pq, valid, lo, hi = _edge_table(5000, [5, 6, 4500, 4999])
    elif name in ("batch0", "m1", "m64", "n1", "below_one_tile", "odd"):
        n = {"n1": 1, "below_one_tile": 700, "odd": 3001}.get(name, 2600)
        m = {"m1": 1, "m64": 64}.get(name, 20)
        pq, valid = _table(n, seed=n + m, frac_valid=0.8)
        cfg = AmperConfig(capacity=max(n, m), m=m, lam_fr=2.0, v_max=8.0)
        lo, hi = fr_intervals(group_representatives(prng.key(m), cfg), cfg)
    count = int(rank_select_ref(*_t(pq, valid), lo, hi,
                                torch.zeros(1, dtype=torch.int32))[1])
    ranks = (np.zeros(0, np.int32) if name == "batch0" else np.concatenate(
        [np.arange(count), _ranks_for(count)]).astype(np.int32))
    return pq, valid, lo, hi, ranks


RANK_CASES = ["tile_boundaries", "last_tile_only", "single_member",
              "empty_tiles_between", "batch0", "m1", "m64", "n1",
              "below_one_tile", "odd"]


@pytest.mark.parametrize("threads,loads", [(128, 2), (256, 4), (32, 1)])
@pytest.mark.parametrize("case", RANK_CASES)
def test_rank_select_decomposition_equals_plain(case, threads, loads):
    """The kernel's decomposition, at its 1024-row tiles and at 4096- and
    128-row tiles (whose look-back crosses several 32-tile windows),
    equals rank_select_ref on every edge case."""
    pq, valid, lo, hi, ranks = _rank_case(case)
    want = rank_select_ref(*_t(pq, valid), lo, hi, *_t(ranks))
    for seed in range(3):
        got = _rank_select_emulated(*_t(pq, valid), lo, hi, *_t(ranks),
                                    threads, loads, seed)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("case", [c for c in RANK_CASES if c != "batch0"])
def test_rank_select_decomposition_equals_reference_kernel(case):
    """The emulated decomposition against the reference's Pallas kernel,
    run as test_rank_select_ref_equals_reference_kernel runs it."""
    pq, valid, lo, hi, ranks = _rank_case(case)
    jidx, jcnt = jops.rank_select(pq, valid, lo.numpy(), hi.numpy(), ranks)
    idx, cnt = _rank_select_emulated(*_t(pq, valid), lo, hi, *_t(ranks),
                                     128, 2)
    np.testing.assert_array_equal(np.asarray(jidx), idx.numpy())
    assert int(jcnt) == int(cnt)


def test_lookback_prefixes_in_any_interleaving():
    """The look-back's tile prefixes are the exclusive cumsum of the
    tiles' members whatever order the tiles move in, over stale words of
    an earlier epoch."""
    rng = np.random.default_rng(0)
    for nblk in (1, 2, 31, 33, 65, 100, 245):
        members = rng.integers(0, 5, nblk).tolist()
        want = np.concatenate([[0], np.cumsum(members)[:-1]]).tolist()
        for seed in range(3):
            assert _lookback(members, np.random.default_rng(seed)) == want


@pytest.mark.parametrize("case", ["varying_nblk", "stale_words",
                                  "epoch_wrap"])
def test_rank_select_card_side_epochs_and_ticket(case):
    """The kernel's bookkeeping on the card over a sequence of calls on
    one scratch: each call's tiles come from a ticket that the last call
    put back to 0, its epoch is the last call's plus one, and its prefixes
    are right whatever the earlier calls left: calls over more and fewer
    tiles, words planted from earlier epochs, and the wrap after epoch
    2^30 - 1, which zeroes the words (so the words planted at epoch 1,
    beyond the tiles the calls before it touched, never pass for the new
    epoch 1's)."""
    rng = np.random.default_rng(["varying_nblk", "stale_words",
                                 "epoch_wrap"].index(case))
    sc = _Scratch(300)
    if case == "stale_words":
        sc.plant(rng, [1, 2, 3, 4])  # every word from an earlier call
        sc.epoch_word = 4
    elif case == "epoch_wrap":
        sc.plant(rng, [1])
        sc.epoch_word = MAX_EPOCH - 3
    for call in range(8):
        nblk = int(rng.integers(1, 300)) if case == "varying_nblk" else \
            int(rng.integers(1, 40)) if call < 3 else \
            int(rng.integers(100, 300))
        members = rng.integers(0, 9, nblk).tolist()
        epoch = sc.epoch_word + 1
        prefix = _rank_call(sc, members, rng)
        assert prefix == np.concatenate([[0], np.cumsum(members)[:-1]]
                                        ).tolist(), call
        assert sc.ticket == sc.done == 0
        assert sc.epoch_word == (epoch if epoch < MAX_EPOCH else 0)
        if epoch == MAX_EPOCH:
            assert all(w == (0, 0, 0) for w in sc.status)
    if case == "epoch_wrap":
        assert sc.epoch_word == 5


@pytest.mark.parametrize("case", ["failed_launch", "capture_without_scratch",
                                  "capture_after_warm_up", "grows"])
def test_rank_select_wrapper_scratch(monkeypatch, case):
    """The CUDA wrapper with the launch recorded instead of run: the
    scratch is made zeroed once per stream and reused (the host passes no
    epoch or ticket); a launch that raises drops it, so the next call
    starts on a fresh one; under graph capture a call is taken on the
    scratch its stream already has, and refused when there is none or it
    is too small; a larger table gets a larger scratch, the old one kept
    alive for any graph that captured it."""
    calls = []

    def launch(name, argtypes, device, *args):
        calls.append((args[-2], args[-1]))  # (scratch, capacity)
        if case == "failed_launch" and len(calls) == 2:
            raise RuntimeError("rank_select launch failed")

    monkeypatch.setattr(tsample.build, "_scratch", {})
    monkeypatch.setattr(tsample.build, "_retired", [])
    monkeypatch.setattr(tsample.build, "stream_key", lambda dev: 0)
    monkeypatch.setattr(tsample.build, "launch", launch)
    capturing = [False]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing[0])
    pq = torch.zeros(2500, dtype=torch.int32)  # 3 tiles
    valid = torch.ones(2500, dtype=torch.bool)
    lo = hi = torch.zeros(3, dtype=torch.int32)
    rank = torch.zeros(4, dtype=torch.int32)

    def call(n=2500):
        return tsample.rank_select_cuda(pq[:n], valid[:n], lo, hi, rank)

    def scratch():
        return tsample.build._scratch.get(("rank_select", CPU, 0))

    if case == "capture_without_scratch":
        capturing[0] = True
        with pytest.raises(RuntimeError, match="before capturing"):
            call()
        assert calls == [] and scratch() is None
        return
    call()
    first = scratch()
    assert first is not None and not bool(first.any())
    assert calls == [(first.data_ptr(), 3)]
    if case == "failed_launch":
        with pytest.raises(RuntimeError, match="launch failed"):
            call()
        assert scratch() is None
        call()
        assert scratch() is not first
        assert tsample.build._retired == [first]
    elif case == "capture_after_warm_up":
        capturing[0] = True
        call(1000)
        call()
        assert calls[1:] == [(first.data_ptr(), 3)] * 2
        with pytest.raises(RuntimeError, match="before capturing"):
            tsample.rank_select_cuda(torch.zeros(5000, dtype=torch.int32),
                                     torch.ones(5000, dtype=torch.bool), lo,
                                     hi, rank)
    else:
        call(1000)
        assert calls[1] == (first.data_ptr(), 3)
        tsample.rank_select_cuda(torch.zeros(5000, dtype=torch.int32),
                                 torch.ones(5000, dtype=torch.bool), lo, hi,
                                 rank)
        assert scratch() is not first and calls[2][1] == 5
        assert tsample.build._retired == [first]


@pytest.mark.parametrize("n", [1, 1001, 4096])
def test_tcam_match_ref_equals_reference_kernel(n):
    pq, _ = _table(n, seed=n + 1)
    rng = np.random.default_rng(n)
    for width in (0, 7, 18):
        q = np.int32(pq[rng.integers(0, n)] if n else 0)
        mask = np.int32((1 << width) - 1)
        want = np.asarray(jops.tcam_match(pq, q, mask))
        got = ops.tcam_match(*_t(pq), int(q), int(mask))
        np.testing.assert_array_equal(want, got.numpy())
        assert got.dtype == torch.bool


def test_new_wrappers_check_arguments_and_never_fall_back():
    pq = torch.zeros(16, dtype=torch.int32)
    valid = torch.ones(16, dtype=torch.bool)
    lo = hi = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(TypeError):
        ops.rank_select(pq, valid, lo, hi, torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError):
        ops.rank_select(pq[:0], valid[:0], lo, hi,
                        torch.zeros(4, dtype=torch.int32))
    with pytest.raises(TypeError):
        ops.tcam_match(pq.long(), 0, 0)
    before = dict(ops.launches)
    meta = [torch.empty(16, dtype=torch.int32, device="meta"),
            torch.empty(16, dtype=torch.bool, device="meta"),
            torch.empty(3, dtype=torch.int32, device="meta"),
            torch.empty(3, dtype=torch.int32, device="meta"),
            torch.empty(4, dtype=torch.int32, device="meta")]
    with pytest.raises(RuntimeError, match="no kernel"):
        ops.rank_select(*meta)
    with pytest.raises(RuntimeError, match="no kernel"):
        ops.tcam_match(meta[0], 1, 0)
    assert ops.launches == before


# --- (c): ShardedAmperSampler against repro.core.sharded ---------------------


@pytest.fixture(scope="module")
def jax_membership():
    """The reference's global membership per shard count (its fr_modes are
    bit-identical by its own tests, so one mode serves all)."""
    pq, valid = _table(N, seed=1)
    out = {}

    def get(s):
        if s not in out:
            js = JSharded(JConfig(**CFG), _jmesh(s), axis_names=("data",))
            st = JState(pq=jax.device_put(pq, js.sharding),
                        valid=jax.device_put(valid, js.sharding))
            fn = jax.jit(js.membership)
            out[s] = [np.asarray(fn(st, jax.random.key(k))) for k in (4, 5)]
        return out[s]

    return get


@pytest.mark.parametrize("mode", ["broadcast", "kernel", "fused",
                                  "interval", "window"])
@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_sharded_amper_sampler_bit_identical(shards, mode, jax_membership):
    pq, valid = _table(N, seed=1)
    js = JSharded(JConfig(**CFG, fr_mode=mode), _jmesh(shards),
                  axis_names=("data",))
    ts = ShardedAmperSampler(AmperConfig(**CFG, fr_mode=mode),
                             _tmesh(shards), axis_names=("data",))
    assert ts.local_csp_capacity == js.local_csp_capacity
    jdraw = jax.jit(lambda s, k: js.sample(s, k, BATCH))
    free = sharded_sample_fr(ts.mesh, ts.cfg, BATCH, axis_names=("data",))
    empty = np.zeros_like(valid)
    for v, keys in ((valid, (4, 5)), (empty, (6,))):  # empty: fallback
        jst = JState(pq=jax.device_put(pq, js.sharding),
                     valid=jax.device_put(v, js.sharding))
        tst = ts.from_dense(*_t(pq, v))
        assert len(tst.pq) == shards
        for k in keys:
            want = np.asarray(jdraw(jst, jax.random.key(k)))
            got = ts.sample(tst, prng.key(k), BATCH)
            np.testing.assert_array_equal(want, got.numpy())
            assert got.dtype == torch.int32
            assert torch.equal(got, free(tst.pq, tst.valid, prng.key(k)))
    tst = ts.from_dense(*_t(pq, valid))
    for k, want in zip((4, 5), jax_membership(shards)):
        np.testing.assert_array_equal(want, ts.membership(tst, prng.key(k))
                                      .numpy())


@pytest.mark.parametrize("shards,repeated", [(2, False), (8, False),
                                             (2, True), (8, True)],
                         ids=["2", "8", "2-repeated", "8-repeated"])
def test_sharded_update_matches_reference(shards, repeated):
    """Global rows map to (shard, local row); a duplicated row takes its
    last value, and a priority of 0 invalidates the row.  ``repeated``:
    one row written at 40 places across the batch, each time at another
    priority, the last one 0."""
    rng = np.random.default_rng(shards)
    idx = rng.integers(0, N, 300).astype(np.int32)   # with duplicates
    prio = rng.uniform(0, 9, 300).astype(np.float32)
    prio[::11] = 0.0
    if repeated:
        at = np.sort(rng.choice(300, 40, replace=False))
        idx[at] = N // 2 + 3
        prio[at] = rng.uniform(0.5, 9, 40).astype(np.float32)
        prio[at[-1]] = 0.0
    js = JSharded(JConfig(**CFG), _jmesh(shards), axis_names=("data",))
    jst = jax.jit(js.update)(js.init(), idx, prio)
    ts = ShardedAmperSampler(AmperConfig(**CFG), _tmesh(shards))
    tst = ts.update(ts.init(), *_t(idx, prio))
    np.testing.assert_array_equal(np.asarray(jst.pq), torch.cat(tst.pq).numpy())
    np.testing.assert_array_equal(np.asarray(jst.valid),
                                  torch.cat(tst.valid).numpy())
    np.testing.assert_array_equal(np.asarray(js.priorities(jst)),
                                  ts.priorities(tst).numpy())
    np.testing.assert_allclose(float(js.total(jst)), float(ts.total(tst)),
                               rtol=1e-6)
    if repeated:
        assert not bool(torch.cat(tst.valid)[N // 2 + 3])
    # repartition: 2 or 8 shards -> 4 and back leaves every value in place
    four = ShardedAmperSampler(AmperConfig(**CFG), _tmesh(4))
    back = repartition(ts, repartition(four, tst))
    assert torch.equal(torch.cat(back.pq), torch.cat(tst.pq))
    assert repartition(object(), tst) is tst


# --- (c'): the sharded priority write (ops.write_last) ------------------------


def _write_loop(idx, values, tables, shards, n_local):
    """The write as a sequential loop over the positions."""
    for j, r in enumerate(idx.tolist()):
        if r >= 0 and r // n_local in shards:
            k = shards.index(r // n_local)
            for f, v in enumerate(values):
                tables[f][k][r % n_local] = v[j]


# (idx, shards of the mesh, shards held here, n_local); every table starts
# from distinct values, so a row written by mistake shows
WRITE_CASES = {
    "duplicates_over_shards": (
        np.random.default_rng(1).integers(0, 8 * 64, 300), 8,
        list(range(8)), 64),
    "one_row_many_times": (
        np.concatenate([np.full(50, 77), [3, 77, 500, 77, 9]]), 8,
        list(range(8)), 64),
    "every_row_in_one_shard": (
        np.random.default_rng(2).integers(3 * 64, 4 * 64, 200), 8,
        list(range(8)), 64),
    "b1": (np.array([130]), 4, list(range(4)), 64),
    "held_elsewhere": (
        np.concatenate([np.random.default_rng(3).integers(0, 8 * 64, 300),
                        [-1, -64, 8 * 64, 9 * 64 + 5]]), 8, [6, 1, 4], 64),
}


def _write_args(case, fields, idx_dtype=torch.int64):
    idx, _, held, n_local = WRITE_CASES[case]
    rng = np.random.default_rng(len(idx))
    b = len(idx)
    if fields == "amper":
        values = [torch.from_numpy(rng.integers(0, 2 ** 24, b).astype(
                      np.int32)),
                  torch.from_numpy(rng.random(b) < 0.7)]
        tables = [[torch.arange(n_local, dtype=torch.int32) + 1000 * s
                   for s in held],
                  [torch.from_numpy(rng.random(n_local) < 0.5)
                   for _ in held]]
    else:
        values = [torch.from_numpy(rng.uniform(0, 9, b).astype(np.float32))]
        tables = [[torch.arange(n_local, dtype=torch.float32) - s
                   for s in held]]
    return (torch.from_numpy(idx).to(idx_dtype), values, tables, list(held),
            n_local)


@pytest.mark.parametrize("fields", ["amper", "per"])
@pytest.mark.parametrize("case", list(WRITE_CASES))
def test_write_last_plain_equals_sequential_loop(case, fields):
    """``ops.write_last`` on the CPU (``write_last_ref``) against a loop
    over the positions in order: duplicates within and across shards,
    one row written many times, every row in one shard, b = 1, and rows
    of shards held elsewhere (or out of the table) skipped, with
    AMPER-fr's int32 code and bool live flag or PER's float32 priority;
    int32 and int64 rows alike."""
    for idx_dtype in (torch.int32, torch.int64):
        idx, values, tables, held, n_local = _write_args(case, fields,
                                                         idx_dtype)
        want = [[t.clone() for t in ts] for ts in tables]
        _write_loop(idx, values, want, held, n_local)
        before = dict(ops.launches)
        ops.write_last(idx, values, tables, held, n_local)
        assert ops.launches == before  # the plain version launches nothing
        for got_f, want_f in zip(tables, want):
            for g, w in zip(got_f, want_f):
                assert torch.equal(g, w)


def _write_last_emulated(idx, values, tables, shards, n_local, slots, rng):
    """``csrc/write_last.cu``'s two passes in Python, each over the
    positions in a random order (blocks run in no order): the claim pass
    into the open-addressing slots (CAS into an empty slot, max in the
    row's own), then the write pass, where the slot's last position
    stores every field and empties the slot."""
    b = idx.shape[0]
    bits = twrite.slot_bits(b)
    assert len(slots) >= 1 << bits >= 2 * b
    mask = (1 << bits) - 1
    where = [-1] * b
    for j in rng.permutation(b):
        r = int(idx[j])
        if r < 0 or r // n_local not in shards:
            continue
        mine = (r + 1) << 32 | (j + 1)
        h = ((r * 0x9E3779B97F4A7C15) % 2 ** 64) >> (64 - bits)
        while slots[h] and slots[h] >> 32 != mine >> 32:
            h = (h + 1) & mask
        slots[h] = max(slots[h], mine)
        where[j] = h
    for j in rng.permutation(b):
        h = where[j]
        if h < 0 or slots[h] & 0xFFFFFFFF != j + 1:
            continue
        r = (slots[h] >> 32) - 1
        k = shards.index(r // n_local)
        for f, v in enumerate(values):
            tables[f][k][r % n_local] = v[j]
        slots[h] = 0


@pytest.mark.parametrize("case", list(WRITE_CASES))
def test_write_last_kernel_design_equals_plain(case):
    """The kernel's claim-and-write design, emulated with its slot sizing,
    equals the plain version in any order of the positions, and leaves
    every slot empty, so three calls in a row over one slots buffer (of
    the largest call's size) need no fill between them."""
    rng = np.random.default_rng(7)
    slots = [0] * (1 << twrite.slot_bits(400))
    for fields in ("amper", "per", "amper"):
        idx, values, tables, held, n_local = _write_args(case, fields)
        want = [[t.clone() for t in ts] for ts in tables]
        write_last_ref(idx, values, want, held, n_local)
        _write_last_emulated(idx, values, tables, held, n_local, slots, rng)
        for got_f, want_f in zip(tables, want):
            for g, w in zip(got_f, want_f):
                assert torch.equal(g, w)
        assert not any(slots)


def test_write_last_checks_arguments_and_never_falls_back():
    idx, values, tables, held, n_local = _write_args("b1", "amper")
    with pytest.raises(TypeError, match="idx"):
        ops.write_last(idx.to(torch.int16), values, tables, held, n_local)
    with pytest.raises(ValueError, match="one list of tables"):
        ops.write_last(idx, values, tables[:1], held, n_local)
    with pytest.raises(ValueError, match="distinct"):
        ops.write_last(idx, values, tables, [0, 0, 1, 2], n_local)
    with pytest.raises(TypeError, match="field 0"):
        ops.write_last(idx, [values[0].long(), values[1]], tables, held,
                       n_local)
    with pytest.raises(ValueError, match="field 1"):
        ops.write_last(idx, values, [tables[0], tables[1][:2]], held,
                       n_local)
    before = dict(ops.launches)
    meta = lambda t: torch.empty_like(t, device="meta")  # noqa: E731
    with pytest.raises(RuntimeError, match="no kernel"):
        ops.write_last(meta(idx), [meta(v) for v in values],
                       [[meta(t) for t in ts] for ts in tables], held,
                       n_local)
    assert ops.launches == before


@pytest.mark.parametrize("case", ["arguments", "failed_launch",
                                  "capture_without_scratch"])
def test_write_last_wrapper_launch(monkeypatch, case):
    """The CUDA wrapper with the launch recorded instead of run: one
    launch with every field's values and its tables field-major, the
    element sizes, the held shards, and a slots scratch of int64 zeros of
    2^bits >= 2b made once per stream; a launch that raises drops the
    scratch, and under graph capture a call without one is refused."""
    calls = []

    def launch(name, argtypes, device, *args):
        assert name == "write_last" and len(args) == len(argtypes)
        calls.append(args)
        if case == "failed_launch":
            raise RuntimeError("write_last launch failed")

    monkeypatch.setattr(twrite.build, "_scratch", {})
    monkeypatch.setattr(twrite.build, "_retired", [])
    monkeypatch.setattr(twrite.build, "stream_key", lambda dev: 0)
    monkeypatch.setattr(twrite.build, "sm_count", lambda dev: 132)
    monkeypatch.setattr(twrite.build, "launch", launch)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: case == "capture_without_scratch")
    idx, values, tables, held, n_local = _write_args("held_elsewhere",
                                                     "amper")

    def scratch():
        return twrite.build._scratch.get(("write_last", CPU, 0))

    if case == "capture_without_scratch":
        with pytest.raises(RuntimeError, match="before capturing"):
            twrite.write_last_cuda(idx, values, tables, held, n_local)
        assert calls == [] and scratch() is None
        return
    if case == "failed_launch":
        with pytest.raises(RuntimeError, match="launch failed"):
            twrite.write_last_cuda(idx, values, tables, held, n_local)
        assert scratch() is None and len(twrite.build._retired) == 1
        return
    twrite.write_last_cuda(idx, values, tables, held, n_local)
    (a,) = calls
    b, bits = idx.shape[0], twrite.slot_bits(idx.shape[0])
    slots = scratch()
    assert slots.dtype == torch.int64 and slots.numel() == 1 << bits
    assert not bool(slots.any()) and (1 << bits) >= 2 * b > (1 << bits) // 2
    assert a[:5] == (idx.data_ptr(), 1, b, n_local, 2)
    assert list(a[5]) == [v.data_ptr() for v in values]
    assert list(a[6]) == [4, 1]
    assert list(a[7]) == [t.data_ptr() for ts in tables for t in ts]
    assert a[8] == 3 and list(a[9]) == held
    assert a[10:12] == (slots.data_ptr(), bits) and a[13] == 132


@pytest.mark.parametrize("kind", ["amper-fr-fused", "per"])
def test_sharded_request_spans(kind):
    """A learner's request (draw, write-back of the drawn rows, inserts at
    the running maximum) logs two ``priority_write`` spans of the drawn
    and the inserted rows, and draws and writes bit for bit as it does
    untraced."""
    batch, inserts = 128, 16
    pq, valid = _table(N, seed=3)
    if kind == "per":
        ts = ShardedPERSampler(N, _tmesh(4), axis_names=("data",))
        fresh = lambda: ts.from_dense(  # noqa: E731
            torch.from_numpy(np.where(valid, pq, 0).astype(np.float32)))
    else:
        ts = ShardedAmperSampler(AmperConfig(**CFG, fr_mode="fused"),
                                 _tmesh(4), axis_names=("data",))
        fresh = lambda: ts.from_dense(*_t(pq, valid))  # noqa: E731
    rng = np.random.default_rng(5)
    vals = [torch.from_numpy(rng.uniform(0, 8, batch).astype(np.float32))
            for _ in range(3)]

    def requests(state):
        drawn = []
        for r, v in enumerate(vals):
            idx = ts.sample(state, prng.key(r), batch)
            ts.update(state, idx, v)
            rows = (torch.arange(inserts) + r * inserts) % N
            ts.update(state, rows, torch.full((inserts,), 8.0))
            drawn.append(idx)
        return drawn, state

    plain = requests(fresh())
    reg = obs.Registry()
    with obs.use_registry(reg):
        traced = requests(fresh())
    for a, b in zip(plain[0], traced[0]):
        assert torch.equal(a, b)
    for a, b in zip(plain[1], traced[1]):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    writes = [s.attrs["rows"] for s in reg.spans()
              if s.name == "priority_write"]
    assert writes == [batch, inserts] * len(vals)
    assert all(s.parent == 0 for s in reg.spans())
    draws = [s for s in reg.spans() if s.name == "sharded_sample"]
    assert len(draws) == (len(vals) if kind != "per" else 0)


def test_sharded_sampler_refuses_uneven_shards_and_unknown_axes():
    with pytest.raises(ValueError, match="divisible"):
        ShardedAmperSampler(AmperConfig(capacity=100), _tmesh(8))
    with pytest.raises(ValueError, match="sharding axes"):
        ShardedAmperSampler(AmperConfig(capacity=64), _tmesh(2),
                            axis_names=("pod",))


def test_mesh_orders_shards_like_the_reference():
    """Shards over several axes are numbered row-major in the order of
    ``axis_names``, as the reference's flat axis index is."""
    d = [[torch.device("cpu", i * 2 + j) for j in range(2)] for i in range(2)]
    mesh = Mesh(d, ("pod", "data"))
    idx = [x.index for x in mesh.shard_devices(("pod", "data"))]
    assert idx == [0, 1, 2, 3]
    assert [x.index for x in mesh.shard_devices(("data", "pod"))] == [0, 2, 1, 3]
    assert [x.index for x in mesh.shard_devices(("data",))] == [0, 1]


# --- (e): the replay buffer over the sharded sampler ---------------------------


@pytest.mark.parametrize("shards", [2, 8])
def test_replay_buffer_sharded_matches_reference(shards):
    cap, obs = 512, 3
    kw = dict(m=20, lam_fr=2.0, v_max=4.0, min_csp=16, axis_names=("data",))
    js = jsamplers.make_sampler("amper-fr-sharded", cap, mesh=_jmesh(shards),
                                fr_mode="kernel", **kw)
    ts = tsamplers.make_sampler("amper-fr-sharded", cap, mesh=_tmesh(shards),
                                fr_mode="fused", device="cpu", **kw)
    # alpha = 1: the priority |td| + eps rounds the same in both packages,
    # so the quantized table can be held exact (a pow rounds independently)
    jb = jrb.ReplayBuffer(cap, js, alpha=1.0)
    tb = trb.ReplayBuffer(cap, ts, alpha=1.0)
    ex = {"obs": np.zeros(obs, np.float32), "reward": np.float32(0)}
    jst = jb.init(ex)
    tst = tb.init({k: torch.from_numpy(np.array(v)) for k, v in ex.items()})
    rng = np.random.default_rng(shards)
    jadd, jsample = jax.jit(jb.add_batch), jax.jit(
        lambda s, k: jb.sample(s, k, 32))
    jupd = jax.jit(jb.update_priorities)
    for step in range(12):   # 12 * 48 rows wraps the 512-row ring
        rows = {"obs": rng.standard_normal((48, obs)).astype(np.float32),
                "reward": rng.standard_normal(48).astype(np.float32)}
        jst = jadd(jst, rows)
        tst = tb.add_batch(tst, {k: torch.from_numpy(v) for k, v in rows.items()})
        jidx, jbatch, jw = jsample(jst, jax.random.key(step))
        tidx, tbatch, tw = tb.sample(tst, prng.key(step), 32)
        np.testing.assert_array_equal(np.asarray(jidx), tidx.numpy())
        np.testing.assert_array_equal(np.asarray(jbatch["obs"]),
                                      tbatch["obs"].numpy())
        np.testing.assert_allclose(np.asarray(jw), tw.numpy(), rtol=1e-6)
        td = rng.standard_normal(32).astype(np.float32)
        jst = jupd(jst, jidx, td)
        tst = tb.update_priorities(tst, tidx, torch.from_numpy(td))
        np.testing.assert_array_equal(np.asarray(jst.sampler_state.pq),
                                      torch.cat(tst.sampler_state.pq).numpy())


# --- (f): DQN through the sharded sampler ---------------------------------------


def test_thirty_agent_steps_sharded_match_reference(monkeypatch):
    """30 steps of DQN with ``amper-fr-sharded`` on 2 shards, the port
    through its fused kernels' plain versions, the reference through its
    broadcast match; the reference's default mesh is pointed at 2 of the
    forced host devices."""
    jmesh = _jmesh(2)
    monkeypatch.setattr(jsamplers, "_default_mesh", lambda: jmesh)
    thirty_agent_steps("amper-fr-sharded", "dqn", 1, "fused", mesh=_tmesh(2))


# --- (g): what a draw moves between shards -------------------------------------


@pytest.mark.parametrize("shards", [1, 4, 8])
def test_a_draw_moves_shards_plus_batch_scalars(shards):
    """One all-gather of the S shard counts and one psum of the batch:
    S + b scalars a draw, whatever the table size."""
    pq, valid = _table(N, seed=2)
    mesh = _tmesh(shards)
    ts = ShardedAmperSampler(AmperConfig(**CFG, fr_mode="fused"), mesh)
    st = ts.from_dense(*_t(pq, valid))
    mesh.traffic = {"all_gather": 0, "psum": 0}
    ts.sample(st, prng.key(0), BATCH)
    assert mesh.traffic == {"all_gather": shards, "psum": BATCH}
    per = tsamplers.make_sampler("per-sharded", N, mesh=mesh, device="cpu")
    pst = per.update(per.init(), torch.arange(N), torch.ones(N))
    mesh.traffic = {"all_gather": 0, "psum": 0}
    per.sample(pst, prng.key(0), BATCH)
    assert mesh.traffic == {"all_gather": shards, "psum": BATCH}


# --- (h): the kernels on the card ------------------------------------------------


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("n,frac_valid", [(1, 1.0), (1001, 0.9),
                                          (250_000, 0.9), (4097, 0.0),
                                          (1_000_000, 0.9)])
def test_cuda_rank_select_equals_plain(n, frac_valid):
    _need_cuda()
    pq, valid = _table(n, seed=n, frac_valid=frac_valid)
    cfg = AmperConfig(capacity=n, m=20, lam_fr=2.0, v_max=8.0)
    lo, hi = fr_intervals(group_representatives(prng.key(n), cfg), cfg)
    args = [x.cuda() for x in _t(pq, valid)] + [lo.cuda(), hi.cuda()]
    count = int(rank_select_ref(*args, torch.zeros(1, dtype=torch.int32,
                                                   device="cuda"))[1])
    rank = torch.from_numpy(np.concatenate([
        _ranks_for(count),
        np.random.default_rng(n).integers(-3, count + 3, 300)]).astype(
            np.int32)).cuda()
    got = ops.rank_select(*args, rank)
    want = rank_select_ref(*args, rank)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("case", [c for c in RANK_CASES if c != "batch0"]
                         + ["batch0"])
def test_cuda_rank_select_edge_cases_equal_plain(case):
    """The kernel on every edge case of the emulated decomposition."""
    _need_cuda()
    pq, valid, lo, hi, ranks = _rank_case(case)
    args = [x.cuda() for x in _t(pq, valid, ranks)]
    got = ops.rank_select(args[0], args[1], lo.cuda(), hi.cuda(), args[2])
    want = rank_select_ref(args[0], args[1], lo.cuda(), hi.cuda(), args[2])
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_cuda_rank_select_back_to_back():
    """Calls queued with no sync in between, over three range sets and
    rank sets, each equal to the plain version: a call must never take an
    earlier call's look-back words or tickets for its own."""
    _need_cuda()
    pq, valid = (x.cuda() for x in _t(*_table(250_000, seed=5)))
    cfg = AmperConfig(capacity=250_000, m=20, lam_fr=2.0, v_max=8.0)
    rng = np.random.default_rng(5)
    sets = [(*(x.cuda() for x in fr_intervals(
        group_representatives(prng.key(s), cfg), cfg)),
        torch.from_numpy(rng.integers(-3, 90_000, 64).astype(
            np.int32)).cuda()) for s in range(3)]
    want = [rank_select_ref(pq, valid, *s_) for s_ in sets]
    got = [ops.rank_select(pq, valid, *sets[i % 3]) for i in range(300)]
    for i, (idx, cnt) in enumerate(got):
        assert torch.equal(idx, want[i % 3][0])
        assert torch.equal(cnt, want[i % 3][1])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 1001, 1_000_000])
def test_cuda_tcam_match_equals_plain(n):
    _need_cuda()
    pq = _t(_table(n, seed=n)[0])[0].cuda()
    for width in (0, 7, 18):
        q, mask = int(pq[n // 2]), (1 << width) - 1
        got = ops.tcam_match(pq, q, mask)
        assert torch.equal(got, tcam_match_ref(pq, q, mask))
