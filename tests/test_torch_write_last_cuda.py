"""The sharded priority write's kernel (``csrc/write_last.cu``) on the card.

Marked ``cuda`` and skipped without a card.  The file imports no JAX, so
it runs where the card is and JAX is not:
``PYTHONPATH=src python -m pytest -q tests/test_torch_write_last_cuda.py``.
Every check is against the plain version, ``kernels.ref.write_last_ref``,
bit for bit.
"""
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import write_last_ref

B, SHARDS, SHARD_ROWS = 65_536, 16, 1 << 20


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(g, dev, b=B, fields="amper", repeat=0.01,
            n=SHARDS * SHARD_ROWS):
    """``b`` rows of [0, n) with about ``repeat`` of them written again
    elsewhere in the batch, and each field's values."""
    idx = torch.randint(0, n, (b,), generator=g, device=dev)
    k = max(int(b * repeat), 1)
    at = torch.randint(0, b, (2, k), generator=g, device=dev)
    idx[at[0]] = idx[at[1]]
    if fields == "amper":
        values = [torch.randint(0, 1 << 24, (b,), generator=g, device=dev,
                                dtype=torch.int32),
                  torch.rand(b, generator=g, device=dev) < 0.7]
    else:
        values = [torch.rand(b, generator=g, device=dev) * 8]
    return idx, values


def _tables(g, dev, values, shards, rows=SHARD_ROWS):
    """One table a field and held shard, filled with values no write
    gives (negative codes, all flags set, priorities below 0)."""
    out = []
    for v in values:
        if v.dtype == torch.bool:
            out.append([torch.ones(rows, dtype=torch.bool, device=dev)
                        for _ in shards])
        else:
            out.append([-1 - torch.randint(0, 1000, (rows,), generator=g,
                                           device=dev).to(v.dtype)
                        for _ in shards])
    return out


def _same(a, b) -> bool:
    return all(torch.equal(x, y) for f, h in zip(a, b) for x, y in zip(f, h))


@pytest.mark.cuda
@pytest.mark.parametrize("fields", ["amper", "per"])
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
def test_write_last_equals_plain_at_the_cells_batch(fields, idx_dtype):
    """b = 65,536 with ~1% repeated rows over 16 shards of 2^20: every
    shard equal to the plain version's after the call, and one launch."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(1)
    idx, values = _inputs(g, dev, fields=fields)
    shards = list(range(SHARDS))
    tables = _tables(g, dev, values, shards)
    want = [[t.clone() for t in f] for f in tables]
    write_last_ref(idx, values, want, shards, SHARD_ROWS)
    before = ops.launches["write_last"]
    ops.write_last(idx.to(idx_dtype), values, tables, shards, SHARD_ROWS)
    torch.cuda.synchronize()
    assert ops.launches["write_last"] == before + 1
    assert _same(tables, want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["one_row", "b1", "held_elsewhere",
                                  "all_repeated"])
def test_write_last_edge_cases_equal_plain(case):
    """One row written 4,096 times, b = 1, rows of shards held elsewhere
    and out of the table (left alone), and a batch of 64 distinct rows
    each written 64 times."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(2)
    rows, shards = 4096, list(range(8))
    b = {"one_row": 4096, "b1": 1, "held_elsewhere": 20_000,
         "all_repeated": 4096}[case]
    idx, values = _inputs(g, dev, b=b, n=8 * rows)
    if case == "one_row":
        idx[:] = 3 * rows + 17
    elif case == "held_elsewhere":
        shards = [6, 1, 4]
        idx[:100] = torch.arange(-50, 50, device=dev) * rows  # < 0, >= n
    elif case == "all_repeated":
        idx = torch.randint(0, 8 * rows, (64,), generator=g,
                            device=dev).repeat(64)
    tables = _tables(g, dev, values, shards, rows)
    want = [[t.clone() for t in f] for f in tables]
    write_last_ref(idx, values, want, shards, rows)
    ops.write_last(idx, values, tables, shards, rows)
    torch.cuda.synchronize()
    assert _same(tables, want)


@pytest.mark.cuda
def test_write_last_calls_in_a_row_reuse_the_slots():
    """Three calls queued back to back on one stream, with no sync, of
    two batch sizes: the slots each call leaves must be empty for the
    next, whatever rows the one before claimed."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(3)
    shards = list(range(SHARDS))
    batches = [_inputs(g, dev, b=b) for b in (B, 8192, B)]
    tables = _tables(g, dev, batches[0][1], shards)
    want = [[t.clone() for t in f] for f in tables]
    for idx, values in batches:
        ops.write_last(idx, values, tables, shards, SHARD_ROWS)
    for idx, values in batches:
        write_last_ref(idx, values, want, shards, SHARD_ROWS)
    torch.cuda.synchronize()
    assert _same(tables, want)


@pytest.mark.cuda
def test_write_last_captured_in_a_graph():
    """One call captured in a CUDA graph after a warm-up on the capturing
    stream, then replayed over new rows and values copied into its
    inputs: each replay equals the plain version, and the capture
    records one launch instead of making one."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(4)
    shards = list(range(SHARDS))
    idx, values = _inputs(g, dev)
    tables = _tables(g, dev, values, shards)
    want = [[t.clone() for t in f] for f in tables]
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        ops.write_last(idx, values, tables, shards, SHARD_ROWS)
    torch.cuda.current_stream().wait_stream(stream)
    write_last_ref(idx, values, want, shards, SHARD_ROWS)
    launched, recorded = ops.launches["write_last"], ops.recorded["write_last"]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        ops.write_last(idx, values, tables, shards, SHARD_ROWS)
    assert ops.launches["write_last"] == launched
    assert ops.recorded["write_last"] == recorded + 1
    for _ in range(3):
        new_idx, new_values = _inputs(g, dev)
        idx.copy_(new_idx)
        for v, nv in zip(values, new_values):
            v.copy_(nv)
        graph.replay()
        write_last_ref(idx, values, want, shards, SHARD_ROWS)
        torch.cuda.synchronize()
        assert _same(tables, want)


@pytest.mark.cuda
def test_write_last_launches_twice_a_sharded_request():
    """A learner's request on ``ShardedAmperSampler`` (draw, the drawn
    rows' write-back, the inserts at the running maximum) launches
    ``write_last`` twice, and its table equals the same request's on the
    CPU; a dense ``AmperSampler.update`` launches it not at all."""
    from repro_torch import prng
    from repro_torch.core.amper import AmperConfig, AmperSampler
    from repro_torch.core.sharded import ShardedAmperSampler
    from repro_torch.distributed.sharding import Mesh

    dev = _card()
    n, batch, inserts = SHARDS * 4096, 4096, 512
    cfg = AmperConfig(capacity=n, m=20, lam_fr=2.0, v_max=1.0,
                      csp_capacity=n // 7, fr_mode="fused")
    g = torch.Generator().manual_seed(5)
    p0 = torch.rand(n, generator=g)
    vals = torch.rand(batch, generator=g)
    out = {}
    for d in (torch.device("cpu"), dev):
        sampler = ShardedAmperSampler(cfg, Mesh([d] * SHARDS, ("data",)),
                                      axis_names=("data",))
        state = sampler.from_dense(torch.zeros(n, dtype=torch.int32),
                                   torch.zeros(n, dtype=torch.bool))
        sampler.update(state, torch.arange(n), p0)
        before = ops.launches["write_last"]
        idx = sampler.sample(state, prng.key(5).to(d), batch)
        sampler.update(state, idx, vals.to(d))
        sampler.update(state, torch.arange(inserts, device=d),
                       torch.ones((), device=d).expand(inserts))
        torch.cuda.synchronize()
        want = 2 if d.type == "cuda" else 0
        assert ops.launches["write_last"] == before + want
        out[d.type] = (idx.cpu(), sampler.to_dense(state))
    assert torch.equal(out["cpu"][0], out["cuda"][0])
    assert torch.equal(out["cpu"][1].pq, out["cuda"][1].pq.cpu())
    assert torch.equal(out["cpu"][1].valid, out["cuda"][1].valid.cpu())
    dense = AmperSampler(AmperConfig(capacity=n), device=dev)
    st = dense.init()
    before = dict(ops.launches)
    dense.update(st, idx.to(dev), vals.to(dev))
    torch.cuda.synchronize()
    assert ops.launches["write_last"] == before["write_last"]


@pytest.mark.cuda
def test_write_last_refuses_what_the_kernel_cannot_take():
    """More held shards than the kernel takes, or rows past 2^32 - 1,
    raise on the card before any launch (the CPU takes them)."""
    dev = _card()
    idx = torch.zeros(4, dtype=torch.int64, device=dev)
    value = torch.zeros(4, dtype=torch.int32, device=dev)
    many = list(range(40))
    tables = [[torch.zeros(8, dtype=torch.int32, device=dev) for _ in many]]
    before = ops.launches["write_last"]
    with pytest.raises(ValueError, match="at most"):
        ops.write_last(idx, [value], tables, many, 8)
    flag = torch.zeros(4, dtype=torch.bool, device=dev)
    table = torch.zeros(1 << 22, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="2\\^32"):  # shard 1023's rows
        ops.write_last(idx, [flag], [[table]], [1023], 1 << 22)
    assert ops.launches["write_last"] == before
