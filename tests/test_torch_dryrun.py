"""The port's dry run (``launch/dryrun.py``) against the JAX reference.

* The AMPER cell: its draw at ``table_log2`` 12 over 8 shards (the port's
  logical shards on the CPU) equals the reference's
  ``sharded_sample_fr`` on ``make_replay_mesh(8)`` over the 8 host
  devices that ``tests/conftest.py`` forces, bit for bit, same key, in
  every ``fr_mode`` (the kernel modes take the plain versions here);
  ``run_amper_cell``'s report on the production meshes' shard counts.
* The sweep: ``run_cell`` for every family, every cell and both meshes,
  at reduced width and a small cell shape, returns "ok" or the
  reference's skip reason, word for word; no loop counted twice or not
  at all (a 14-layer stack's two-depth extrapolation equals a trace at
  its full depth); a full-size decode cell's report.
* The attention kernels' meta branch: the kernel's output shape, no
  launch, no plain run; its argument checks raise on ``meta`` as they do
  on the CPU.
* The CLI: the reference's flags, JSON out, the exit code.
"""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from repro.configs import get_config as jget_config
from repro.core import sharded as jsharded
from repro.core.amper import AmperConfig as JConfig
from repro.launch.mesh import make_replay_mesh as jreplay_mesh
from repro_torch.configs import ARCH_IDS, get_config, get_reduced_config
from repro_torch.core.sharded import sharded_sample_fr
from repro_torch.distributed.sharding import Mesh
from repro_torch.kernels import ops
from repro_torch.launch import dryrun, mesh as tmesh
from repro_torch.models.model_api import SHAPE_CELLS, Model, ShapeCell

CPU = torch.device("cpu")
BATCH = 4096
# small cells of each kind, for the reduced sweep
SMALL_CELLS = {"train_4k": ShapeCell("train_4k", 32, 2, "train"),
               "prefill_32k": ShapeCell("prefill_32k", 48, 2, "prefill"),
               "decode_32k": ShapeCell("decode_32k", 40, 2, "decode"),
               "long_500k": ShapeCell("long_500k", 64, 1, "decode")}


@pytest.fixture(autouse=True)
def partitionable():
    with jax.threefry_partitionable(True):
        yield


@pytest.fixture
def jdry():
    """The reference's dryrun module, imported after this process's jax
    backend is up, with XLA_FLAGS put back (it sets 512 host devices)."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as mod
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return mod


# --- the AMPER cell ----------------------------------------------------------


def _reference_draw(cell, seed=0):
    """The reference's sharded AMPER-fr draw over the cell's table."""
    if jax.device_count() < cell.n_shards:
        pytest.skip("needs 8 host devices (tests/conftest.py forces them)")
    jmesh = jreplay_mesh(cell.n_shards)
    c = cell.cfg
    jcfg = JConfig(capacity=c.capacity, m=c.m, lam_fr=c.lam_fr,
                   csp_capacity=c.csp_capacity)
    fn = jsharded.sharded_sample_fr(jmesh, jcfg, BATCH, axis_names=("data",))
    sh = NamedSharding(jmesh, P("data"))
    pq = jax.device_put(np.concatenate([t.numpy() for t in cell.pq]), sh)
    valid = jax.device_put(np.concatenate([t.numpy() for t in cell.valid]),
                           sh)
    return np.asarray(jax.jit(fn)(pq, valid, jax.random.PRNGKey(seed)))


def test_amper_cell_draw_equals_reference():
    mesh = Mesh([CPU] * 8)
    cell = dryrun.amper_cell(mesh, 12, BATCH, "cpu")
    assert cell.n_shards == 8 and cell.pq[0].shape == (512,)
    assert all(bool(v.all()) for v in cell.valid)
    assert torch.equal(cell.key, torch.tensor([0, 0]))
    want = _reference_draw(cell)
    got = cell.draw(cell.pq, cell.valid, cell.key)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # every mode draws the same indices from the table (kernel and fused:
    # the plain versions of their kernels on the CPU)
    for mode in ("interval", "window", "kernel", "fused"):
        draw = sharded_sample_fr(mesh, cell.cfg._replace(fr_mode=mode),
                                 BATCH, axis_names=("data",))
        assert torch.equal(draw(cell.pq, cell.valid, cell.key), got), mode
    again = dryrun.amper_cell(mesh, 12, BATCH, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(again.pq, cell.pq))


@pytest.mark.parametrize("multi_pod", [False, True])
def test_run_amper_cell_report(multi_pod):
    r = dryrun.run_amper_cell(multi_pod, table_log2=12, batch=1024,
                              device="cpu")
    assert r["status"] == "ok", r.get("traceback")
    shards = 32 if multi_pod else 16
    assert r["mesh"] == ("2x16x16" if multi_pod else "16x16")
    assert (r["n_shards"], r["rows_per_shard"]) == (shards, 4096 // shards)
    assert r["memory"]["argument_bytes_per_dev"] == 5 * 4096 // shards
    assert r["memory"]["table_bytes"] == 5 * 4096
    assert r["roofline"]["bytes_accessed"] == 5 * 4096 // shards
    assert r["roofline"]["bottleneck"] == "memory"
    assert r["roofline"]["t_collective_s"] is None
    assert 0 <= r["draw_index_range"][0] <= r["draw_index_range"][1] < 4096
    assert r["fr_mode"] == "broadcast" and r["device"] == "cpu"


def test_replay_mesh_raises_where_the_reference_raises():
    with pytest.raises(ValueError, match="only 1 devices"):
        tmesh.make_replay_mesh(2, device="cpu")
    assert tmesh.make_replay_mesh(device="cpu").shape == {"data": 1}
    assert tmesh.make_debug_mesh(device="cpu").shape == {"data": 1,
                                                         "model": 1}
    prod = tmesh.make_production_mesh(multi_pod=True, device="cpu")
    assert prod.devices.size == 512
    assert set(prod.devices.flat) == {CPU}


# --- the LM sweep ------------------------------------------------------------


def _reduced(arch, **over):
    cfg = get_reduced_config(arch, **over)
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_reduced_sweep_ok_or_reference_skip(arch, jdry, monkeypatch):
    for name, cell in SMALL_CELLS.items():
        monkeypatch.setitem(SHAPE_CELLS, name, cell)
    over = _reduced(arch)
    traces = {}
    n_ok = 0
    for multi_pod in (False, True):
        for shape in SHAPE_CELLS:
            r = dryrun.run_cell(arch, shape, multi_pod, cfg_overrides=over,
                                traces=traces)
            if r["status"] == "skip":
                want = jdry.lower_cell(arch, shape, multi_pod,
                                       cfg_overrides=over)
                assert want[0] == "skip"
                assert r["reason"] == want[1]
                continue
            assert r["status"] == "ok", r.get("traceback")
            jcfg = dataclasses.replace(jget_config(arch), **over)
            assert shape != "long_500k" or jcfg.supports_long_context
            mem, roof = r["memory"], r["roofline"]
            assert mem["argument_bytes_per_dev"] > 0
            assert mem["peak_live_bytes"] >= mem["argument_bytes"]
            assert mem["temp_bytes_per_dev"] is None
            assert roof["coll_bytes_per_dev"] is None
            n_dev = 512 if multi_pod else 256
            assert roof["flops"] == pytest.approx(
                (r["traced_flops"] + r["correction_flops"]) / n_dev)
            assert r["traced_flops"] > 0
            kind = SMALL_CELLS[shape].kind
            # the kernels' calls are corrected only where the step serves
            assert bool(r["corrected_terms"]) == (
                kind != "train" and over["block_kind"] != "rwkv")
            n_ok += 1
    # one trace a cell, shared by both meshes
    assert len(traces) * 2 == n_ok


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_depth_extrapolation_is_exact(shape, monkeypatch):
    """A 14-layer stack is traced at 2 and 8 layers (a train step also at
    5); its extrapolated counts equal one trace at 14.  A train step's
    bytes are quadratic in the depth: the two-point line misses them."""
    for name, cell in SMALL_CELLS.items():
        monkeypatch.setitem(SHAPE_CELLS, name, cell)
    over = _reduced("stablelm-1.6b", n_layers=14)
    traces = {}
    r = dryrun.run_cell("stablelm-1.6b", shape, False, cfg_overrides=over,
                        traces=traces)
    assert r["status"] == "ok", r.get("traceback")
    train = shape == "train_4k"
    assert r["traced_depths"] == ([2, 5, 8] if train else [2, 8])
    prog, _, _, cfg, _ = dryrun.lower_cell("stablelm-1.6b", shape, False,
                                           cfg_overrides=over)
    full = dryrun._trace(prog, cfg)
    assert r["traced_flops"] == full["flops"]
    assert r["traced_bytes"] == full["bytes"]
    assert r["memory"]["peak_live_bytes"] == full["peak_live_bytes"]
    assert r["correction_flops"] == pytest.approx(full["correction_flops"])
    assert r["corrected_terms"] == full["terms"]
    line = dryrun._extrapolate({d: q["bytes"] for (_, _, d, _), q in
                                traces.items() if d in (2, 8)}, 14)
    assert (line == full["bytes"]) != train


def test_full_size_decode_cell():
    r = dryrun.run_cell("stablelm-1.6b", "decode_32k", False)
    assert r["status"] == "ok", r.get("traceback")
    assert r["traced_depths"] == [2, 8]
    assert r["corrected_terms"] == {"decode_attention": 24}
    bw = r["decode_bandwidth"]
    # params + the 24-layer cache of 128 x 32,768 positions, over 256
    cache = 24 * 2 * 128 * 32 * 32_768 * 64 * 2 + 4
    params = sum(t.numel() * t.element_size() for t in dryrun._tensors(
        Model.from_config(get_config("stablelm-1.6b")).abstract_params()))
    assert bw["floor_bytes_per_dev"] == (params + cache) / 256
    assert bw["floor_latency_s"] == bw["floor_bytes_per_dev"] / 3.35e12
    assert r["memory"]["argument_bytes"] == params + cache + 128 * 4


# --- the kernels' meta branch -----------------------------------------------


def _attn(device, *shapes, dtype=torch.float32):
    return [torch.zeros(s, dtype=dtype, device=device) for s in shapes]


def test_meta_branch_shape_no_launch_and_record():
    before = dict(ops.launches)
    q, k, v = _attn("meta", (2, 8, 40, 64), (2, 2, 40, 64), (2, 2, 40, 32),
                    dtype=torch.bfloat16)
    with ops.record_meta_calls() as calls:
        out = ops.flash_attention(q, k, v, window=16)
        dq = q[:, :2, :4].contiguous()
        dout = ops.decode_attention(dq, k, v, torch.zeros(
            (), dtype=torch.int32, device="meta"))
        # a CPU call is recorded nowhere and counts no launch either
        ops.flash_attention(*_attn("cpu", (1, 2, 8, 16), (1, 2, 8, 16),
                                   (1, 2, 8, 16)))
    assert (out.device.type, out.dtype, out.shape) == (
        "meta", torch.bfloat16, (2, 8, 40, 32))
    assert dout.shape == (2, 2, 4, 32) and dout.device.type == "meta"
    assert ops.launches == before
    assert [name for name, _ in calls] == ["flash_attention",
                                           "decode_attention"]
    assert calls[0][1] == {"q": (2, 8, 40, 64), "k": (2, 2, 40, 64),
                           "v": (2, 2, 40, 32), "dtype": torch.bfloat16,
                           "causal": True, "window": 16, "prefix_len": None}
    assert calls[1][1]["window"] is None
    # outside the block nothing is recorded
    ops.flash_attention(q, k, v)
    assert len(calls) == 2


BAD_FLASH = [
    (dict(shapes=((1, 4, 32, 16), (1, 2, 32, 16), (1, 2, 32, 16)),
          dtype=torch.float16), {}),
    (dict(shapes=((1, 3, 32, 16), (1, 2, 32, 16), (1, 2, 32, 16))), {}),
    (dict(shapes=((1, 4, 32, 12), (1, 2, 32, 12), (1, 2, 32, 12))), {}),
    (dict(shapes=((1, 4, 32, 16), (1, 2, 16, 16), (1, 2, 16, 16))), {}),
    (dict(shapes=((1, 4, 32, 16), (1, 2, 32, 16), (1, 2, 32, 16))),
     {"window": 0}),
    (dict(shapes=((1, 4, 32, 16), (1, 2, 32, 16), (1, 2, 32, 16))),
     {"prefix_len": -1}),
    (dict(shapes=((4, 32, 16), (1, 2, 32, 16), (1, 2, 32, 16))), {}),
]


@pytest.mark.parametrize("case,kw", BAD_FLASH)
def test_meta_branch_checks_raise_as_on_cpu(case, kw):
    errors = []
    for device in ("cpu", "meta"):
        args = _attn(device, *case["shapes"],
                     dtype=case.get("dtype", torch.float32))
        with pytest.raises((TypeError, ValueError)) as e:
            ops.flash_attention(*args, **kw)
        errors.append((e.type, str(e.value)))
    assert errors[0] == errors[1]


def test_meta_branch_decode_and_grad_checks_raise_as_on_cpu():
    for device in ("cpu", "meta"):
        q, k, v = _attn(device, (1, 2, 4, 16), (1, 2, 32, 16),
                        (1, 2, 32, 16))
        with pytest.raises(TypeError, match="cur_len"):
            ops.decode_attention(q, k, v, torch.zeros(
                (), dtype=torch.int64, device=device))
        with pytest.raises(ValueError, match="kv heads"):
            ops.decode_attention(q, k[:, :1].contiguous(),
                                 v[:, :1].contiguous(),
                                 torch.zeros((), dtype=torch.int32,
                                             device=device))
        with pytest.raises(RuntimeError, match="require grad"):
            ops.flash_attention(q.requires_grad_(), k, v, causal=False)
    # the replay kernels have no meta branch
    meta = torch.empty(16, dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        ops.tcam_match(meta, 1, 0)


# --- the CLI -----------------------------------------------------------------


def test_cli_writes_reports(tmp_path, capsys):
    out = tmp_path / "dry.json"
    rc = dryrun.main(["--arch", "whisper-tiny", "--shape", "long_500k",
                      "--both-meshes", "--out", str(out)])
    assert rc == 0
    got = json.loads(out.read_text())
    assert [(r["mesh"], r["status"]) for r in got] == [("16x16", "skip"),
                                                       ("2x16x16", "skip")]
    assert "done: 2 cells, 0 errors" in capsys.readouterr().out
    rc = dryrun.main(["--arch", "stablelm-1.6b", "--shape", "decode_32k",
                      "--set", "n_layers=3", "--set", "ce_block=4096",
                      "--out", str(out)])
    assert rc == 0
    (r,) = json.loads(out.read_text())
    assert r["status"] == "ok" and r["traced_depths"] == [3]
    assert r["corrected_terms"] == {"decode_attention": 3}


def test_cli_amper_cell(tmp_path, capsys, monkeypatch):
    """``--amper --device cpu`` runs the AMPER cell after the LM cells
    (here one skipped cell), on both meshes, at a small table."""
    full = dryrun.run_amper_cell
    monkeypatch.setattr(dryrun, "run_amper_cell",
                        lambda mp, device: full(mp, table_log2=12,
                                                batch=256, device=device))
    out = tmp_path / "dry.json"
    rc = dryrun.main(["--amper", "--both-meshes", "--arch", "whisper-tiny",
                      "--shape", "long_500k", "--device", "cpu",
                      "--out", str(out)])
    assert rc == 0
    got = json.loads(out.read_text())
    assert [(r["arch"], r["mesh"], r["status"]) for r in got] == [
        ("whisper-tiny", "16x16", "skip"), ("amper-replay", "16x16", "ok"),
        ("whisper-tiny", "2x16x16", "skip"),
        ("amper-replay", "2x16x16", "ok")]
    assert [r["n_shards"] for r in got[1::2]] == [16, 32]
    assert "amper-replay: ok compile_s=" in capsys.readouterr().out
