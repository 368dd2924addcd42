"""The dry run's per-device sharded program (``launch/dryrun.py`` as rank 0
of a fake process group, ``launch/hlo_analysis.py``'s collective terms),
on the CPU.

* ``collective_bytes`` against closed forms on a fake group of 16: a
  column- then row-parallel MLP issues one all-reduce of B * S * D
  float32 values (ring factor 2), an FSDP weight one all-gather of its
  bytes.  The reference's HLO for the same MLP on its 8 host devices
  uses other collectives (XLA picks them), so its bytes are printed
  beside these, not compared.
* ``analyze``: the roofline's collective term at the H100's NVLink rate
  and the temporaries as the peak less the arguments.
* Rank 0's FLOPs for a tensor-parallel matmul cell equal 2 M N K of its
  own block, not the global count divided by the devices.
* Reduced cells of every family on the sharded mesh: no error, a
  training step's collective bytes above zero, every report's
  temporaries and collective time set; the deepseeks reach the
  shard-map MoE dispatch, counted, in prefill, decode and training.

Exact: every count here is an integer or a sum of them.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_reduced_config
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import Mesh
from repro_torch.launch import dryrun, hlo_analysis as hlo
from repro_torch.launch.mesh import fake_group
from repro_torch.models.model_api import SHAPE_CELLS, ShapeCell

B, S, D, F = 32, 8, 64, 128
SMALL_CELLS = {"train_4k": ShapeCell("train_4k", 32, 2, "train"),
               "prefill_32k": ShapeCell("prefill_32k", 48, 2, "prefill"),
               "decode_32k": ShapeCell("decode_32k", 40, 2, "decode"),
               "long_500k": ShapeCell("long_500k", 64, 1, "decode")}
# the MoE cells: T = batch x tokens divides the 16 token groups
MOE_CELLS = {"train_4k": ShapeCell("train_4k", 32, 2, "train"),
             "prefill_32k": ShapeCell("prefill_32k", 48, 2, "prefill"),
             "decode_32k": ShapeCell("decode_32k", 40, 16, "decode")}


def _meta(*shape):
    return torch.empty(shape, device="meta")


def _one_dim_mesh(group):
    return Mesh(np.full((1, 16), torch.device("meta"), dtype=object),
                ("data", "model"), group=group)


def _reference_mlp_collectives():
    """The reference's HLO collectives for the same MLP (column- then
    row-parallel over an 8-way "model" axis), printed beside the port's."""
    import jax.numpy as jnp
    from jax.sharding import Mesh as JMesh, NamedSharding, PartitionSpec as P

    from repro.launch import hlo_analysis as jhlo

    if jax.device_count() < 8:
        return None
    mesh = JMesh(np.asarray(jax.devices()[:8]).reshape(1, 8),
                 ("data", "model"))

    def mlp(x, w1, w2):
        return jax.nn.relu(x @ w1) @ w2

    shard = (NamedSharding(mesh, P()), NamedSharding(mesh, P(None, "model")),
             NamedSharding(mesh, P("model", None)))
    args = (jax.ShapeDtypeStruct((B, S, D), jnp.float32),
            jax.ShapeDtypeStruct((D, F), jnp.float32),
            jax.ShapeDtypeStruct((F, D), jnp.float32))
    compiled = jax.jit(mlp, in_shardings=shard,
                       out_shardings=NamedSharding(mesh, P())).lower(
        *args).compile()
    stats = jhlo.collective_bytes(compiled.as_text())
    return stats.counts, stats.bytes_by_kind


def test_collective_bytes_tp_mlp_closed_form():
    from torch.distributed.tensor import Replicate

    with fake_group(16) as group:
        rules = shd.ShardingRules(_one_dim_mesh(group), shd.TRAIN_RULES)
        x = shd.distribute(_meta(B, S, D), (None, None, None), rules)
        w1 = shd.distribute(_meta(D, F), (None, "mlp"), rules)
        w2 = shd.distribute(_meta(F, D), ("mlp", None), rules)
        with hlo.record_collectives() as record:
            y = torch.relu(x @ w1) @ w2
            y = y.redistribute(y.device_mesh, (Replicate(), Replicate()))
        assert y.to_local().shape == (B, S, D)
    stats = hlo.collective_bytes(record)
    assert stats.counts == {"all-reduce": 1}
    assert stats.bytes_by_kind == {"all-reduce": 2.0 * B * S * D * 4}
    assert stats.total_bytes == 2.0 * B * S * D * 4
    print("port:", stats.counts, stats.bytes_by_kind,
          "reference HLO (8 devices):", _reference_mlp_collectives())


def test_collective_bytes_fsdp_weight_all_gather():
    from torch.distributed.tensor import Replicate

    with fake_group(16) as group:
        mesh = Mesh(np.full((16,), torch.device("meta"), dtype=object),
                    ("data",), group=group)
        rules = shd.ShardingRules(mesh, shd.TRAIN_RULES)
        w = shd.distribute(_meta(D, F), ("embed", "mlp"), rules)
        assert w.to_local().shape == (D // 16, F)
        with hlo.record_collectives() as record:
            whole = w.redistribute(w.device_mesh, (Replicate(),))
        assert whole.to_local().shape == (D, F)
    stats = hlo.collective_bytes(record)
    assert stats.counts == {"all-gather": 1}
    assert stats.bytes_by_kind == {"all-gather": float(D * F * 4)}


def test_port_collectives_are_recorded():
    """The port's own collectives (the shard-map dispatch's) land in the
    record under the reference's kinds, with their result's bytes."""
    from repro_torch.distributed import collectives as col

    mesh = Mesh([torch.device("cpu")] * 4)
    vals = [torch.ones(3, 5) for _ in range(4)]
    with hlo.record_collectives() as record:
        col.all_gather_groups(mesh, vals, ("data",), dim=0)
        col.pmean(mesh, vals, ("data",), (3, 5), torch.float32)
    assert record == [("all-gather", 4 * 15 * 4), ("all-reduce", 15 * 4)]


def test_analyze_rates_the_collective_term():
    counts = {"flops": 2e12, "bytes": 1e9,
              "collectives": [("all-reduce", 100), ("all-gather", 50)],
              "argument_bytes": 300, "peak_live_bytes": 1000}
    r = hlo.analyze(counts, 256, model_flops=1e14)
    roof = r["roofline"]
    assert roof["coll_bytes_per_dev"] == 250.0
    assert roof["t_collective_s"] == 250.0 / hlo.H100_NVLINK_BW
    assert roof["flops"] == 2e12 and roof["t_compute_s"] == 2e12 / 989e12
    assert r["collectives"] == {"counts": {"all-reduce": 1, "all-gather": 1},
                                "bytes_by_kind": {"all-reduce": 200.0,
                                                  "all-gather": 50.0}}
    assert r["memory"]["temp_bytes_per_dev"] == 700
    assert r["memory"]["peak_bytes_per_dev"] == 1000


def test_rank0_flops_of_a_tp_matmul_cell():
    """x [B, S, D] over "batch" (the 16-way "data" axis) times w [D, F]
    (FSDP "embed" over "data", "mlp" over "model"): rank 0 multiplies
    its B / 16 rows by its F / 16 columns, after gathering its weight
    block."""
    prog = dryrun.Program(lambda x, w: x @ w, (_meta(B, S, D), _meta(D, F)),
                          (("batch", None, None), ("embed", "mlp")))
    cfg = get_reduced_config("stablelm-1.6b")
    whole = dryrun._trace(prog, cfg)
    assert whole["flops"] == 2 * B * S * D * F
    q = dryrun._trace(prog, cfg, (False, shd.TRAIN_RULES))
    assert q["flops"] == 2 * (B // 16) * S * D * (F // 16)
    assert q["coll_counts"] == {"all-gather": 1}
    assert q["coll_bytes"] == {"all-gather": float(D * (F // 16) * 4)}
    assert q["argument_bytes"] == (B // 16) * S * D * 4 + (D // 16) * (
        F // 16) * 4


def _over(arch, **kw):
    cfg = get_reduced_config(arch, **kw)
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_reduced_cells_report_sharded_terms(arch, monkeypatch):
    for name, cell in SMALL_CELLS.items():
        monkeypatch.setitem(SHAPE_CELLS, name, cell)
    over = _over(arch)
    for shape in ("train_4k", "decode_32k"):
        r = dryrun.run_cell(arch, shape, False, cfg_overrides=over)
        assert r["status"] == "ok", r.get("traceback")
        roof, mem = r["roofline"], r["memory"]
        assert mem["temp_bytes_per_dev"] is not None
        assert mem["temp_bytes_per_dev"] >= 0
        assert roof["t_collective_s"] == (roof["coll_bytes_per_dev"]
                                          / hlo.H100_NVLINK_BW)
        assert roof["coll_bytes_per_dev"] == sum(
            r["collectives"]["bytes_by_kind"].values())
        if shape == "train_4k":
            assert roof["coll_bytes_per_dev"] > 0


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "deepseek-v2-lite-16b"])
def test_deepseek_cells_take_the_shard_map_dispatch(arch, monkeypatch):
    for name, cell in MOE_CELLS.items():
        monkeypatch.setitem(SHAPE_CELLS, name, cell)
    over = _over(arch, n_experts=16)  # 16 experts over the 16-way "model"
    for shape in MOE_CELLS:
        r = dryrun.run_cell(arch, shape, False, cfg_overrides=over)
        assert r["status"] == "ok", r.get("traceback")
        assert set(r["moe_dispatch"]) == {"shard_map"}, r["moe_dispatch"]
        assert r["moe_dispatch"]["shard_map"] >= 1
        assert r["collectives"]["counts"].get("all-gather", 0) > 0


def test_traces_are_memoized_per_mesh(monkeypatch):
    for name, cell in SMALL_CELLS.items():
        monkeypatch.setitem(SHAPE_CELLS, name, cell)
    over = _over("stablelm-1.6b")
    traces = {}
    one = dryrun.run_cell("stablelm-1.6b", "decode_32k", False,
                          cfg_overrides=over, traces=traces)
    two = dryrun.run_cell("stablelm-1.6b", "decode_32k", True,
                          cfg_overrides=over, traces=traces)
    assert len(traces) == 2
    assert {k[4] for k in traces} == {False, True}
    assert one["status"] == two["status"] == "ok"
    assert one["memory"]["argument_bytes_per_dev"] >= \
        two["memory"]["argument_bytes_per_dev"]
