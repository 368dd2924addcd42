"""Dry run: trace one device's program of every (arch x shape x mesh)
cell on ``meta`` tensors, and draw the paper's own workload, the sharded
AMPER-fr sampler over a 2^28-row priority table, on the card.

Counterpart of ``repro/launch/dryrun.py``, which lowers and compiles each
cell's jitted step for a TPU pod with ``in_shardings`` from the
logical-axis rules and reads the per-device program XLA's partitioner
makes.  Here each cell builds the REAL step (``train_step.make_train_step``,
``Model.prefill`` or ``Model.decode_step``, as ``launch/train.py`` and
``serving/engine.py`` run them) and runs it once as rank 0 of a fake
process group of 256 (512 multi-pod) ranks (``launch/mesh.py::fake_group``):
its inputs are DTensors on the production mesh placed by the rules
(``distributed/sharding.py``, the divisible spec of each leaf), each
rank's block an empty ``meta`` tensor, so no memory is allocated, and
DTensor's sharding propagation issues the collectives XLA would insert
(the fake group runs none).  The run proves the shapes go through,
torch's counterpart of ``.lower().compile()``, and counts rank 0's own
work:

* FLOPs, by ``torch.utils.flop_counter``'s formulas applied to each op
  on rank 0's local tensors.  DTensor also runs each op once on
  global-shaped fake tensors to propagate shapes (and caches that by op
  signature); those calls are told apart by their ``FakeTensor``
  arguments and not counted.  The trace runs every iteration of a
  PyTorch loop, so none of ``inner_corrections``' terms is added for
  them; the attention kernels' calls (rank 0's heads, their meta branch
  computing nothing) get ``hlo_analysis.kernel_call_corrections``;
* bytes, each local operation's tensor arguments read once and its
  outputs written once (views and empty allocations move none, an
  overwrite does not read its target, a scatter writes only its rows;
  collectives move link bytes, counted apart);
* the collectives, by ``hlo_analysis.record_collectives``: ring-weighted
  bytes a device by kind (``coll_bytes_per_dev``, ``t_collective_s`` at
  the H100's NVLink rate);
* the peak of rank 0's live ``meta`` storage bytes, its inputs included:
  ``peak_bytes_per_dev``, and ``temp_bytes_per_dev`` = peak - arguments.

Stacks deeper than 12 layers are traced at the reference's two depths
(``n_dense + 2`` and ``n_dense + 8``) and every count extrapolated
linearly to the full depth, as the reference extrapolates its analysis
builds; a train step adds ``n_dense + 5`` and a quadratic, since its
bytes grow with the square of the depth (``_depths``); the peak of live
bytes is extrapolated on the line through the two deepest traces.  The mesh is part
of the trace, so a trace is memoized per mesh.  The deepseeks take the
shard-map MoE dispatch under the rules, as in the reference; a cell
reports the dispatches its trace ran (``moe_dispatch``).

``run_amper_cell`` builds the sharded AMPER-fr sampler
(``core/sharded.py::sharded_sample_fr``) over the production mesh's
("pod", "data") shards, 16 of 2^24 rows (or 32 of 2^23 multi-pod), fills
the table from one seeded generator on ``--device`` and draws a batch of
65,536 (the LM cells always trace on ``meta``); a second, traced draw
records its collectives and its temporary bytes.

Usage:
  python -m repro_torch.launch.dryrun --arch granite-34b --shape train_4k --multi-pod
  python -m repro_torch.launch.dryrun --all --out results/dryrun.json
  python -m repro_torch.launch.dryrun --all --both-meshes --amper --device cuda
"""
from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import os
import time
import traceback
import weakref
from fractions import Fraction
from typing import Any, Callable, NamedTuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as pytree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch import prng
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import ops
from repro_torch.launch import hlo_analysis
from repro_torch.launch.mesh import fake_group, make_production_mesh
from repro_torch.models import moe as moe_mod
from repro_torch.models.model_api import SHAPE_CELLS, Model
from repro_torch.train import train_step as ts_mod
from repro_torch.train.optimizer import AdamW, cosine_schedule

MAX_TRACED_LAYERS = 12   # deeper stacks: two depths, extrapolated
AMPER_SEED = 0           # the AMPER cell's table and key


def shard_shape(rules: shd.ShardingRules, spec_axes, shape) -> tuple:
    """One device's block of a leaf of ``shape`` under the rules."""
    out = []
    for dim, entry in zip(shape, rules.divisible_spec(spec_axes,
                                                      tuple(shape))):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else entry)
        for a in axes:
            dim //= rules.mesh.shape[a]
        out.append(dim)
    return tuple(out)


def _pairs(axes, tree):
    """(logical axes, tensor) per leaf of two parallel trees (dicts, named
    tuples, None for an absent subtree)."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in tree:
            yield from _pairs(axes[k], tree[k])
    elif hasattr(tree, "_fields"):
        for a, t in zip(axes, tree):
            yield from _pairs(a, t)
    else:
        yield axes, tree


def tree_shard_bytes(rules: shd.ShardingRules, axes_tree, tensor_tree) -> int:
    """One device's bytes of a tree of leaves under the rules."""
    total = 0
    for axes, t in _pairs(axes_tree, tensor_tree):
        n = 1
        for d in shard_shape(rules, axes, tuple(t.shape)):
            n *= d
        total += n * t.element_size()
    return total


def batch_axes_like(batch: dict) -> dict:
    """Logical axes for an input batch: shard dim 0 over "batch"."""
    return {k: ("batch",) + (None,) * (t.ndim - 1) for k, t in batch.items()}


_aten = torch.ops.aten
# ops that allocate without writing: no bytes moved (views move none either)
_NO_DATA = {_aten.empty.memory_format, _aten.empty_strided.default,
            _aten.new_empty.default, _aten.new_empty_strided.default,
            _aten.empty_like.default}
# in-place ops that write their first argument without reading it
_OVERWRITE = {_aten.copy_.default, _aten.fill_.Scalar, _aten.fill_.Tensor,
              _aten.zero_.default}
# in-place ops that write only the rows their last argument holds
_SCATTER = {_aten.index_copy_.default, _aten.index_put_.default,
            _aten.scatter_.src, _aten.index_add_.default}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in pytree_leaves(tree) if isinstance(t, torch.Tensor)]


def _locals(tree) -> list[torch.Tensor]:
    """The tensors of a tree, each DTensor as this rank's block."""
    return [t.to_local() if shd.is_dtensor(t) else t for t in _tensors(tree)]


def _moved_bytes(func, args, kwargs, outs) -> int:
    """Bytes one op reads and writes: each tensor argument read once and
    each output written once; a view or an empty allocation moves none,
    an overwrite does not read its target, and a scatter writes only the
    rows it is given."""
    if func.is_view or func in _NO_DATA:
        return 0
    if func in _OVERWRITE or func in _SCATTER:
        rest = _tensors((args[1:], kwargs))
        written = (_nbytes(args[0]) if func in _OVERWRITE
                   else _nbytes(rest[-1]))
        return sum(_nbytes(t) for t in rest) + written
    return (sum(_nbytes(t) for t in _tensors((args, kwargs)))
            + sum(_nbytes(t) for t in outs))


class _Trace(TorchDispatchMode):
    """FLOPs, bytes moved and live storage bytes over the ops dispatched
    inside it on plain tensors: a DTensor op is left to DTensor, whose
    local ops come back here, and an op on or making ``FakeTensor``s
    (DTensor's shape propagation) is run uncounted.  A storage is live from the op
    that makes it until its last tensor is gone (autograd's saved
    tensors included: a storage's Python object lives as long as its
    storage); ``inputs`` are live from the start.  Collectives move no
    memory bytes here: each goes to ``record`` (when given) as
    ``hlo_analysis.record_collectives`` records it."""

    def __init__(self, inputs, record: list | None = None):
        super().__init__()
        self.live = self.peak = self.bytes = 0
        self.flops = 0
        self.record = record  # collectives, as hlo_analysis records them
        self._storages: dict = {}
        for t in inputs:
            self._track(t)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._storages:
            return
        n = st.nbytes()
        self._storages[key] = weakref.ref(st, lambda _, k=key, n=n:
                                          self._freed(k, n))
        self.live += n
        self.peak = max(self.peak, self.live)

    def _freed(self, key: int, n: int) -> None:
        self.live -= n
        self._storages.pop(key, None)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if any(isinstance(t, FakeTensor) for t in _tensors((args, kwargs))
               + outs):
            return out
        for t in outs:
            self._track(t)
        if hlo_analysis.is_collective(func):
            entry = hlo_analysis.collective_entry(func, out)
            if entry is not None and self.record is not None:
                self.record.append(entry)
            return out
        self.bytes += _moved_bytes(func, args, kwargs, outs)
        count = flop_registry.get(func.overloadpacket)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        return out


class Program(NamedTuple):
    """One cell's step: ``fn(*args)`` on ``meta`` inputs; ``axes`` holds
    the logical-axes tree of each argument."""
    fn: Callable
    args: tuple
    axes: tuple


def lower_cell(arch: str, shape: str, multi_pod: bool,
               cfg_overrides: dict | None = None,
               rules_preset: str = "tp"):
    """Returns (program, mesh, rules, cfg, model_flops) or a skip
    marker."""
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    cell = SHAPE_CELLS[shape]
    if shape == "long_500k" and not cfg.supports_long_context:
        return ("skip", "full attention is O(S^2) at 524288; "
                        "long_500k runs only for SSM/hybrid/SWA archs")
    if shape == "long_500k" and cfg.family == "audio":
        return ("skip", "whisper decoder max context exceeded by design")

    mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
    model = Model.from_config(cfg)
    is_train = cell.kind == "train"
    rules = shd.ShardingRules(
        mesh, shd.RULE_PRESETS[rules_preset] if is_train
        else shd.SERVE_RULES)
    inputs = model.input_specs(shape)
    n_tokens = cell.global_batch * (cell.seq_len if cell.kind != "decode" else 1)
    model_flops = hlo_analysis.analytic_model_flops(
        cfg, n_tokens, "train" if is_train else "serve")

    if is_train:
        opt = AdamW(cosine_schedule(3e-4, 100, 10_000),
                    mixed_precision=(cfg.param_dtype == "bfloat16"))
        prog = Program(ts_mod.make_train_step(model, opt),
                       (ts_mod.abstract_train_state(model, opt), inputs),
                       (ts_mod.train_state_axes(model, opt),
                        batch_axes_like(inputs)))
    elif cell.kind == "prefill":
        prog = Program(
            lambda p, b: model.prefill(p, b, max_len=cell.seq_len),
            (model.abstract_params(), inputs),
            (model.param_axes(), batch_axes_like(inputs)))
    else:  # decode
        prog = Program(model.decode_step,
                       (model.abstract_params(), inputs["tokens"],
                        inputs["cache"]),
                       (model.param_axes(), ("batch", None),
                        model.cache_axes()))
    return prog, mesh, rules, cfg, model_flops


def _count(fn: Callable, args: tuple, cfg) -> dict:
    """Run ``fn(*args)`` once; this rank's counts."""
    inputs = _locals(args)
    before = dict(moe_mod.dispatches)
    from repro_torch.distributed import collectives as col

    record: list = []
    with ops.record_meta_calls() as calls, col.record() as notes, \
            _Trace(inputs, record) as tr:
        fn(*args)
    record += notes
    corr = hlo_analysis.kernel_call_corrections(cfg, calls)
    coll = hlo_analysis.collective_bytes(record)
    return {"flops": float(tr.flops), "bytes": float(tr.bytes),
            "peak_live_bytes": float(tr.peak),
            "argument_bytes": float(sum(_nbytes(t) for t in inputs)),
            "correction_flops": corr["flops"],
            "correction_bytes": corr["bytes"], "terms": corr["terms"],
            "coll_counts": coll.counts, "coll_bytes": coll.bytes_by_kind,
            "moe_dispatch": {k: moe_mod.dispatches[k] - before[k]
                             for k in before
                             if moe_mod.dispatches[k] != before[k]}}


def _materialize(tree, device):
    """Each DTensor leaf's meta block as zeros on ``device`` (a card: rank
    0's real program)."""
    from torch.distributed.tensor import DTensor

    def real(_, t):
        if not shd.is_dtensor(t):
            return t
        local = torch.zeros(t.to_local().shape, dtype=t.dtype, device=device)
        return DTensor.from_local(local, t.device_mesh, t.placements,
                                  run_check=False, shape=t.shape,
                                  stride=t.stride())

    return shd._tree_zip(real, tree, tree)


def _trace(prog: Program, cfg, sharding: tuple | None = None,
           device="meta") -> dict:
    """Run ``prog`` once on its meta inputs.  ``sharding=(multi_pod,
    rules)`` (a rule dict, ``shd.RULE_PRESETS``' values) runs it as rank
    0 of the production mesh's fake group, each input placed by its axes
    under the rules, and counts rank 0's work; None runs it whole, on
    one device.  A sharded run on another ``device`` (a card) runs rank
    0's program there on zeros: its kernels launch on rank 0's blocks
    and its memory is real (the fake collectives write nothing, so the
    values are not)."""
    if sharding is None:
        return _count(prog.fn, prog.args, cfg)
    from torch.distributed.tensor.experimental import implicit_replication

    multi_pod, rule_map = sharding
    with fake_group(512 if multi_pod else 256) as group:
        mesh = make_production_mesh(multi_pod=multi_pod, device=device,
                                    group=group)
        rules = shd.ShardingRules(mesh, rule_map)
        args = tuple(shd.distribute_tree(a, ax, rules)
                     for a, ax in zip(prog.args, prog.axes))
        if torch.device(device).type != "meta":
            args = tuple(_materialize(a, device) for a in args)
        with shd.use_rules(rules), implicit_replication():
            return _count(prog.fn, args, cfg)


def _depths(cfg, kind: str) -> list[int]:
    """The depths a cell is traced at: the full depth up to
    ``MAX_TRACED_LAYERS`` layers, else the reference's ``n_dense + 2``
    and ``n_dense + 8``, and for a train step ``n_dense + 5`` between
    them: its bytes grow with the square of the depth (each layer's
    gradient of a stacked param is a zero-filled tensor of the whole
    stack, and autograd sums the L of them), so three points fit them."""
    n_dense = cfg.first_dense_layers if cfg.n_experts else 0
    if cfg.n_layers <= MAX_TRACED_LAYERS:
        return [cfg.n_layers]
    mid = [n_dense + 5] if kind == "train" else []
    return [n_dense + 2, *mid, n_dense + 8]


def _extrapolate(points: dict, at: int):
    """The polynomial through ``{depth: value}`` (degree: one less than
    the points), at depth ``at``, in exact rational arithmetic."""
    total = Fraction(0)
    for x, y in points.items():
        term = Fraction(y)
        for x2 in points:
            if x2 != x:
                term *= Fraction(at - x2, x - x2)
        total += term
    return total


_DICTS = ("terms", "coll_counts", "coll_bytes", "moe_dispatch")  # per name


def _traced_quantities(arch, shape, multi_pod, cfg, cfg_overrides,
                       rules_preset, traces: dict | None) -> dict:
    """Rank 0's counts of one cell at full depth: one trace, or the
    traces at ``_depths`` extrapolated.  ``traces`` memoizes them by
    cell, depth and mesh."""
    depths = _depths(cfg, SHAPE_CELLS[shape].kind)
    qs = {}
    for depth in depths:
        key = (arch, shape, depth, repr(sorted((cfg_overrides or {}).items())),
               multi_pod, rules_preset)
        if traces is None or key not in traces:
            prog, _, rules, dcfg, _ = lower_cell(
                arch, shape, multi_pod, {**(cfg_overrides or {}),
                                         "n_layers": depth}, rules_preset)
            q = _trace(prog, dcfg, (multi_pod, rules.rules))
            if traces is not None:
                traces[key] = q
        else:
            q = traces[key]
        qs[depth] = q
    L = cfg.n_layers
    if depths == [L]:
        return {**qs[L], "depths": depths}
    out = {k: float(_extrapolate({d: q[k] for d, q in qs.items()}, L))
           for k in qs[depths[0]] if k not in _DICTS}
    # a peak is the largest of terms linear in the depth: past the
    # shallowest trace, where another term may lead, it grows on a line
    out["peak_live_bytes"] = float(_extrapolate(
        {d: qs[d]["peak_live_bytes"] for d in depths[-2:]}, L))
    for name in _DICTS:
        keys = set().union(*(q[name] for q in qs.values()))
        out[name] = {k: _extrapolate({d: q[name].get(k, 0)
                                      for d, q in qs.items()}, L)
                     for k in keys}
        if name != "coll_bytes":
            out[name] = {k: round(v) for k, v in out[name].items()}
        else:
            out[name] = {k: float(v) for k, v in out[name].items()}
    return {**out, "depths": depths}


def run_cell(arch: str, shape: str, multi_pod: bool,
             cfg_overrides: dict | None = None, rules_preset: str = "tp",
             traces: dict | None = None) -> dict:
    """Trace one cell (see the module docstring) and report rank 0's
    memory, FLOPs, corrections, collectives and roofline; ``traces`` as
    ``_traced_quantities``."""
    t0 = time.perf_counter()
    out = {"arch": arch, "shape": shape,
           "mesh": "2x16x16" if multi_pod else "16x16"}
    cell = SHAPE_CELLS[shape]
    try:
        res = lower_cell(arch, shape, multi_pod, cfg_overrides=cfg_overrides,
                         rules_preset=rules_preset)
        if res[0] == "skip":
            out.update(status="skip", reason=res[1])
            return out
        prog, mesh, rules, cfg, model_flops = res
        n_dev = mesh.devices.size
        arg_bytes = sum(tree_shard_bytes(rules, a, t)
                        for a, t in zip(prog.axes, prog.args))
        global_args = sum(_nbytes(t) for t in _tensors(prog.args))
        q = _traced_quantities(arch, shape, multi_pod, cfg, cfg_overrides,
                               rules_preset, traces)
        report = hlo_analysis.analyze(
            {"flops": q["flops"], "bytes": q["bytes"],
             "collectives": hlo_analysis.CollectiveStats(q["coll_counts"],
                                                         q["coll_bytes"]),
             "argument_bytes": arg_bytes,
             "peak_live_bytes": q["peak_live_bytes"]},
            n_dev, model_flops, corrections={"flops": q["correction_flops"],
                                             "bytes": q["correction_bytes"]})
        out.update(
            status="ok", trace_s=round(time.perf_counter() - t0, 2),
            traced_depths=q["depths"],
            memory={**report["memory"],
                    "argument_bytes": global_args,
                    "peak_live_bytes": q["peak_live_bytes"]},
            roofline=report["roofline"],
            collectives=report["collectives"],
            moe_dispatch=q["moe_dispatch"],
            traced_flops=q["flops"], traced_bytes=q["bytes"],
            correction_flops=q["correction_flops"],
            correction_bytes=q["correction_bytes"],
            corrected_terms=q["terms"])
        if cell.kind == "decode":
            # bandwidth floor: params + cache must stream once/token.
            p_bytes = sum(_nbytes(t) for t in _tensors(prog.args[0]))
            c_bytes = sum(_nbytes(t) for t in _tensors(prog.args[2]))
            floor = (p_bytes + c_bytes) / n_dev
            actual = out["roofline"]["bytes_accessed"]
            out["decode_bandwidth"] = {
                "floor_bytes_per_dev": floor,
                "actual_bytes_per_dev": actual,
                "bandwidth_efficiency": floor / max(actual, 1.0),
                "floor_latency_s": floor / hlo_analysis.H100_HBM_BW,
            }
    except Exception as e:  # a cell failure is a bug — surface it loudly
        out.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
    return out


class AmperCell(NamedTuple):
    """The AMPER cell: ``draw(pq, valid, key) -> int32[batch]`` global
    indices over the per-shard tables ``pq`` / ``valid`` (one tensor a
    shard, in shard order)."""
    draw: Callable
    pq: tuple
    valid: tuple
    key: torch.Tensor
    cfg: Any
    n_shards: int


def amper_cell(mesh, table_log2: int, batch: int,
               device="cuda") -> AmperCell:
    """The reference's sharded AMPER-fr cell (m = 20, lambda' = 2.0, a CSP
    of 15% of the table, the default ``fr_mode``) over ``mesh``'s ("pod",
    "data") shards, on a full table (every row live) of priorities
    uniform in [0, V_max) from one generator on ``device`` seeded with
    ``AMPER_SEED``, and key ``prng.key(AMPER_SEED)``.  Another mode draws
    from the same table through ``sharded_sample_fr`` with
    ``cfg._replace(fr_mode=...)``.  On a process mesh each rank keeps
    only the shards it holds (the generator still runs over every shard,
    so each holds the rows the single-process cell holds); ``n_shards``
    counts every shard."""
    from repro_torch.core import quantize as qz
    from repro_torch.core import sharded as shc
    from repro_torch.core.amper import AmperConfig

    n = 1 << table_log2
    axes = [a for a in ("pod", "data") if a in mesh.axis_names]
    cfg = AmperConfig(capacity=n, m=20, lam_fr=2.0,
                      csp_capacity=int(n * 0.15))
    draw = shc.sharded_sample_fr(mesh, cfg, batch, axis_names=axes)
    resolved = shc.resolve_axes(mesh, axes)
    devices = mesh.shard_devices(resolved)
    held = set(mesh.local_shards(resolved))
    n_local = n // len(devices)
    gen = torch.Generator(device=device).manual_seed(AMPER_SEED)
    pq, valid = [], []
    for s, d in enumerate(devices):  # shard by shard: the whole float
        # table never lives
        p = torch.rand(n_local, generator=gen, device=device) * cfg.v_max
        if s in held:
            pq.append(qz.quantize(p, cfg.v_max, cfg.frac_bits).to(d))
            valid.append(torch.ones(n_local, dtype=torch.bool, device=d))
    return AmperCell(draw, tuple(pq), tuple(valid), prng.key(AMPER_SEED),
                     cfg, len(devices))


def run_amper_cell(multi_pod: bool, table_log2: int = 28,
                   batch: int = 65536, device="cuda") -> dict:
    """The paper's own workload at scale: sharded AMPER-fr sampling on
    ``device`` over the production mesh's shards.  ``compile_s`` is the
    seconds to build the sampler and its table plus the first draw;
    memory and the roofline are per shard (one shard a device of the
    reference's mesh): its table read once.  A second draw, traced,
    records the collectives (each one's result bytes on one shard) and
    the peak of the draw's live storage above its inputs, over the
    shards: ``temp_bytes_per_dev``."""
    out = {"arch": "amper-replay", "shape": f"sample_2^{table_log2}",
           "mesh": "2x16x16" if multi_pod else "16x16"}
    t0 = time.perf_counter()
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, device=device)
        cell = amper_cell(mesh, table_log2, batch, device)
        idx = cell.draw(cell.pq, cell.valid, cell.key)
        lo, hi = int(idx.min()), int(idx.max())  # waits for the draw
        compile_s = time.perf_counter() - t0
        n_local = cell.pq[0].shape[0]
        shard_bytes = n_local * (cell.pq[0].element_size()
                                 + cell.valid[0].element_size())
        inputs = [*cell.pq, *cell.valid, cell.key]
        with hlo_analysis.record_collectives() as record, \
                _Trace(inputs) as tr:  # the draw's collectives: the port's
            again = cell.draw(cell.pq, cell.valid, cell.key)
        if not torch.equal(again, idx):
            raise RuntimeError("the traced draw differs from the first")
        temp = (tr.peak - sum(_nbytes(t) for t in inputs)) / cell.n_shards
        report = hlo_analysis.analyze(
            {"flops": 0.0, "bytes": float(shard_bytes), "collectives": record,
             "argument_bytes": shard_bytes,
             "peak_live_bytes": shard_bytes + temp}, cell.n_shards)
        out.update(
            status="ok", compile_s=round(compile_s, 2),
            device=str(cell.pq[0].device), fr_mode=cell.cfg.fr_mode,
            n_shards=cell.n_shards, rows_per_shard=n_local, batch=batch,
            draw_index_range=[lo, hi],
            memory={**report["memory"],
                    "table_bytes": shard_bytes * cell.n_shards},
            roofline=report["roofline"],
            collectives=report["collectives"])
        if not 0 <= lo <= hi < n_local * cell.n_shards:
            out.update(status="error",
                       error=f"draw outside the table: [{lo}, {hi}]")
    except Exception as e:
        out.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--amper", action="store_true",
                    help="also run the sharded AMPER sampler on --device")
    ap.add_argument("--rules", default="tp", choices=["tp", "fsdp"],
                    help="train sharding preset (hillclimb knob)")
    ap.add_argument("--set", action="append", default=[],
                    help="cfg override key=value (repeatable), e.g. "
                         "--set param_dtype=bfloat16 --set ce_block=4096")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="where the AMPER cell's table lives and draws "
                         "(the LM cells always trace on meta)")
    args = ap.parse_args(argv)

    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        try:
            v = ast.literal_eval(v)  # ints/floats/bools/tuples
        except (ValueError, SyntaxError):
            pass
        overrides[k] = v

    if args.all:
        archs, shapes = list(ARCH_IDS), list(SHAPE_CELLS)
    else:
        archs = [args.arch] if args.arch else list(ARCH_IDS)
        shapes = [args.shape] if args.shape else list(SHAPE_CELLS)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    results = []
    traces: dict = {}
    for mp in meshes:
        for arch in archs:
            for shape in shapes:
                r = run_cell(arch, shape, mp, cfg_overrides=overrides or None,
                             rules_preset=args.rules, traces=traces)
                results.append(r)
                roof = r.get("roofline", {})
                print(f"[{r['mesh']}] {arch} x {shape}: {r['status']}"
                      + (f" bottleneck={roof.get('bottleneck')}"
                         f" frac={roof.get('roofline_fraction')}"
                         if r["status"] == "ok" else
                         f" ({r.get('reason', r.get('error'))})"),
                      flush=True)
        if args.amper:
            r = run_amper_cell(mp, device=args.device)
            results.append(r)
            print(f"[{r['mesh']}] amper-replay: {r['status']}"
                  + (f" ({r.get('error')})" if r["status"] == "error" else
                     f" compile_s={r['compile_s']}"), flush=True)

    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1, default=str)
        print(f"wrote {args.out}")
    n_err = sum(r["status"] == "error" for r in results)
    print(f"done: {len(results)} cells, {n_err} errors")
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
