"""The logical-axis rules, the dry run's abstract model and shard shapes
against the JAX reference, exactly.

For all 10 archs of the zoo, both production meshes and the three rule
presets: ``ShardingRules.spec`` against the reference's
``PartitionSpec`` (as a tuple), and each leaf's shard shape against the
reference's ``launch/dryrun.py::_divisible_sharding`` on a
``jax.sharding.AbstractMesh`` of the same shape (no devices), over every
input of the four shape cells (the train state, the params, the batch,
the decode cache); a leaf the reference refuses (one mesh axis over two
dims: the MoE experts under ``fsdp``) is refused by the port too.
``param_axes``, ``cache_axes`` and ``train_state_axes`` equal the
reference's trees; ``input_specs``, ``abstract_params`` and
``abstract_train_state`` give the reference's shapes and dtypes (the
decode cache against ``jax.eval_shape(init_cache)``).

The reference's ``launch/dryrun.py`` sets ``XLA_FLAGS`` (512 host
devices) when imported; it is imported only after this process's jax
backend is up, which the flag can no longer change, and the variable is
put back at once.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import get_config as jget_config
from repro.distributed import sharding as jshd
from repro.models.model_api import SHAPE_CELLS as J_SHAPE_CELLS
from repro.models.model_api import Model as JModel
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.distributed import sharding as shd
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.model_api import SHAPE_CELLS, Model
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts

MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}
JDTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
          torch.int32: jnp.int32}


@pytest.fixture(autouse=True)
def partitionable():
    with jax.threefry_partitionable(True):
        yield


@pytest.fixture(scope="module")
def jdry():
    """The reference's dryrun module, imported without letting its
    XLA_FLAGS reach this process's jax or its children."""
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


def _flat(tree, path=()):
    """(path, leaf) pairs of dicts (sorted keys), named tuples (fields)
    and leaves (an axes tuple is one); None is a leaf, so absent
    subtrees compare too."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (k,))
    elif hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _flat(getattr(tree, f), path + (f,))
    else:
        yield path, tree


def _shape_dtype(tree):
    return [(p, None if x is None else
             (tuple(x.shape), str(x.dtype).split(".")[-1]))
            for p, x in _flat(tree)]


def _models(arch, **over):
    return (Model.from_config(dataclasses.replace(get_config(arch), **over)),
            JModel.from_config(dataclasses.replace(jget_config(arch), **over)))


def test_rule_tables_equal_reference():
    assert shd.TRAIN_RULES == jshd.TRAIN_RULES
    assert shd.SERVE_RULES == jshd.SERVE_RULES
    assert shd.TRAIN_RULES_FSDP == jshd.TRAIN_RULES_FSDP
    assert shd.RULE_PRESETS == jshd.RULE_PRESETS
    assert tuple(ARCH_IDS) == tuple(J_ARCH_IDS)
    assert {k: tuple(v) for k, v in SHAPE_CELLS.items()} == {
        k: tuple(v) for k, v in J_SHAPE_CELLS.items()}


@pytest.mark.parametrize("mixed", [False, True], ids=["f32", "bf16_params"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_axes_trees_equal_reference(arch, mixed):
    over = {"param_dtype": "bfloat16"} if mixed else {}
    tm, jm = _models(arch, **over)
    assert tm.param_axes() == jm.param_axes()
    assert tm.cache_axes() == jm.cache_axes()
    topt_ = topt.AdamW(1e-3, mixed_precision=mixed)
    jopt_ = jopt.AdamW(1e-3, mixed_precision=mixed)
    assert list(_flat(tts.train_state_axes(tm, topt_))) == list(_flat(
        jts.train_state_axes(jm, jopt_)))
    assert list(_flat(tts.train_state_axes(tm))) == list(_flat(
        jts.train_state_axes(jm)))
    # the abstract state: the reference's shapes and dtypes, on meta
    got = tts.abstract_train_state(tm, topt_)
    assert all(x is None or x.device.type == "meta" for _, x in _flat(got))
    assert _shape_dtype(got) == _shape_dtype(
        jts.abstract_train_state(jm, jopt_))
    assert _shape_dtype(tm.abstract_params()) == _shape_dtype(
        jm.abstract_params())


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_equal_reference(arch):
    tm, jm = _models(arch)
    for shape in SHAPE_CELLS:
        got, want = tm.input_specs(shape), jm.input_specs(shape)
        assert all(t.device.type == "meta"
                   for _, t in _flat(got)), shape
        assert _shape_dtype(got) == _shape_dtype(want), shape
    cell = SHAPE_CELLS["decode_32k"]
    want = jax.eval_shape(lambda: jm.init_cache(cell.global_batch,
                                                cell.seq_len))
    assert _shape_dtype(tm.input_specs("decode_32k")["cache"]) == \
        _shape_dtype(want)


def _cell_leaves(tm, shape):
    """(logical axes, tensor) of every input of the cell's step, as the
    dry run lays them out (train: the state and the batch, with the
    fsdp / tp optimizer; prefill: params and batch; decode: params,
    tokens and cache)."""
    inputs = tm.input_specs(shape)
    kind = SHAPE_CELLS[shape].kind
    if kind == "train":
        opt = topt.AdamW(1e-3, mixed_precision=(
            tm.cfg.param_dtype == "bfloat16"))
        trees = [(tts.train_state_axes(tm, opt),
                  tts.abstract_train_state(tm, opt)),
                 (dryrun.batch_axes_like(inputs), inputs)]
    elif kind == "prefill":
        trees = [(tm.param_axes(), tm.abstract_params()),
                 (dryrun.batch_axes_like(inputs), inputs)]
    else:
        trees = [(tm.param_axes(), tm.abstract_params()),
                 (("batch", None), inputs["tokens"]),
                 (tm.cache_axes(), inputs["cache"])]
    return [pair for axes, tree in trees for pair in dryrun._pairs(axes,
                                                                    tree)]


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_and_shard_shapes_equal_reference(jdry, arch, multi_pod):
    shape_, names = MESHES[multi_pod]
    tmesh = make_production_mesh(multi_pod=multi_pod, device="meta")
    assert (tuple(tmesh.shape.values()), tmesh.axis_names) == (shape_,
                                                               names)
    jmesh = AbstractMesh(shape_, names)
    tm, _ = _models(arch)
    n_leaves = n_refused = 0
    for preset in ("tp", "fsdp", "serve"):
        trules = shd.ShardingRules(tmesh, shd.RULE_PRESETS[preset])
        jrules = jshd.ShardingRules(jmesh, jshd.RULE_PRESETS[preset])
        for shape in SHAPE_CELLS:
            kind = SHAPE_CELLS[shape].kind
            if (preset == "serve") != (kind != "train"):
                continue  # the dry run's pairing of presets and cells
            for axes, t in _cell_leaves(tm, shape):
                assert trules.spec(axes) == tuple(jrules.spec(axes)), axes
                aval = jax.ShapeDtypeStruct(tuple(t.shape),
                                            JDTYPE[t.dtype])
                try:
                    want = jdry._divisible_sharding(
                        jrules, axes, aval).shard_shape(aval.shape)
                except Exception as e:  # noqa: BLE001
                    if type(e).__name__ != "DuplicateSpecError":
                        raise
                    with pytest.raises(ValueError, match="two dims"):
                        dryrun.shard_shape(trules, axes, tuple(t.shape))
                    n_refused += 1
                    continue
                got = dryrun.shard_shape(trules, axes, tuple(t.shape))
                assert got == tuple(want), (preset, shape, axes, t.shape)
                n_leaves += 1
    assert n_leaves > 100
    assert bool(n_refused) == bool(tm.cfg.n_experts)


def test_tree_pspecs_and_active_rules():
    mesh = make_production_mesh(multi_pod=True, device="meta")
    rules = shd.ShardingRules(mesh, shd.TRAIN_RULES)
    tm, jm = _models("granite-34b")
    jrules = jshd.ShardingRules(AbstractMesh(*MESHES[True]),
                                jshd.TRAIN_RULES)
    got = shd.tree_pspecs(tm.param_axes(), rules)
    want = jshd.tree_pspecs(jm.param_axes(), jrules)
    assert [(p, x) for p, x in _flat(got)] == [
        (p, tuple(x)) for p, x in _flat(want)]
    state = shd.tree_pspecs(tts.train_state_axes(tm), rules)
    assert state.opt_state.master is None and state.step == ()
    assert shd.active_rules() is None
    with shd.use_rules(rules) as r:
        assert shd.active_rules() is r
    assert shd.active_rules() is None
    # no "pod" on the single-pod mesh: dropped, as the reference drops it
    single = shd.ShardingRules(make_production_mesh(device="meta"),
                               shd.TRAIN_RULES)
    assert single.spec(("batch", "seq", None)) == ("data", "model", None)
    assert rules.spec(("batch", "seq", None)) == (("pod", "data"), "model",
                                                  None)
