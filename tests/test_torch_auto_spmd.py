"""The auto-SPMD side of the mesh (the logical-axis rules as DTensor
placements) against the JAX reference, on the CPU.

* ``ShardingRules.sharding``: every leaf of every config's param and
  cache axes, under each rule preset, on a (2, 4) and a (2, 2, 2) mesh
  (a fake process group of 8 ranks), equal entry for entry to the
  reference's ``NamedSharding(...).spec`` on the 8 host devices that
  ``tests/conftest.py`` forces.
* ``logical_constraint``: a no-op without rules and on a plain tensor;
  under rules a DTensor's placements become the spec's.
* A reduced float32 stablelm under the training and serve rules on 2
  ranks (a 1 x 2 mesh) and 4 (2 x 2), spawned over gloo
  (``tests/torch_spmd_ranks.py``): one sharded train step, a prefill and
  decode steps, against the reference's jitted step under the same rules
  on its (2, 2) mesh.  Tolerances: the loss, the grad norm, the updated
  params and the logits within rtol 1e-4 / atol 1e-5, and the first
  moments (scaled gradients) within rtol 1e-3 / atol 1e-6: the ranks sum
  their partial products in another order than XLA (ROADMAP C3), and a
  gradient sums those differences over the batch.
* The shard-map MoE dispatch trained on 4 ranks: output, metrics and
  every gradient equal to the single-process 2 x 2 mesh bit for bit, and
  within ``MOE_TOL`` of ``jax.grad`` through the reference's
  ``moe_apply_shard_map`` on its 2 x 2 mesh.
* ``fake_group``: no default group leaks out of it, and one held before
  it comes back.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh as JMesh

import torch_spmd_ranks as ranks
from repro.configs import get_config as jconfig
from repro.configs import get_reduced_config as jreduced
from repro.distributed import sharding as jshd
from repro.models.model_api import Model as JModel
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import Mesh
from repro_torch.launch.mesh import fake_group, run_ranks
from repro_torch.models.model_api import Model
from repro_torch.models.qhead import tree_leaves

CPU = torch.device("cpu")
WORLDS = (2, 4)
SPAWN_TIMEOUT = 240.0
RTOL, ATOL = 1e-4, 1e-5
MOMENT_RTOL, MOMENT_ATOL = 1e-3, 1e-6
MOE_TOL = 1e-5
MOE_KW = dict(d_model=32, n_experts=8, moe_top_k=2, moe_d_ff=16)
MESHES = {(2, 4): ("data", "model"), (2, 2, 2): ("pod", "data", "model")}
PROMPT, MAX_LEN, STEPS = 16, 24, 4


@pytest.fixture(autouse=True)
def partitionable():
    with jax.threefry_partitionable(True):
        yield


def _jmesh(shape, axes):
    n = int(np.prod(shape))
    if jax.device_count() < n:
        pytest.skip(f"needs {n} host devices (tests/conftest.py forces 8)")
    return JMesh(np.asarray(jax.devices()[:n]).reshape(shape), axes)


def _spec_of(rules, placements, ndim):
    """DTensor placements -> a partition spec's entries (None, a mesh axis,
    or a tuple of them, in mesh order), as the reference writes them."""
    from torch.distributed.tensor import Shard

    parts = []
    for d in range(ndim):
        axes = tuple(rules.mesh.axis_names[i]
                     for i, p in enumerate(placements)
                     if isinstance(p, Shard) and p.dim == d)
        parts.append(None if not axes else axes[0] if len(axes) == 1
                     else axes)
    return tuple(parts)


def _entries(spec, ndim):
    out = list(spec) + [None] * (ndim - len(spec))
    return tuple(tuple(e) if isinstance(e, list) else e for e in out)


def _paired(ours, theirs):
    """(our axes, the reference's) for each leaf, matched by key."""
    if isinstance(ours, dict):
        assert set(ours) == set(theirs)
        for k in ours:
            yield from _paired(ours[k], theirs[k])
    elif ours is not None:
        yield ours, theirs


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_sharding_matches_reference_named_sharding(arch):
    model = Model.from_config(get_config(arch))
    jm = JModel.from_config(jconfig(arch))
    trees = [(model.param_axes(), jm.param_axes()),
             (model.cache_axes(), jm.cache_axes())]
    n = 0
    for shape, names in MESHES.items():
        jmesh = _jmesh(shape, names)
        with fake_group(8) as group:
            mesh = Mesh(np.full(shape, CPU, dtype=object), names,
                        group=group)
            dmesh = mesh.device_mesh()
            assert tuple(dmesh.shape) == shape
            assert dmesh.mesh_dim_names == names
            for preset, rule_map in shd.RULE_PRESETS.items():
                rules = shd.ShardingRules(mesh, rule_map)
                jrules = jshd.ShardingRules(jmesh, jshd.RULE_PRESETS[preset])
                for ours, theirs in trees:
                    for axes, jaxes in _paired(ours, theirs):
                        assert tuple(axes) == tuple(jaxes)
                        try:
                            got_mesh, placements = rules.sharding(axes)
                        except ValueError:
                            # one mesh axis over two dims (the FSDP rules
                            # on an expert weight): NamedSharding refuses
                            # it too
                            with pytest.raises(Exception,
                                               match="duplicate entries"):
                                jrules.sharding(jaxes)
                            continue
                        assert got_mesh is dmesh
                        assert len(placements) == len(shape)
                        want = jrules.sharding(jaxes).spec
                        assert _spec_of(rules, placements, len(axes)) == \
                            _entries(want, len(axes)), (preset, axes)
                        n += 1
    assert n > 0


def test_tree_shardings_follow_the_axes_tree():
    model = Model.from_config(get_config("stablelm-1.6b"))
    with fake_group(8) as group:
        mesh = Mesh(np.full((2, 4), CPU, dtype=object), ("data", "model"),
                    group=group)
        rules = shd.ShardingRules(mesh, shd.TRAIN_RULES)
        tree = shd.tree_shardings(model.param_axes(), rules)
        assert set(tree) == set(model.param_axes())
        for axes, (dmesh, pl) in zip(_paired_leaves(model.param_axes()),
                                     _paired_leaves(tree)):
            assert (dmesh, pl) == rules.sharding(axes)


def _paired_leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paired_leaves(tree[k])
    else:
        yield tree


def test_device_mesh_needs_one_slot_a_rank():
    with pytest.raises(ValueError, match="one slot a rank"):
        Mesh([CPU] * 4).device_mesh()
    with fake_group(2) as group:
        with pytest.raises(ValueError, match="one slot a rank"):
            Mesh([CPU] * 4, group=group).device_mesh()


def test_logical_constraint_noop_and_placements():
    from torch.distributed.tensor import Replicate, Shard

    x = torch.zeros(8, 12, 16)
    assert shd.logical_constraint(x, ("batch", "seq", None)) is x
    with fake_group(8) as group:
        mesh = Mesh(np.full((2, 4), CPU, dtype=object), ("data", "model"),
                    group=group)
        rules = shd.ShardingRules(mesh, shd.TRAIN_RULES)
        with shd.use_rules(rules):
            assert shd.logical_constraint(x, ("batch", "seq", None)) is x
            dt = shd.distribute(x, (None, None, None))
            assert tuple(dt.placements) == (Replicate(), Replicate())
            got = shd.logical_constraint(dt, ("batch", "seq", None))
            # batch -> ("pod", "data") = "data" here, seq -> "model"
            assert tuple(got.placements) == (Shard(0), Shard(1))
            assert rules.spec(("batch", "seq", None)) == ("data", "model",
                                                          None)
            assert got.to_local().shape == (4, 3, 16)
            # a dim the mesh axes do not divide stays whole
            odd = shd.logical_constraint(
                shd.distribute(torch.zeros(3, 12, 16), (None,) * 3),
                ("batch", "seq", None))
            assert tuple(odd.placements) == (Replicate(), Replicate())
    assert not dist.is_initialized()


def test_fake_group_leaks_nothing_and_restores(tmp_path):
    assert not dist.is_initialized()
    with fake_group(16) as group:
        assert dist.get_world_size(group) == 16 and dist.get_rank() == 0
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        held = dist.group.WORLD
        with fake_group(256):
            assert dist.get_world_size() == 256
        assert dist.group.WORLD is held and dist.get_world_size() == 1
        t = torch.ones(3)
        dist.all_reduce(t)
        assert t.tolist() == [1.0, 1.0, 1.0]
    finally:
        dist.destroy_process_group()


# --- the dense model under the rules, across ranks ---------------------------


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


@pytest.fixture(scope="module")
def inputs():
    jcfg = jreduced(ranks.ARCH, **ranks.DENSE_KW)
    jparams = JModel.from_config(jcfg).init_params(jax.random.key(0))
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab_size, (4, 17)).astype(np.int32)
    mask = np.ones((4, 16), np.float32)
    mask[0, -5:] = 0.0
    dense = {"params": _np_tree(jparams),
             "batch": {"tokens": toks[:, :-1], "targets": toks[:, 1:],
                       "loss_mask": mask},
             "prompt": toks[:, :PROMPT].copy(), "max_len": MAX_LEN,
             "steps": [rng.integers(0, jcfg.vocab_size, (4, 1)).astype(
                 np.int32) for _ in range(STEPS)]}
    # the MoE layer's inputs
    D, E, F = MOE_KW["d_model"], MOE_KW["n_experts"], MOE_KW["moe_d_ff"]
    mp = {"router": rng.standard_normal((D, E)).astype(np.float32) * 0.1,
          "w_gate": rng.standard_normal((E, D, F)).astype(np.float32) * 0.2,
          "w_up": rng.standard_normal((E, D, F)).astype(np.float32) * 0.2,
          "w_down": rng.standard_normal((E, F, D)).astype(np.float32) * 0.2,
          "shared": {
              "w_gate": rng.standard_normal((D, 32)).astype(np.float32),
              "w_up": rng.standard_normal((D, 32)).astype(np.float32),
              "w_down": rng.standard_normal((32, D)).astype(np.float32)
              * 0.2}}
    x = rng.standard_normal((4, 8, D)).astype(np.float32)
    w = rng.standard_normal((4, 8, D)).astype(np.float32)
    tc = dataclasses.replace(get_config("deepseek-moe-16b"), **MOE_KW)
    return {"dense": dense, "moe": (tc, mp, x, w), "jparams": jparams}


@pytest.fixture(scope="module")
def spawned(inputs):
    cache = {}

    def get(world):
        if world not in cache:
            args = {k: v for k, v in inputs.items() if k != "jparams"}
            cache[world] = run_ranks(ranks.spmd_checks, world, (args,),
                                     device="cpu", timeout=SPAWN_TIMEOUT,
                                     threads=1)
        return cache[world]

    return get


@pytest.fixture(scope="module")
def reference(inputs):
    """The reference's jitted train step, prefill and decode steps under
    each preset's rules on its (2, 2) mesh."""
    jcfg = jreduced(ranks.ARCH, **ranks.DENSE_KW)
    jm = JModel.from_config(jcfg)
    jmesh = _jmesh((2, 2), ("data", "model"))
    d = inputs["dense"]
    out = {}
    for preset in ("tp", "serve"):
        rules = jshd.ShardingRules(jmesh, jshd.RULE_PRESETS[preset])
        with jmesh, jshd.use_rules(rules):
            jo = jopt.AdamW(ranks.LR)
            state = jts.TrainState(step=jnp.int32(0),
                                   params=inputs["jparams"],
                                   opt_state=jo.init(inputs["jparams"]))
            new, met = jax.jit(jts.make_train_step(jm, jo))(
                state, {k: jnp.asarray(v) for k, v in d["batch"].items()})
            logits, cache = jax.jit(
                lambda p, t: jm.prefill(p, {"tokens": t}, MAX_LEN))(
                inputs["jparams"], jnp.asarray(d["prompt"]))
            seen = [np.asarray(logits)]
            dec = jax.jit(jm.decode_step)
            for t in d["steps"]:
                logits, cache = dec(inputs["jparams"], jnp.asarray(t), cache)
                seen.append(np.asarray(logits))
        out[preset] = {"loss": float(met["loss"]),
                       "grad_norm": float(met["grad_norm"]),
                       "params": [np.asarray(x) for x in
                                  jax.tree.leaves(new.params)],
                       "m": [np.asarray(x) for x in
                             jax.tree.leaves(new.opt_state.m)],
                       "logits": seen}
    return out


def _close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=msg)


@pytest.mark.parametrize("preset", ["tp", "serve"])
@pytest.mark.parametrize("world", WORLDS)
def test_dense_train_step_under_rules(world, preset, spawned, reference):
    want = reference[preset]
    for r in spawned(world):
        got = r["dense"][preset]
        assert got["kept_placements"]
        _close(got["loss"], want["loss"], msg="loss")
        _close(got["grad_norm"], want["grad_norm"], msg="grad_norm")
        for a, b in zip(tree_leaves(got["params"]), want["params"]):
            _close(a, b, msg="params")
        for a, b in zip(tree_leaves(got["m"]), want["m"]):
            _close(a, b, MOMENT_RTOL, MOMENT_ATOL, msg="m")


@pytest.mark.parametrize("preset", ["tp", "serve"])
@pytest.mark.parametrize("world", WORLDS)
def test_dense_prefill_and_decode_under_rules(world, preset, spawned,
                                              reference):
    want = reference[preset]["logits"]
    for r in spawned(world):
        got = r["dense"][preset]["logits"]
        assert len(got) == len(want) == STEPS + 1
        for i, (a, b) in enumerate(zip(got, want)):
            _close(a, b, msg=f"step {i}")


# --- the shard-map MoE dispatch, trained --------------------------------------


@pytest.fixture(scope="module")
def reference_moe_grads(inputs):
    """``jax.grad`` of the same loss through the reference's
    ``moe_apply`` (its ``moe_apply_shard_map`` where the shapes tile)
    under the training rules on its 2 x 2 mesh."""
    _, mp, x, w = inputs["moe"]
    jc = dataclasses.replace(jconfig("deepseek-moe-16b"), **MOE_KW)
    from repro.models import moe as jmoe

    jmesh = _jmesh((2, 2), ("data", "model"))

    def loss(xx, p):
        out, m = jmoe.moe_apply(jc, p, xx)
        return (jnp.sum(out * w) + 0.01 * m["moe_lb_loss"]
                + 1e-3 * m["moe_z_loss"]), (out, m)

    with jmesh, jshd.use_rules(jshd.ShardingRules(jmesh, jshd.TRAIN_RULES)):
        (_, (out, m)), (gx, gp) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(jnp.asarray(x), mp)
    return {"out": np.asarray(out),
            # jax.tree.leaves sorts dict keys, as the port's tree_leaves
            "grads": [np.asarray(gx)] + [np.asarray(g) for g in
                                         jax.tree.leaves(gp)]}


def test_moe_shard_map_grads_bit_identical(inputs, spawned,
                                           reference_moe_grads):
    tc, mp, x, w = inputs["moe"]
    one = ranks.moe_grads(Mesh(np.full((2, 2), CPU, dtype=object),
                               ("data", "model")), tc, mp, x, w)
    assert len(one["grads"]) == 1 + len(tree_leaves(mp))
    for r in spawned(4):
        got = r["moe"]
        assert np.array_equal(got["out"].view(np.int32),
                              one["out"].numpy().view(np.int32))
        for k, v in got["metrics"].items():
            assert np.array_equal(v, one["metrics"][k].numpy()), k
        for a, b in zip(got["grads"], one["grads"]):
            assert np.array_equal(a.view(np.int32),
                                  b.numpy().view(np.int32))
    want = reference_moe_grads
    np.testing.assert_allclose(one["out"].numpy(), want["out"],
                               atol=MOE_TOL, rtol=MOE_TOL)
    for a, b in zip(one["grads"], want["grads"]):
        np.testing.assert_allclose(a.numpy(), b, atol=MOE_TOL, rtol=MOE_TOL)
    assert any(np.abs(g.numpy()).max() > 0 for g in one["grads"][1:])
