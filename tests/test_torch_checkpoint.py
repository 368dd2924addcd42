"""The port's checkpoints (``repro_torch.train.checkpoint``) against the
reference's on-disk format.

Counterpart of ``tests/test_checkpoint.py``: atomic saves, retention,
manifest validation, delta chains, crash litter and the preemption
plumbing, on torch trees.  Cross-package pins: a checkpoint of either
layout written by either package restores in the other bit for bit
(bfloat16 and uint8 leaves and Python-int counters included), the leaf
names equal ``jax.tree_util.tree_flatten_with_path``'s, and a mismatch
of names or dtypes raises the reference's diff word for word.
"""
import os
import threading
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import checkpoint as jck
from repro_torch.train import checkpoint as ck


def tree():
    return {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": {"c": torch.tensor(7, dtype=torch.int32),
                  "d": torch.ones(5, dtype=torch.bfloat16)}}


def meta_like(t):
    """The restore target: the same names, shapes and dtypes, no memory
    (tensors on the meta device, scalars kept)."""
    return ck._unflatten(t, [x.to("meta") if isinstance(x, torch.Tensor)
                             else x for x in ck._flatten_with_names(t)[1]])


def same_bits(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        if a.dtype != b.dtype or a.shape != b.shape:
            return False
        if a.dtype.is_floating_point:
            width = {2: torch.int16, 4: torch.int32, 8: torch.int64}
            a = a.view(width[a.element_size()])
            b = b.view(width[b.element_size()])
        return torch.equal(a, b)
    return type(a) is type(b) and a == b


def assert_trees_equal(a, b):
    na, la = ck._flatten_with_names(a)
    nb, lb = ck._flatten_with_names(b)
    assert na == nb
    for name, x, y in zip(na, la, lb):
        assert same_bits(x, y), name


def test_save_restore_roundtrip(tmp_path):
    t = tree()
    ck.save(str(tmp_path), 3, t)
    out = ck.restore(str(tmp_path), 3, t)
    assert_trees_equal(t, out)
    assert out["b"]["d"].dtype == torch.bfloat16


def test_no_tmp_left_behind(tmp_path):
    ck.save(str(tmp_path), 1, tree())
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))


def test_retention_keeps_latest(tmp_path):
    mgr = ck.CheckpointManager(str(tmp_path), keep=2, save_interval=1)
    for s in range(5):
        mgr.save(s, tree())
    assert ck.available_steps(str(tmp_path)) == [3, 4]
    assert mgr.latest_step() == 4


def test_restore_latest_with_manager(tmp_path):
    mgr = ck.CheckpointManager(str(tmp_path), keep=3)
    t = tree()
    mgr.save(7, t)
    step, out = mgr.restore_latest(meta_like(t), device="cpu")
    assert step == 7
    assert_trees_equal(t, out)


def test_restore_onto_meta_target_needs_a_device(tmp_path):
    t = tree()
    ck.save_incremental(str(tmp_path), 1, t)
    with pytest.raises(ValueError, match="meta"):
        ck.restore(str(tmp_path), 1, meta_like(t))
    devices = ck._unflatten(t, ["cpu"] * 3)
    assert_trees_equal(t, ck.restore(str(tmp_path), 1, meta_like(t),
                                     devices))


def test_corrupt_partial_checkpoint_ignored(tmp_path):
    mgr = ck.CheckpointManager(str(tmp_path), keep=3)
    mgr.save(1, tree())
    os.makedirs(tmp_path / "step_0000000002.tmp")
    assert mgr.latest_step() == 1


def test_shape_mismatch_raises(tmp_path):
    ck.save(str(tmp_path), 1, {"a": torch.zeros(3)})
    with pytest.raises(ValueError, match="shape"):
        ck.restore(str(tmp_path), 1, {"a": torch.zeros(4, device="meta")},
                   device="cpu")


def _mismatches():
    """(saved tree, target) pairs that must not load, for both packages:
    other names at the same leaf count, and another dtype."""
    return [
        ({"a": np.zeros(3, np.float32), "b": np.ones(3, np.float32)},
         {"a": np.zeros(3, np.float32), "c": np.zeros(3, np.float32)},
         "'b'.*'c'"),
        ({"a": np.zeros(3, np.float32)}, {"a": np.zeros(3, np.int32)},
         "dtype mismatch"),
    ]


def _tensors(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


@pytest.mark.parametrize("case", [0, 1])
def test_mismatch_raises_the_reference_diff(tmp_path, case):
    """Leaves are never matched by position alone, and the port's
    message is the reference's, word for word."""
    saved, target, match = _mismatches()[case]
    ck.save_incremental(str(tmp_path), 1, _tensors(saved))
    with pytest.raises(ValueError, match=match) as mine:
        ck.restore(str(tmp_path), 1, _tensors(target))
    with pytest.raises(ValueError, match=match) as theirs:
        jck.restore(str(tmp_path), 1, jax.tree.map(
            lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), target))
    assert str(mine.value) == str(theirs.value)


def test_restore_namedtuple_field_names_validated(tmp_path):
    """Different sampler states with the same leaf count do not
    cross-load."""
    from repro_torch.core.amper import AmperConfig, AmperSampler
    from repro_torch.core.per import SumTreePER
    from repro_torch.core.samplers import abstract_state

    ck.save(str(tmp_path), 1, SumTreePER(8, device="cpu").init())
    amper = AmperSampler(AmperConfig(capacity=8), device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        ck.restore(str(tmp_path), 1, abstract_state(amper), device="cpu")


def test_meta_roundtrip(tmp_path):
    ck.save(str(tmp_path), 5, tree(), meta={"mode": "sync", "draw": 17})
    assert ck.load_meta(str(tmp_path), 5) == {"mode": "sync", "draw": 17}
    assert jck.load_meta(str(tmp_path), 5) == {"mode": "sync", "draw": 17}
    assert ck.load_meta(str(tmp_path), 5).get("absent") is None


def test_manager_gcs_stale_tmp_dirs(tmp_path):
    mgr = ck.CheckpointManager(str(tmp_path), keep=3, save_interval=1)
    mgr.save(1, tree())
    os.makedirs(tmp_path / "step_0000000002.tmp")
    mgr.save(3, tree())
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))
    assert ck.available_steps(str(tmp_path)) == [1, 3]
    os.makedirs(tmp_path / "step_0000000009.tmp")
    ck.CheckpointManager(str(tmp_path))
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))


def test_preemption_hook_from_worker_thread_degrades(tmp_path):
    mgr = ck.CheckpointManager(str(tmp_path))
    out = {}

    def worker():
        out["installed"] = mgr.install_preemption_hook()

    th = threading.Thread(target=worker)
    th.start()
    th.join(timeout=10)
    assert out["installed"] is False
    assert not mgr.preempted
    mgr.request_preemption()
    assert mgr.preempted and mgr.should_save(1)


def test_preemption_sentinel_file_polled(tmp_path):
    mgr = ck.CheckpointManager(str(tmp_path))
    assert not mgr.preempted
    open(os.path.join(str(tmp_path), ck.PREEMPT_SENTINEL), "w").close()
    assert mgr.preempted


def test_preemption_sentinel_is_one_shot(tmp_path):
    open(os.path.join(str(tmp_path), ck.PREEMPT_SENTINEL), "w").close()
    mgr = ck.CheckpointManager(str(tmp_path))
    assert not mgr.preempted
    assert not os.path.exists(os.path.join(str(tmp_path),
                                           ck.PREEMPT_SENTINEL))


# ---------------------------------------------------------------- incremental


def ring_tree():
    """A tree shaped like replay state: a ring, priorities and a host int."""
    return {"ring": torch.arange(32, dtype=torch.float32).reshape(8, 4),
            "prio": torch.ones(8), "pos": 0}


def _with(t, **kw):
    out = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
           for k, v in t.items()}
    out.update(kw)
    return out


def test_incremental_full_is_self_contained(tmp_path):
    t = tree()
    ck.save_incremental(str(tmp_path), 4, t)
    assert os.path.exists(tmp_path / "step_0000000004.ckpt")
    out = ck.restore(str(tmp_path), 4, meta_like(t), device="cpu")
    assert_trees_equal(t, out)


def _chain(d):
    t = ring_tree()
    ck.save_incremental(d, 1, t)
    ring2 = t["ring"].clone()
    ring2[2:5] = -1.0
    t2 = _with(t, ring=ring2, pos=5)
    ck.save_incremental(d, 2, t2, base_step=1,
                        dirty={"ring": ck.Rows([(2, 5)]), "prio": False,
                               "pos": True})
    ring3, prio3 = ring2.clone(), t2["prio"].clone()
    ring3[6:], ring3[:1], prio3[3] = 7.0, 9.0, 0.5
    t3 = _with(t2, ring=ring3, prio=prio3, pos=1)
    ck.save_incremental(d, 3, t3, base_step=2,
                        dirty={"ring": ck.Rows([(6, 8), (0, 1)]),
                               "prio": ck.Rows([(3, 4)]), "pos": True})
    return t, t2, t3


def test_incremental_delta_chain_roundtrip(tmp_path):
    d = str(tmp_path)
    states = _chain(d)
    for step, want in zip((1, 2, 3), states):
        assert_trees_equal(want, ck.restore(d, step, ring_tree()))
    with np.load(os.path.join(d, "step_0000000003.ckpt")) as z:
        stored = {k: z[k].shape for k in z.files if k != "__manifest__"}
    ring_i = ck._flatten_with_names(states[2])[0].index("ring")
    assert stored[f"d{ring_i}"] == (3, 4)  # 3 + 1 ring rows, not 8


def test_incremental_delta_over_legacy_dir_base(tmp_path):
    d = str(tmp_path)
    t = ring_tree()
    ck.save(d, 1, t)
    ring2 = t["ring"].clone()
    ring2[0:2] = 3.0
    t2 = _with(t, ring=ring2, pos=2)
    ck.save_incremental(d, 2, t2, base_step=1,
                        dirty={"ring": ck.Rows([(0, 2)]), "prio": False,
                               "pos": True})
    assert_trees_equal(t2, ck.restore(d, 2, ring_tree()))


def test_incremental_validation_errors(tmp_path):
    d = str(tmp_path)
    t = ring_tree()
    with pytest.raises(ValueError, match="base_step"):
        ck.save_incremental(d, 2, t, dirty=ck.dirty_like(t))
    with pytest.raises(ValueError, match="not found"):
        ck.save_incremental(d, 2, t, base_step=1, dirty=ck.dirty_like(t))
    ck.save_incremental(d, 5, t)
    with pytest.raises(ValueError, match="precede"):
        ck.save_incremental(d, 5, t, base_step=5, dirty=ck.dirty_like(t))
    with pytest.raises(ValueError, match="leaves"):
        ck.save_incremental(d, 6, t, base_step=5,
                            dirty={"ring": True, "pos": True})
    with pytest.raises(ValueError, match="rank-0"):
        ck.save_incremental(d, 6, t, base_step=5,
                            dirty={"ring": True, "prio": True,
                                   "pos": ck.Rows([(0, 1)])})
    with pytest.raises(ValueError, match="outside"):
        ck.save_incremental(d, 6, t, base_step=5,
                            dirty={"ring": ck.Rows([(4, 99)]), "prio": True,
                                   "pos": True})
    ck.save(d, 7, t)
    with pytest.raises(ValueError, match="shadow"):
        ck.save_incremental(d, 7, t)


def test_manager_constructor_validates(tmp_path):
    with pytest.raises(ValueError, match="keep"):
        ck.CheckpointManager(str(tmp_path), keep=0)
    with pytest.raises(ValueError, match="save_interval"):
        ck.CheckpointManager(str(tmp_path), save_interval=0)
    with pytest.raises(ValueError, match="full_every"):
        ck.CheckpointManager(str(tmp_path), full_every=0)


def test_manager_delta_chain_compaction_and_gc(tmp_path):
    d = str(tmp_path)
    mgr = ck.CheckpointManager(d, keep=2, save_interval=1, full_every=3)
    t = ring_tree()
    states = {}
    for s in range(1, 8):
        ring = t["ring"].clone()
        ring[s % 8] = float(s)
        t = _with(t, ring=ring, pos=s % 8)
        states[s] = t
        mgr.save(s, t, dirty={"ring": ck.Rows([(s % 8, s % 8 + 1)]),
                              "prio": False, "pos": True})
    for s, base in ((1, None), (2, 1), (3, 2), (4, None), (5, 4), (6, 5),
                    (7, None)):
        if s in ck.available_steps(d):
            assert ck.load_manifest(d, s).get("base_step") == base, s
    steps = set(ck.available_steps(d))
    assert {6, 7} <= steps and {4, 5} <= steps
    assert steps.isdisjoint({1, 2, 3})
    for s in sorted(steps):
        assert_trees_equal(states[s], ck.restore(d, s, ring_tree()))


def test_manager_resumes_chain_across_construction(tmp_path):
    d = str(tmp_path)
    t = ring_tree()
    mgr = ck.CheckpointManager(d, keep=4, save_interval=1, full_every=3)
    mgr.save(1, t)
    mgr.save(2, t, dirty={"ring": ck.Rows([(0, 1)]), "prio": False,
                          "pos": True})
    mgr2 = ck.CheckpointManager(d, keep=4, save_interval=1, full_every=3)
    mgr2.save(3, t, dirty={"ring": ck.Rows([(1, 2)]), "prio": False,
                           "pos": True})
    assert ck.load_manifest(d, 3).get("base_step") == 2
    mgr2.save(4, t, dirty=ck.dirty_like(t, True))
    assert ck.load_manifest(d, 4).get("base_step") is None


def test_crash_between_rmtree_and_replace_resumes(tmp_path, monkeypatch):
    d = str(tmp_path)
    t = tree()
    ck.save(d, 1, t)
    ck.save(d, 2, t)

    def boom(src, dst):
        raise RuntimeError("killed mid-save")

    monkeypatch.setattr(ck.os, "replace", boom)
    with pytest.raises(RuntimeError, match="killed"):
        ck.save(d, 2, tree())
    monkeypatch.undo()
    assert "step_0000000002.tmp" in os.listdir(d)
    assert 2 not in ck.available_steps(d)
    mgr = ck.CheckpointManager(d, keep=3)
    assert mgr.latest_step() == 1
    assert not any(n.endswith(".tmp") for n in os.listdir(d))
    step, out = mgr.restore_latest(tree())
    assert step == 1
    assert_trees_equal(t, out)


def test_crash_mid_single_file_save_resumes(tmp_path, monkeypatch):
    d = str(tmp_path)
    t = tree()
    ck.save_incremental(d, 1, t)

    def boom(src, dst):
        raise RuntimeError("killed mid-save")

    monkeypatch.setattr(ck.os, "replace", boom)
    with pytest.raises(RuntimeError, match="killed"):
        ck.save_incremental(d, 2, t)
    monkeypatch.undo()
    assert "step_0000000002.ckpt.tmp" in os.listdir(d)
    mgr = ck.CheckpointManager(d, keep=3)
    assert mgr.latest_step() == 1
    assert not any(n.endswith(".tmp") for n in os.listdir(d))
    assert ck.gc_stale_tmp(d) == []


class Inner(NamedTuple):
    w: Any
    layers: Any


def test_manifest_names_equal_jax_flatten_with_path(tmp_path):
    """dict / tuple / list / NamedTuple nodes give jax's names and order
    (None no leaf), bare components joined with '/'."""
    t = {"m": Inner(w=torch.ones(3), layers=[torch.zeros(2), None,
                                             torch.arange(2)]),
         "k": (torch.tensor(1, dtype=torch.int32), torch.zeros(2)),
         "b": None, "a": 5}
    names, _ = ck._flatten_with_names(t)
    assert names == ["a", "k/0", "k/1", "m/w", "m/layers/0", "m/layers/2"]
    jt = jax.tree.map(lambda x: np.asarray(x), t)
    assert names == jck._flatten_with_names(jt)[0]
    ck.save_incremental(str(tmp_path), 1, t)
    assert ck.load_manifest(str(tmp_path), 1)["names"] == names
    assert ck.load_manifest(str(tmp_path), 1)["dtypes"][0] == "int32"
    assert_trees_equal(t, ck.restore(str(tmp_path), 1, t))


# --- cross-package: either package's files restore in the other --------------


def _jax_tree():
    return {"a": jnp.arange(12, dtype=jnp.float32).reshape(3, 4),
            "b": {"c": jnp.int32(-7), "d": jnp.arange(5, dtype=jnp.bfloat16),
                  "e": jnp.arange(6, dtype=jnp.uint8)},
            "n": Inner(w=jnp.array([True, False]),
                       layers=[jnp.int32(2 ** 31 - 1)])}


def _torch_of(jt):
    def leaf(x):
        x = np.asarray(x)
        if x.dtype.name == "bfloat16":
            return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
        return torch.from_numpy(x.copy())

    return jax.tree.map(leaf, jt)


@pytest.mark.parametrize("layout", ["dir", "file", "delta"])
def test_reference_checkpoint_restores_in_the_port(tmp_path, layout):
    d = str(tmp_path)
    jt = _jax_tree()
    if layout == "dir":
        jck.save(d, 1, jt, meta={"n_steps": 9})
    else:
        jck.save_incremental(d, 1, jt, meta={"n_steps": 9})
    step = 1
    if layout == "delta":
        jt = dict(jt, a=jt["a"].at[1:2].set(-3.0))
        dirty = jck.dirty_like(jt, False)
        dirty["a"] = jck.Rows([(1, 2)])
        jck.save_incremental(d, 2, jt, base_step=1, dirty=dirty)
        step = 2
    want = _torch_of(jt)
    assert_trees_equal(want, ck.restore(d, step, meta_like(want),
                                        device="cpu"))
    assert ck.load_meta(d, 1) == {"n_steps": 9}


@pytest.mark.parametrize("layout", ["dir", "file", "delta"])
def test_port_checkpoint_restores_in_the_reference(tmp_path, layout):
    d = str(tmp_path)
    t = _torch_of(_jax_tree())
    t["b"]["c"] = -7  # a host int, stored as the reference's int32
    if layout == "dir":
        ck.save(d, 1, t)
    else:
        ck.save_incremental(d, 1, t)
    step = 1
    if layout == "delta":
        t["a"] = t["a"].clone()
        t["a"][1:2] = -3.0
        dirty = ck.dirty_like(t, False)
        dirty["a"] = ck.Rows([(1, 2)])
        ck.save_incremental(d, 2, t, base_step=1, dirty=dirty)
        step = 2
    jt = _jax_tree()
    out = jck.restore(d, step, jax.tree.map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), jt))
    want = dict(t, b=dict(t["b"], c=torch.tensor(-7, dtype=torch.int32)))
    assert_trees_equal(want, _torch_of(out))
