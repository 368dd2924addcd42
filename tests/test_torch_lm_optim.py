"""The port's LM optimizer, train step, train-state interop and the other
dense configs against the JAX reference, on the CPU.

Inputs and tolerances as ``test_torch_lm_train.py`` states them (float32
values rtol 1e-5 / atol 1e-6, gradients and moments rtol 1e-4 / atol
1e-5; the int8 compressor's integers exact).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jreduced
from repro.models.model_api import Model as JModel
from repro.serving import Engine as JEngine
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.models.model_api import Model
from repro_torch.models.qhead import tree_leaves
from repro_torch.serving import Engine
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts
from test_torch_lm_train import (GRAD_ATOL, GRAD_RTOL, _close, _jleaves,
                                 _lm_setup)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def _grad_tree(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: (rng.standard_normal(p.shape) * 0.3).astype(np.float32),
        params)


@pytest.mark.parametrize("mixed", [False, True], ids=["f32", "mixed"])
def test_adamw_matches_reference(mixed):
    """Three AdamW steps on the same grads: clipping (one step's norm
    above ``clip_norm``), weight decay, the cosine schedule in its warmup
    and decay, and with ``mixed_precision`` the bf16 params re-derived
    from the f32 master."""
    over = {"param_dtype": "bfloat16"} if mixed else {}
    jcfg = jreduced("stablelm-1.6b", dtype="float32", **over)
    jparams = JModel.from_config(jcfg).init_params(jax.random.key(2))
    sched = (0.01, 2, 5)
    jo = jopt.AdamW(jopt.cosine_schedule(*sched), clip_norm=40.0,
                    mixed_precision=mixed)
    to = topt.AdamW(topt.cosine_schedule(*sched), clip_norm=40.0,
                    mixed_precision=mixed)
    jst = jo.init(jparams)
    tparams = interop.lm_params_from_jax(jax.tree.map(np.asarray, jparams),
                                         "cpu")
    tst = to.init(tparams)
    jupd = jax.jit(jo.update)
    for step in range(3):
        g = _grad_tree(jparams, step)
        if step == 1:
            g = jax.tree.map(lambda x: x * 50, g)  # norm above clip_norm
        jparams, jst, jm = jupd(g, jst, jparams)
        tg = interop.lm_params_from_jax(g, "cpu")
        tparams, tst, tm = to.update(tg, tst, tparams)
        _close(tm["grad_norm"], jm["grad_norm"], msg="grad_norm")
        _close(tm["lr"], jm["lr"], msg="lr")
        assert int(tst.count) == int(jst.count) == step + 1
        for name, a, b in (("m", tst.m, jst.m), ("v", tst.v, jst.v),
                           ("params", tparams, jparams),
                           ("master", tst.master, jst.master)):
            if b is None:
                assert a is None
                continue
            for x, y in zip(tree_leaves(a), _jleaves(b)):
                assert str(x.dtype)[6:] == str(y.dtype), name
                if x.dtype == torch.bfloat16:  # one bf16 rounding step
                    _close(x, y, rtol=2 ** -7, atol=1e-6, msg=name)
                else:
                    _close(x, y, msg=name)


def test_cosine_schedule_and_global_norm_match_reference():
    jf, tf = jopt.cosine_schedule(3e-4, 20, 100), topt.cosine_schedule(
        3e-4, 20, 100)
    steps = np.arange(0, 130, dtype=np.int32)
    want = np.asarray(jax.jit(jax.vmap(jf))(steps))
    got = torch.stack([tf(torch.tensor(int(s), dtype=torch.int32))
                       for s in steps])
    _close(got, want)
    tree = _grad_tree({"a": np.zeros((7, 5)), "b": [np.zeros(3)]}, 4)
    _close(topt.global_norm(interop.lm_params_from_jax(tree, "cpu")),
           jax.jit(jopt.global_norm)(tree))


def test_int8_error_feedback_exact():
    """Three steps of feedback, each from the reference's carried error:
    the quantized integers and the scales bit for bit.  The carried error
    ``t - q * s`` is the port's fused form (one rounding); XLA's CPU code
    fuses it in its vector loop and rounds twice in its scalar remainder
    (which elements fall there depends on the shape, as in ROADMAP C9),
    so each reference element equals the fused or the twice-rounded
    value, and most equal the port's."""
    rng = np.random.default_rng(7)
    shapes = {"w": (33, 17), "b": (5,), "deep": {"x": (4, 4, 3)}}
    g_np = [jax.tree.map(lambda s: (rng.standard_normal(s) * 3 ** i)
                         .astype(np.float32), shapes,
                         is_leaf=lambda s: isinstance(s, tuple))
            for i in range(3)]
    jerr = jax.tree.map(lambda x: np.zeros_like(x), g_np[0])
    jef = jax.jit(jopt.ef_compress_tree)
    fused_share = []
    for g in g_np:
        tg, te = (interop.lm_params_from_jax(x, "cpu") for x in (g, jerr))
        tq, terr = topt.ef_compress_tree(tg, te)
        jq, jerr = jef(g, jerr)
        for (q, s), (wq, ws), t, werr, err in zip(
                [tq["b"], tq["deep"]["x"], tq["w"]],
                [jq["b"], jq["deep"]["x"], jq["w"]],
                [tg["b"] + te["b"], tg["deep"]["x"] + te["deep"]["x"],
                 tg["w"] + te["w"]],
                [jerr["b"], jerr["deep"]["x"], jerr["w"]],
                [terr["b"], terr["deep"]["x"], terr["w"]]):
            assert q.dtype == torch.int8
            np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
            assert s.numpy().view(np.int32) == np.asarray(ws).view(np.int32)
            twice = (t - q.to(torch.float32) * s).numpy().view(np.int32)
            got = err.numpy().view(np.int32)
            want = np.asarray(werr).view(np.int32)
            assert np.all((want == got) | (want == twice))
            fused_share.append(float((want == got).mean()))
    assert np.mean(fused_share) > 0.5
    x = np.float32([0.0, 1.5, -2.5, 127.0, 3e-3])
    q, s = topt.quantize_int8(torch.from_numpy(x))
    wq, ws = jax.jit(jopt.quantize_int8)(x)
    np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(topt.dequantize_int8(q, s).numpy(),
                                  np.asarray(jopt.dequantize_int8(wq, ws)))


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(microbatches):
    jcfg, tcfg, jparams, _, jbatch, tbatch = _lm_setup(
        dtype="float32", b=4, s=24)
    jm, tm = JModel.from_config(jcfg), Model.from_config(tcfg)
    jo, to = jopt.AdamW(1e-3), topt.AdamW(1e-3)
    jstate = jts.TrainState(step=jnp.int32(0), params=jparams,
                            opt_state=jo.init(jparams))
    tstate = interop.lm_train_state_from_jax(
        jax.tree.map(np.asarray, jstate), "cpu")
    jstep = jax.jit(jts.make_train_step(jm, jo, microbatches=microbatches))
    tstep = tts.make_train_step(tm, to, microbatches=microbatches)
    for _ in range(2):
        jstate, jmet = jstep(jstate, jbatch)
        tstate, tmet = tstep(tstate, tbatch)
        assert set(tmet) == set(jmet) == {"loss", "nll", "grad_norm", "lr"}
        for k in jmet:
            _close(tmet[k], jmet[k], msg=k)
    assert int(tstate.step) == int(jstate.step) == 2
    got = interop.lm_train_state_to_numpy(tstate)
    for a, b in zip(jax.tree.leaves(got.params),
                    _jleaves(jstate.params)):
        # two Adam steps of lr 1e-3 move each weight ~2e-3, so rounding
        # noise in a near-zero gradient can flip one step's sign
        _close(a, b, rtol=0, atol=4e-3)
    for a, b in zip(jax.tree.leaves(got.opt_state.m),
                    _jleaves(jstate.opt_state.m)):
        _close(a, b, GRAD_RTOL, GRAD_ATOL)


def test_train_state_round_trips_through_interop():
    jcfg, _, jparams, _, _, _ = _lm_setup(dtype="float32")
    jo = jopt.AdamW(1e-3, mixed_precision=True)
    jstate = jts.TrainState(step=jnp.int32(7), params=jparams,
                            opt_state=jo.init(jparams))
    np_state = jax.tree.map(np.asarray, jstate)
    back = interop.lm_train_state_to_numpy(
        interop.lm_train_state_from_jax(np_state, "cpu"))
    assert type(back).__name__ == "TrainState"
    assert type(back.opt_state).__name__ == "AdamWState"
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(np_state)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the other dense configs (A17.1)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["granite-34b", "phi3-medium-14b"])
def test_dense_config_trains_and_generates_like_reference(arch):
    from repro.configs import get_config as jget
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(
        jget(arch))
    jcfg, tcfg, jparams, tparams, jbatch, tbatch = _lm_setup(
        arch, dtype="float32", b=2, s=20)
    assert not tcfg.tie_embeddings and "lm_head" in tparams
    # one train step
    jm, tm = JModel.from_config(jcfg), Model.from_config(tcfg)
    jo, to = jopt.AdamW(1e-3), topt.AdamW(1e-3)
    jstate = jts.TrainState(step=jnp.int32(0), params=jparams,
                            opt_state=jo.init(jparams))
    tstate = interop.lm_train_state_from_jax(
        jax.tree.map(np.asarray, jstate), "cpu")
    jstate, jmet = jax.jit(jts.make_train_step(jm, jo))(jstate, jbatch)
    tstate, tmet = tts.make_train_step(tm, to)(tstate, tbatch)
    for k in ("loss", "grad_norm"):
        _close(tmet[k], jmet[k], msg=k)
    # a greedy generate from the trained params
    prompts = jbatch["tokens"][:, :9]
    want = JEngine(jm, jstate.params).generate(
        {"tokens": jnp.asarray(prompts)}, 5)
    got = Engine(tm, tstate.params).generate(
        {"tokens": torch.from_numpy(np.ascontiguousarray(prompts))}, 5)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
