"""whisper-tiny (reduced: 2 + 2 layers, 16 frames) against the JAX
reference.

Both packages start from the reference's params (``jax.random``,
carried over with ``interop.lm_params_from_jax``) and take the same
numpy-seeded tokens and frames.  The reference runs jitted; its
attention is the jnp ``chunked_attention`` and ``decode_attention`` (no
Pallas kernel), the port's the flash and decode kernels' plain versions
on the CPU: the encoder's non-causal self-attention, the decoder's
causal one, the cross-attention of the text rows over the frames (Sq !=
Skv), and at decode the cross-attention at ``cur_len = enc_seq``.

Tolerances, on logits whose spread is about 8: forward, prefill and
decode logits within 3e-4 / 5e-4 (``tests/test_torch_lm.py``'s);
decode against the teacher-forced forward within 5e-4
(``tests/test_serving.py::test_whisper_decode_matches_forward``'s); the
encoder's states and the cross k and v within 3e-4; the loss, its
gradients and one train step as ``tests/test_torch_lm_window.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jreduced
from repro.models import common as jcommon
from repro.models import encdec as jed
from repro.models.model_api import Model as JModel
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch import interop
from repro_torch.configs import get_reduced_config
from repro_torch.models import common as tcommon
from repro_torch.models import encdec as ted
from repro_torch.models.model_api import Model
from repro_torch.models.qhead import tree_leaves
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts
from test_torch_lm_window import (ATOL, GRAD_ATOL, GRAD_RTOL, RTOL,
                                  check_param_tree, close)

ARCH = "whisper-tiny"
B, S, MAXLEN = 2, 10, 16
F32_TOL = (3e-4, 5e-4)


@pytest.fixture(autouse=True)
def partitionable():
    with jax.threefry_partitionable(True):
        yield


def _setup(seed=1):
    jcfg = jreduced(ARCH, dtype="float32", remat=False)
    tcfg = get_reduced_config(ARCH, dtype="float32", remat=False)
    jm, tm = JModel.from_config(jcfg), Model.from_config(tcfg)
    jparams = jm.init_params(jax.random.key(seed))
    tparams = interop.lm_params_from_jax(jax.tree.map(np.asarray, jparams),
                                         "cpu")
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    frames = rng.standard_normal((B, jcfg.enc_seq, jcfg.d_model)).astype(
        np.float32)
    return jm, jparams, tm, tparams, toks, frames


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


@pytest.mark.parametrize("d", [8, 64, 384])
def test_sinusoidal_embedding_matches_reference(d):
    pos = np.arange(1500, dtype=np.int32)
    want = jax.jit(jcommon.sinusoidal_embedding, static_argnums=1)(pos, d)
    got = tcommon.sinusoidal_embedding(torch.from_numpy(pos), d)
    # float32 arguments up to 1,500 rad, whose ulp is 1.2e-4: the
    # packages' sin and cos reduce them differently, by up to one ulp
    close(got, want, 2.5e-4)


def test_encoder_and_cross_kv_match_reference():
    jm, jparams, tm, tparams, _, frames = _setup()
    enc = jax.jit(lambda p, f: jed.encode(jm.cfg, p, f))(jparams, frames)
    tenc = ted.encode(tm.cfg, tparams, _t(frames))
    close(tenc, enc, F32_TOL[0])
    lp = jax.tree.map(lambda t: t[1], jparams["dec_blocks"]["cross"])
    tlp = {n: w[1] for n, w in tparams["dec_blocks"]["cross"].items()}
    jk, jv = jed._cross_kv(jm.cfg, lp, enc)
    tk, tv = ted._cross_kv(tm.cfg, tlp, tenc)
    close(tk, jk, F32_TOL[0])
    close(tv, jv, F32_TOL[0])


def test_encdec_param_tree_equals_reference():
    check_param_tree(ARCH)


def test_forward_matches_reference():
    jm, jparams, tm, tparams, toks, frames = _setup()
    want = jax.jit(lambda p, t, f: jed.forward(jm.cfg, p, t, f))(
        jparams, toks, frames)
    got = ted.forward(tm.cfg, tparams, _t(toks), _t(frames))
    assert tuple(got.shape) == (B, S, jm.cfg.vocab_size)
    close(got, want, F32_TOL[0])


def test_prefill_and_decode_match_reference():
    """Prefill (encode, every layer's cross k and v, the first token),
    then decode steps from the port's own cache and from the reference's
    carried over, each against the reference's ``decode_step``."""
    jm, jparams, tm, tparams, toks, frames = _setup(2)
    batch = {"tokens": toks, "frames": frames}
    jl, jcache = jax.jit(jm.prefill, static_argnums=2)(jparams, batch,
                                                       MAXLEN)
    tl, cache = tm.prefill(tparams, {k: _t(v) for k, v in batch.items()},
                           MAXLEN)
    assert tuple(tl.shape) == (B, 1, jm.cfg.vocab_size)
    close(tl, jl, F32_TOL[0], msg="prefill logits")
    assert set(cache) == set(jcache)
    for n in ("self_k", "self_v", "cross_k", "cross_v"):
        close(cache[n], jcache[n], F32_TOL[0], msg=n)
    carried = interop.lm_cache_from_jax(jax.tree.map(np.asarray, jcache),
                                        "cpu")
    jdec = jax.jit(jm.decode_step)
    for t in range(1, 5):
        nxt = toks[:, t:t + 1]
        jl, jcache = jdec(jparams, nxt, jcache)
        lg, cache = tm.decode_step(tparams, _t(nxt), cache)
        close(lg, jl, F32_TOL[1], msg=f"decode {t}, own cache")
        lg, carried = tm.decode_step(tparams, _t(nxt), carried)
        close(lg, jl, F32_TOL[1], msg=f"decode {t}, carried cache")
        assert int(cache["len"]) == int(carried["len"]) == t + 1


def test_whisper_decode_matches_forward():
    """The reference's ``test_whisper_decode_matches_forward`` held across
    the packages: the port's decode logits, token by token, against the
    reference's teacher-forced forward (and the port's own)."""
    jm, jparams, tm, tparams, toks, frames = _setup(3)
    full = jax.jit(lambda p, t, f: jed.forward(jm.cfg, p, t, f))(
        jparams, toks, frames)
    logits0, cache = tm.prefill(tparams, {"tokens": _t(toks),
                                          "frames": _t(frames)}, MAXLEN)
    outs = [logits0[:, 0]]
    for t in range(1, S):
        lg, cache = tm.decode_step(tparams, _t(toks[:, t:t + 1]), cache)
        outs.append(lg[:, 0])
    got = torch.stack(outs, 1)
    close(got, full, 5e-4)
    close(got, ted.forward(tm.cfg, tparams, _t(toks), _t(frames)), 5e-4)


def _batch(jcfg, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jcfg.vocab_size, (B, S + 1)).astype(np.int32)
    mask = np.ones((B, S), np.float32)
    mask[0, -3:] = 0.0
    jbatch = {"tokens": toks[:, :-1], "targets": toks[:, 1:],
              "loss_mask": mask,
              "frames": rng.standard_normal(
                  (B, jcfg.enc_seq, jcfg.d_model)).astype(np.float32)}
    return jbatch, {k: _t(v) for k, v in jbatch.items()}


def test_loss_and_train_step_match_reference():
    """``encdec_loss`` and its gradients (through the differentiable
    chunked route), then one AdamW step through ``make_train_step`` with
    a batch that holds ``frames``, against the reference."""
    jm, jparams, tm, tparams, _, _ = _setup(4)
    jbatch, tbatch = _batch(jm.cfg, 4)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jed.encdec_loss(jm.cfg, p, jbatch), has_aux=True))(jparams)
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(tparams)]
    loss, met = tm.loss(tts._unflatten_like(tparams, leaves), tbatch)
    close(loss, jloss, ATOL, RTOL, msg="loss")
    assert set(met) == set(jmet) == {"nll"}
    for a, b in zip(torch.autograd.grad(loss, leaves),
                    jax.tree.leaves(jgrads)):
        close(a, b, GRAD_ATOL, GRAD_RTOL)

    jo, to = jopt.AdamW(1e-3), topt.AdamW(1e-3)
    jstate = jts.TrainState(step=jnp.int32(0), params=jparams,
                            opt_state=jo.init(jparams))
    tstate = interop.lm_train_state_from_jax(
        jax.tree.map(np.asarray, jstate), "cpu")
    jstate, jm2 = jax.jit(jts.make_train_step(jm, jo))(jstate, jbatch)
    tstate, tm2 = tts.make_train_step(tm, to)(tstate, tbatch)
    assert set(tm2) == set(jm2)
    for k in jm2:
        close(tm2[k], jm2[k], ATOL, RTOL, msg=k)
    got = interop.lm_train_state_to_numpy(tstate)
    for a, b in zip(jax.tree.leaves(got.params),
                    jax.tree.leaves(jstate.params)):
        close(a, b, 2e-3)


def test_greedy_generate_equals_reference():
    from repro.serving import Engine as JEngine
    from repro_torch.serving import Engine
    jm, jparams, tm, tparams, toks, frames = _setup(5)
    want = JEngine(jm, jparams).generate(
        {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)}, 6)
    got = Engine(tm, tparams).generate({"tokens": _t(toks),
                                        "frames": _t(frames)}, 6)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    close(got.logits_last, want.logits_last, F32_TOL[1])


def test_the_launcher_refuses_whisper():
    from repro_torch.launch import train as launch_train
    with pytest.raises(ValueError, match="encoder-decoder"):
        launch_train.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                           "--steps", "1"])
