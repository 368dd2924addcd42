"""The sliding window at decode (h2o-danube-3-4b, reduced) against the JAX
reference, and the arch-level checks the zoo's three configs share.

Both packages start from the reference's params (``jax.random``, carried
over with ``interop.lm_params_from_jax``, leaf for leaf) and take the
same numpy-seeded tokens; the reference runs jitted.  Its model path
calls no Pallas kernel (its attention is the jnp ``chunked_attention``
and ``decode_attention``), so nothing runs in interpret mode.  The
reduced h2o has a 32-key window, so a 40-token prompt and 4 decode steps
run past it at prefill and at every decode step.

Tolerances, on logits whose spread is about 8:

* float32: forward and prefill logits within 3e-4, decode logits
  within 5e-4, caches within 3e-4 (``tests/test_torch_lm.py``'s, the
  reference's own prefill and decode tolerances); the MoE metrics within
  rtol 1e-5 / atol 1e-6; loss, gradients and one train step as
  ``tests/test_torch_lm_train.py`` (loss rtol 1e-5, gradients rtol 1e-4
  / atol 1e-5, Adam's first moment likewise, params atol 2e-3 after one
  step of lr 1e-3: a near-zero gradient may take the other sign).
* bfloat16 (h2o only: an MoE's routing may flip on a bf16 rounding, see
  ``test_torch_lm_moe.py``): within 2% of the largest |logit|, as
  ``tests/test_torch_lm.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jreduced
from repro.models import attention as jattn
from repro.models import transformer as jtr
from repro.models.model_api import Model as JModel
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch import interop
from repro_torch.configs import get_reduced_config
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttr
from repro_torch.models.model_api import Model
from repro_torch.models.qhead import tree_leaves
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts

ARCH = "h2o-danube-3-4b"
B, S, MAXLEN, STEPS = 2, 40, 48, 4
F32_TOL = (3e-4, 5e-4)           # prefill / forward, decode
METRIC_RTOL = 1e-5
RTOL, ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def partitionable():
    with jax.threefry_partitionable(True):
        yield


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def close(got, want, atol, rtol=0.0, msg=""):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=rtol,
                               err_msg=msg)


def arch_setup(arch, dtype="float32", seed=1, **over):
    """Both models from one reduced config, the reference's params in
    both, and (B, S) numpy tokens."""
    jcfg = jreduced(arch, dtype=dtype, remat=False, **over)
    tcfg = get_reduced_config(arch, dtype=dtype, remat=False, **over)
    jm, tm = JModel.from_config(jcfg), Model.from_config(tcfg)
    jparams = jm.init_params(jax.random.key(seed))
    tparams = interop.lm_params_from_jax(
        jax.tree.map(np.asarray, jparams), "cpu")
    toks = np.random.default_rng(seed).integers(
        0, jcfg.vocab_size, (B, S)).astype(np.int32)
    return jm, jparams, tm, tparams, toks


def _flat_shapes(tree, path=""):
    if isinstance(tree, dict):
        return {k: v for name in tree
                for k, v in _flat_shapes(tree[name], f"{path}/{name}").items()}
    return {path: (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))}


def check_param_tree(arch):
    """The port's specs give the reference's tree (``dense_blocks``
    included), shapes and dtypes, and ``lm_params_from_jax`` carries the
    reference's params over leaf for leaf, unchanged."""
    jm, jparams, tm, tparams, _ = arch_setup(arch)
    want = _flat_shapes(jax.tree.map(np.asarray, jparams))
    assert _flat_shapes(tm.init_params(torch.Generator().manual_seed(0),
                                       device="cpu")) == want
    assert _flat_shapes(tparams) == want
    for a, b in zip(tree_leaves(tparams), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def check_forward(arch, **over):
    """Full-sequence logits and the blocks' metrics (an MoE's mean over
    its layers) against the reference's ``forward``."""
    jm, jparams, tm, tparams, toks = arch_setup(arch, **over)
    want, jmet = jax.jit(lambda p, t: jtr.forward(jm.cfg, p, t))(jparams,
                                                                 toks)
    x, met = ttr.forward_hidden(tm.cfg, tparams, torch.from_numpy(toks))
    close(ttr.unembed(tm.cfg, tparams, x), want, F32_TOL[0], msg="logits")
    close(ttr.forward(tm.cfg, tparams, torch.from_numpy(toks)), want,
          F32_TOL[0], msg="forward")
    assert set(met) == set(jmet)
    for k in jmet:
        close(met[k], jmet[k], ATOL, METRIC_RTOL, msg=k)


def _close_cache(cache, jcache, tol_of):
    names = [n for n in ("dense_blocks", "blocks") if n in jcache]
    assert [n for n in ("dense_blocks", "blocks") if n in cache] == names
    for name in names:
        assert set(cache[name]) == set(jcache[name])
        for leaf, want in jcache[name].items():
            close(cache[name][leaf], want, tol_of(want), msg=f"{name}/{leaf}")


def check_prefill_decode(arch, dtype="float32", **over):
    """Prefill of a 40-token prompt, then 4 decode steps from the port's
    own cache and from the reference's carried over, each step's logits
    against the reference's ``decode_step`` (an MoE's decode need not
    equal its prefill: capacity depends on the token count)."""
    jm, jparams, tm, tparams, toks = arch_setup(arch, dtype, **over)
    jlogits, jcache = jax.jit(jm.prefill, static_argnums=2)(
        jparams, {"tokens": toks}, MAXLEN)
    if dtype == "float32":
        tol_p, tol_d = F32_TOL

        def tol_of(want):
            return F32_TOL[0]
    else:
        tol_p = tol_d = 0.02 * float(jnp.abs(jlogits).max())

        def tol_of(want):
            return 0.02 * float(np.abs(np.asarray(want, np.float32)).max())
    logits, cache = tm.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                               MAXLEN)
    close(logits, jlogits, tol_p, msg="prefill logits")
    _close_cache(cache, jcache, tol_of)
    assert cache["len"].dtype == torch.int32 and int(cache["len"]) == S

    own = cache
    carried = interop.lm_cache_from_jax(jax.tree.map(np.asarray, jcache),
                                        "cpu")
    jdec = jax.jit(jm.decode_step)
    nxt = np.asarray(jnp.argmax(jlogits, -1), np.int32)[:, None]
    for t in range(STEPS):
        jl, jcache = jdec(jparams, nxt, jcache)
        tok = torch.from_numpy(nxt.copy())
        lg, own = tm.decode_step(tparams, tok, own)
        close(lg, jl, tol_d, msg=f"decode step {t} from the own cache")
        lg, carried = tm.decode_step(tparams, tok, carried)
        close(lg, jl, tol_d, msg=f"decode step {t} from the carried cache")
        assert int(own["len"]) == int(carried["len"]) == S + t + 1
        nxt = np.asarray(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
    _close_cache(own, jcache, tol_of)


def _batch(jcfg, seed, b=2, s=40):
    toks = np.random.default_rng(seed + 10).integers(
        0, jcfg.vocab_size, (b, s + 1)).astype(np.int32)
    mask = np.ones((b, s), np.float32)
    mask[0, -7:] = 0.0  # a masked tail
    jbatch = {"tokens": toks[:, :-1], "targets": toks[:, 1:],
              "loss_mask": mask}
    return jbatch, {k: torch.from_numpy(np.ascontiguousarray(v))
                    for k, v in jbatch.items()}


def check_loss_and_train_step(arch, **over):
    """``lm_loss`` (an MoE's aux terms in the loss and ``nll`` holding the
    sum) with its metrics and gradients, then one AdamW train step,
    against the reference."""
    jm, jparams, tm, tparams, _ = arch_setup(arch, seed=3, **over)
    jbatch, tbatch = _batch(jm.cfg, 3)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jtr.lm_loss(jm.cfg, p, jbatch), has_aux=True))(jparams)
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(tparams)]
    from repro_torch.train.train_step import _unflatten_like
    loss, met = ttr.lm_loss(tm.cfg, _unflatten_like(tparams, leaves), tbatch)
    close(loss, jloss, ATOL, RTOL, msg="loss")
    assert set(met) == set(jmet) and met["nll"] is loss
    for k in jmet:
        close(met[k], jmet[k], ATOL, RTOL, msg=k)
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
    for a, b in zip(jax.tree.leaves(got.opt_state.m),
                    jax.tree.leaves(jstate.opt_state.m)):
        close(a, b, GRAD_ATOL, GRAD_RTOL)


# ---------------------------------------------------------------------------
# The window at decode, alone
# ---------------------------------------------------------------------------

def _gqa_params(jcfg, seed):
    specs = jattn.gqa_specs(jcfg, None)
    rng = np.random.default_rng(seed)
    return {n: (rng.standard_normal(sp.shape) / np.sqrt(sp.shape[0])
                ).astype(np.float32) for n, sp in specs.items()}


@pytest.mark.parametrize("pos,window", [(47, 32), (40, 8), (5, 32),
                                        (31, 32), (32, 32)])
def test_gqa_decode_with_a_window_matches_reference(pos, window):
    """One decode step at ``pos`` of a 48-row cache of h2o's GQA (2 q
    heads a kv head) under the window: past it (cur_len = pos + 1 >
    window), at its edge and inside it."""
    jcfg = jreduced(ARCH, dtype="float32")
    tcfg = get_reduced_config(ARCH, dtype="float32")
    p = _gqa_params(jcfg, 7)
    rng = np.random.default_rng(8)
    x, kc, vc = (rng.standard_normal(sh).astype(np.float32) for sh in (
        (2, 1, jcfg.d_model), (2, 2, 48, 16), (2, 2, 48, 16)))
    want, jc = jax.jit(lambda p, x, c: jattn.gqa_decode(
        jcfg, p, x, c, jattn.make_mask_fn(True, window, None)))(
        p, x, {"k": kc, "v": vc, "len": jnp.int32(pos)})
    got, tc = tattn.gqa_decode(
        tcfg, {n: torch.from_numpy(w) for n, w in p.items()},
        torch.from_numpy(x), {"k": torch.from_numpy(kc.copy()),
                              "v": torch.from_numpy(vc.copy()),
                              "len": torch.tensor(pos, dtype=torch.int32)},
        window=window)
    close(got, want, 2e-5, 2e-5)
    close(tc["k"], jc["k"], 2e-5)
    assert int(tc["len"]) == pos + 1


# ---------------------------------------------------------------------------
# h2o-danube-3-4b, reduced
# ---------------------------------------------------------------------------

def test_h2o_reduced_runs_past_its_window():
    cfg = get_reduced_config(ARCH)
    assert cfg.sliding_window == 32 < S and cfg.n_heads // cfg.n_kv_heads == 2


def test_h2o_param_tree_equals_reference():
    check_param_tree(ARCH)


def test_h2o_forward_matches_reference():
    check_forward(ARCH)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_h2o_prefill_and_decode_match_reference(dtype):
    check_prefill_decode(ARCH, dtype)


def test_h2o_loss_and_train_step_match_reference():
    check_loss_and_train_step(ARCH)


def test_per_layer_windows_match_reference():
    """``layer_windows`` (hymba's global / windowed mix, here on h2o's
    attention block): layer 0 global (``GLOBAL_WINDOW``), layer 1 under
    the 32-key window, through forward, prefill and decode."""
    over = {"global_attn_layers": (0,)}
    assert ttr.layer_windows(get_reduced_config(ARCH, **over)) == [
        ttr.GLOBAL_WINDOW, 32]
    assert ttr.layer_windows(get_reduced_config(ARCH)) is None
    check_forward(ARCH, **over)
    check_prefill_decode(ARCH, **over)


def test_h2o_generate_equals_reference():
    from repro.serving import Engine as JEngine
    from repro_torch.serving import Engine
    jm, jparams, tm, tparams, toks = arch_setup(ARCH, seed=4)
    want = JEngine(jm, jparams).generate({"tokens": jnp.asarray(toks)}, 6)
    got = Engine(tm, tparams).generate({"tokens": torch.from_numpy(toks)}, 6)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    close(got.logits_last, want.logits_last, F32_TOL[1])


def test_zoo_launchers_run_on_cpu(capsys):
    """``launch.serve`` and ``launch.train`` take the three new arch ids
    reduced on the CPU."""
    from repro_torch.launch import serve
    from repro_torch.launch import train as launch_train
    for arch in (ARCH, "deepseek-moe-16b", "deepseek-v2-lite-16b"):
        assert serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                           "--batch", "2", "--prompt-len", "8",
                           "--gen", "3"]) == 0
        assert launch_train.main(["--arch", arch, "--reduced", "--device",
                                  "cpu", "--steps", "2", "--batch", "2",
                                  "--seq-len", "16", "--n-seqs", "16",
                                  "--log-every", "1"]) == 0
    out = capsys.readouterr().out
    assert out.count("ms/token") == 3 and out.count("done: 2 steps") == 3
