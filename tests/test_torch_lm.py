"""The port's LM serving path (reduced stablelm-1.6b) against the JAX
reference.

Both packages start from the reference's params (drawn by
``jax.random``, carried over with ``interop.lm_params_from_jax``) and get
the same prompts.  The reference's prefill and decode run jitted, as its
``Engine`` runs them.  Tolerances, on logits whose spread is about 8
(sqrt of d_model 64):

* float32: prefill logits and cache within 3e-4 (the reference's own
  prefill-vs-forward tolerance, ``tests/test_serving.py``), decode
  logits within 5e-4 (its decode tolerance); the two packages differ in
  the order of their sums (the flash kernel's plain version against the
  reference's blockwise chunked attention, matmul kernels).
* bfloat16: within 2% of the largest |logit| (40-55 here): the logits
  are themselves bf16 (the unembed runs in the activation dtype), so one
  rounding step at the largest logit is up to 2^-7 of it (0.8%), and the
  packages round at different places (XLA fuses elementwise chains that
  PyTorch rounds op by op); seeds 1-5 differ by at most 0.28, 1.1 such
  steps.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jreduced
from repro.models import common as jcommon
from repro.models.model_api import Model as JModel
from repro.serving import Engine as JEngine
from repro_torch import interop, prng
from repro_torch.configs import ARCH_IDS, get_config, get_reduced_config
from repro_torch.launch import serve
from repro_torch.models import common, transformer
from repro_torch.models.model_api import Model
from repro_torch.serving import Engine

ARCH = "stablelm-1.6b"
B, S, MAXLEN, STEPS = 2, 40, 48, 4
TOL = {"float32": (3e-4, 5e-4), "bfloat16": None}  # bf16: 2% of max|logit|


@pytest.fixture(autouse=True)
def partitionable():
    with jax.threefry_partitionable(True):
        yield


def _cfgs(dtype):
    return (jreduced(ARCH, dtype=dtype, remat=False),
            get_reduced_config(ARCH, dtype=dtype, remat=False))


def _setup(dtype, seed=1):
    jcfg, tcfg = _cfgs(dtype)
    jm, tm = JModel.from_config(jcfg), Model.from_config(tcfg)
    jparams = jm.init_params(jax.random.key(seed))
    tparams = interop.lm_params_from_jax(
        jax.tree.map(np.asarray, jparams), "cpu")
    toks = np.random.default_rng(seed).integers(
        0, jcfg.vocab_size, (B, S)).astype(np.int32)
    return jm, jparams, tm, tparams, toks


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=0, err_msg=msg)


def test_reduced_config_equals_reference():
    jcfg = jreduced(ARCH)
    tcfg = get_reduced_config(ARCH)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert (tcfg.n_layers, tcfg.d_model, tcfg.n_heads, tcfg.n_kv_heads,
            tcfg.head_dim, tcfg.q_block, tcfg.kv_block) == (2, 64, 4, 2, 16,
                                                            32, 32)
    from repro.configs import get_config as jget
    assert dataclasses.asdict(get_config(ARCH)) == dataclasses.asdict(
        jget(ARCH))


ZOO = ("h2o-danube-3-4b", "deepseek-moe-16b", "deepseek-v2-lite-16b",
       "rwkv6-7b", "hymba-1.5b", "whisper-tiny", "paligemma-3b")
PORTED = (ARCH, "granite-34b", "phi3-medium-14b") + ZOO


def test_every_arch_is_ported():
    assert sorted(ARCH_IDS) == sorted(PORTED)


@pytest.mark.parametrize("arch", ZOO)
def test_zoo_config_equals_reference(arch):
    """The sliding-window, MoE, MLA, rwkv, hybrid, encoder-decoder and
    VLM configs, full and reduced, field for field the reference's."""
    from repro.configs import get_config as jget
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(
        jget(arch))
    assert dataclasses.asdict(get_reduced_config(arch)) == \
        dataclasses.asdict(jreduced(arch))


def _flat(tree, path=""):
    """{path: (shape, dtype name)} of a nested dict of arrays or tensors."""
    if isinstance(tree, dict):
        return {k: v for name in tree
                for k, v in _flat(tree[name], f"{path}/{name}").items()}
    return {path: (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))}


def test_param_tree_and_init_laws():
    """The port's specs give the reference's tree, shapes and dtypes, and
    its draws follow the reference's laws: embed std 1, fan-in-scaled
    normals (the last-but-one dim), layernorm scale 1 and bias 0."""
    jcfg, tcfg = _cfgs("float32")
    want = _flat(JModel.from_config(jcfg).init_params(jax.random.key(0)))
    got = _flat(Model.from_config(tcfg).init_params(
        torch.Generator().manual_seed(0), device="cpu"))
    assert got == want
    tm = Model.from_config(tcfg.reduced(d_model=256, d_ff=512,
                                        vocab_size=4096, head_dim=64))
    p = tm.init_params(torch.Generator().manual_seed(0), device="cpu")
    blocks = p["blocks"]
    assert abs(float(p["embed"].std()) - 1.0) < 0.01
    for w, fan_in in ((blocks["mix"]["wq"], 256), (blocks["mlp"]["w_down"],
                                                   512)):
        assert abs(float(w.std()) * fan_in ** 0.5 - 1.0) < 0.02
    assert bool((blocks["norm1"]["scale"] == 1).all())
    assert bool((blocks["norm1"]["bias"] == 0).all())
    assert bool((p["final_norm"]["scale"] == 1).all())
    bf = Model.from_config(tcfg.reduced(param_dtype="bfloat16"))
    assert bf.init_params(torch.Generator().manual_seed(0),
                          device="cpu")[
        "embed"].dtype == torch.bfloat16
    rms = common.norm_spec("rmsnorm", 8)
    assert rms["scale"].init == "zeros" and "bias" not in rms


def test_init_params_refuses_a_generator_on_another_device():
    """The params land on ``device``, never silently on the generator's."""
    _, tcfg = _cfgs("float32")
    with pytest.raises(ValueError, match="generator is on cpu"):
        Model.from_config(tcfg).init_params(torch.Generator(),
                                            device="meta")


def test_norms_and_rope_match_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    w, b = rng.standard_normal((2, 16)).astype(np.float32)
    tx, tw, tb = (torch.from_numpy(a) for a in (x, w, b))
    _close(common.layer_norm(tx, tw, tb), jcommon.layer_norm(x, w, b), 1e-6)
    _close(common.rms_norm(tx, tw), jcommon.rms_norm(x, w), 1e-6)
    pos = np.arange(5)[None].repeat(2, 0)
    _close(common.apply_rope(tx, torch.from_numpy(pos), 10_000.0),
           jcommon.apply_rope(x, pos, 10_000.0), 1e-5)
    _close(common.softcap(tx, 2.0), jcommon.softcap(x, 2.0), 1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(dtype):
    """Prefill of a 40-token prompt (not a multiple of the reference's
    32-row attention blocks, so its padding and block skipping differ
    from the port's), then 4 decode steps, from the reference's cache
    and from the port's own."""
    jm, jparams, tm, tparams, toks = _setup(dtype)
    jlogits, jcache = jax.jit(jm.prefill, static_argnums=2)(
        jparams, {"tokens": toks}, MAXLEN)
    tol_p, tol_d = TOL[dtype] or (0.02 * float(jnp.abs(jlogits).max()),) * 2
    logits, cache = tm.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                               MAXLEN)
    _close(logits, jlogits, tol_p, "prefill logits")
    _close_cache(cache, jcache, dtype)
    assert cache["len"].dtype == torch.int32 and int(cache["len"]) == S
    assert not bool(cache["blocks"]["k"][:, :, :, S:].any())

    own = cache
    carried = interop.lm_cache_from_jax(jax.tree.map(np.asarray, jcache),
                                        "cpu")
    jdec = jax.jit(jm.decode_step)
    nxt = np.asarray(jnp.argmax(jlogits, -1), np.int32)[:, None]
    for t in range(STEPS):
        jl, jcache = jdec(jparams, nxt, jcache)
        tok = torch.from_numpy(nxt.copy())
        for name, c in (("own", own), ("carried", carried)):
            lg, c2 = tm.decode_step(tparams, tok, c)
            _close(lg, jl, tol_d, f"decode step {t} from the {name} cache")
            assert int(c2["len"]) == S + t + 1
            if name == "own":
                own = c2
            else:
                carried = c2
        nxt = np.asarray(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
    _close_cache(own, jcache, dtype)


def _close_cache(cache, jcache, dtype):
    """The KV cache within the logits' tolerance (bf16: 2% of max|k|,
    max|v|, for the same reason)."""
    for name in ("k", "v"):
        want = jcache["blocks"][name]
        tol = TOL[dtype][0] if TOL[dtype] else 0.02 * float(
            jnp.abs(want).max())
        _close(cache["blocks"][name], want, tol, name)


def test_forward_matches_reference():
    from repro.models import transformer as jtr
    jm, jparams, tm, tparams, toks = _setup("float32", seed=2)
    want, _ = jax.jit(lambda p, t: jtr.forward(jm.cfg, p, t))(jparams, toks)
    got = transformer.forward(tm.cfg, tparams, torch.from_numpy(toks))
    _close(got, want, TOL["float32"][0])


def test_greedy_generate_equals_reference():
    jm, jparams, tm, tparams, toks = _setup("float32", seed=4)
    want = JEngine(jm, jparams).generate({"tokens": jnp.asarray(toks)}, 6)
    got = Engine(tm, tparams).generate({"tokens": torch.from_numpy(toks)}, 6)
    assert got.tokens.dtype == torch.int32
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    _close(got.logits_last, want.logits_last, TOL["float32"][1])
    assert int(got.cache["len"]) == S + 5


def test_stop_token_holds_finished_rows():
    jm, jparams, tm, tparams, toks = _setup("float32", seed=4)
    first = Engine(tm, tparams).generate(
        {"tokens": torch.from_numpy(toks)}, 3).tokens
    stop = int(first[0, 0])
    want = JEngine(jm, jparams).generate({"tokens": jnp.asarray(toks)}, 6,
                                         stop_token=stop)
    got = Engine(tm, tparams).generate({"tokens": torch.from_numpy(toks)}, 6,
                                       stop_token=stop)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    assert bool((got.tokens[0] == stop).all())


def test_temperature_choice_equals_categorical():
    """Gumbel-max on the port's PRNG against ``jax.random.categorical`` on
    ``fold_in(key, step)``, on seeded logits."""
    logits = np.random.default_rng(9).standard_normal((4, 300)).astype(
        np.float32) * 3
    for seed in range(3):
        key = prng.key(seed)
        for step in range(4):
            for temp in (0.7, 1.0, 2.5):
                want = jax.random.categorical(
                    jax.random.fold_in(jax.random.key(seed), step),
                    jnp.asarray(logits) / temp, axis=-1)
                got = Engine._choose(torch.from_numpy(logits), temp, key,
                                     step)
                np.testing.assert_array_equal(got[:, 0].numpy(),
                                              np.asarray(want))
    greedy = Engine._choose(torch.from_numpy(logits), 0.0, None, 0)
    np.testing.assert_array_equal(greedy[:, 0].numpy(),
                                  np.argmax(logits, -1))


def test_sampled_generate_equals_reference():
    jm, jparams, tm, tparams, toks = _setup("float32", seed=5)
    want = JEngine(jm, jparams).generate({"tokens": jnp.asarray(toks)}, 5,
                                         temperature=1.0,
                                         key=jax.random.key(11))
    got = Engine(tm, tparams).generate({"tokens": torch.from_numpy(toks)}, 5,
                                       temperature=1.0, key=prng.key(11))
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))


def test_serve_cli_runs_on_cpu(capsys):
    assert serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "8", "--gen", "4"]) == 0
    out = capsys.readouterr().out
    assert "prefill: batch=2 prompt=8" in out and "ms/token" in out


def test_serve_prompts_equal_reference_cli():
    """The CLI's prompts are the reference CLI's, bit for bit."""
    cfg = get_reduced_config(ARCH)
    k_tok = prng.split(prng.key(1), 3)[0]
    got = prng.randint(k_tok, (2, 8), 0, cfg.vocab_size)
    jk = jax.random.split(jax.random.key(1), 3)[0]
    want = jax.random.randint(jk, (2, 8), 0, cfg.vocab_size, dtype=jnp.int32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_unported_families_raise():
    """Every family and block of the reference's zoo is ported; a family
    or a block kind the zoo does not have still raises."""
    from repro_torch.configs.base import ArchConfig
    odd = ArchConfig(name="m", family="diffusion", n_layers=1, d_model=8,
                     n_heads=2, n_kv_heads=2, d_ff=8, vocab_size=8)
    with pytest.raises(ValueError, match="family"):
        Model.from_config(odd)
    with pytest.raises(ValueError, match="block"):
        transformer.lm_param_specs(dataclasses.replace(
            get_reduced_config(ARCH), block_kind="conv"))
    for arch in ARCH_IDS:
        Model.from_config(get_config(arch))
