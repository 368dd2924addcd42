"""The flash kernel's prefix-LM mask and cross-attention lengths, and
paligemma-3b (reduced) with its patch prefix, against the JAX reference;
the serve CLI's inputs and the launchers for the four new archs.

The plain flash version (the CPU path of ``ops.flash_attention``) takes
a prefix ``P`` and keys of another length than the queries; it is held
against the reference's jnp ``chunked_attention`` under
``make_mask_fn(causal, window, P)`` (the reference's Pallas kernel has
neither, so its jnp path is the oracle), at the kernels' tolerances
(``tests/test_kernels.py``: float32 2e-5, atol and rtol).  The CUDA
kernels are held against that plain version on the card by
``chip_smoke.py``, in bf16 on ladders of scores that make a key wrongly
taken or lost at the prefix's bound, past the diagonal or past Skv
move a row by O(1); here each ladder is shown to expose such a key.
paligemma's forward, prefill with decode, loss and a train step take
the reference's params (carried over with ``interop``) and numpy-seeded
tokens and patch embeddings, at the tolerances of
``tests/test_torch_lm_window.py``.
"""
import dataclasses

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
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.kernels import ops
from repro_torch.kernels.ref import attention_ref
from repro_torch.launch import serve
from repro_torch.models import transformer as ttr
from repro_torch.models.model_api import Model
from repro_torch.models.qhead import tree_leaves
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts
from test_torch_lm_window import (ATOL, F32_TOL, GRAD_ATOL, GRAD_RTOL, RTOL,
                                  _close_cache, check_param_tree, close)

ARCH = "paligemma-3b"
B, S, MAXLEN, STEPS = 2, 24, 48, 4
TOL = 2e-5

# (b, hq, hkv, sq, skv, d, causal, window, prefix)
FLASH_CASES = [
    (2, 4, 1, 40, 40, 16, True, None, 8),       # reduced paligemma (MQA)
    (1, 8, 1, 300, 300, 64, True, None, 128),   # prefix on a tile edge
    (1, 4, 2, 200, 200, 32, True, None, 77),    # ragged prefix
    (1, 2, 2, 90, 90, 16, True, 16, 30),        # window and prefix
    (1, 2, 2, 64, 64, 16, False, None, 20),     # bidirectional + prefix
    (2, 6, 6, 10, 16, 16, False, None, None),   # reduced whisper's cross
    (1, 4, 2, 64, 1500, 64, False, None, None),  # whisper's cross
    (1, 2, 1, 100, 70, 32, False, 40, None),    # cross with a window
]


@pytest.fixture(autouse=True)
def partitionable():
    with jax.threefry_partitionable(True):
        yield


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _mask(sq, skv, causal, window, prefix):
    """The reference's mask, [Sq, Skv] bool."""
    fn = jattn.make_mask_fn(causal, window, prefix)
    return np.asarray(fn(jnp.arange(sq)[:, None], jnp.arange(skv)[None, :]))


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window,prefix",
                         FLASH_CASES)
def test_flash_plain_with_prefix_and_lengths_matches_reference(
        b, hq, hkv, sq, skv, d, causal, window, prefix):
    rng = np.random.default_rng(sq + skv + d)
    q = rng.standard_normal((b, hq, sq, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, hkv, skv, d)).astype(np.float32)
            for _ in range(2))
    want = jattn.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jattn.make_mask_fn(causal, window, prefix), bq=min(32, sq),
        bkv=min(32, skv))
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                              window=window, prefix_len=prefix)
    close(got, want, TOL, TOL)


def test_flash_refuses_causal_calls_of_two_lengths():
    q, k = torch.zeros(1, 2, 8, 16), torch.zeros(1, 2, 12, 16)
    with pytest.raises(ValueError, match="causal"):
        ops.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="prefix_len"):
        ops.flash_attention(q, q, q, prefix_len=-1)
    assert ops.flash_attention(q, k, k, causal=False).shape == (1, 2, 8, 16)


def _bf16_normal(gen, *shape):
    return torch.randn(*shape, generator=gen).to(torch.bfloat16)


def _off(got, want, tol=2e-2):
    """Per row, whether ``got`` leaves ``chip_smoke.check_close``'s bf16
    tolerance (atol = rtol = 2e-2) around ``want``."""
    got, want = got.float(), want.float()
    return ((got - want).abs() > tol + tol * want.abs()).any(-1)


def test_prefix_ladder_exposes_a_wrong_bound():
    """``chip_smoke.py`` holds the bf16 kernels with a prefix on a ladder
    (``lay_prefix_ladder``): the rows below P score key P - 1 high and
    key P higher.  A prefix one key short or long (standing in for a
    kernel that loses the prefix's last key or takes the next one) moves
    every row below P - 1 past the bf16 tolerance, while the float32
    answer on the same bf16 inputs stays within it."""
    import chip_smoke

    gen = torch.Generator().manual_seed(0)
    b, hq, hkv, s, d, P = 1, 8, 1, 512, 256, 256
    q, k, v = (_bf16_normal(gen, b, h, s, d) for h in (hq, hkv, hkv))
    chip_smoke.lay_prefix_ladder(q, k, P)
    want = attention_ref(q, k, v, causal=True, prefix_len=P)
    assert not _off(attention_ref(q.float(), k.float(), v.float(),
                                  causal=True, prefix_len=P), want).any()
    for wrong in (P - 1, P + 1):
        got = attention_ref(q, k, v, causal=True, prefix_len=wrong)
        assert _off(got, want)[:, :, :P - 1].all()
    # without the prefix (a kernel that ignores it) every row below P - 1
    # moves too
    assert _off(attention_ref(q, k, v, causal=True), want)[:, :, :P - 1].all()


@pytest.mark.parametrize("sq", [1500, 64])
def test_end_ladder_exposes_keys_past_skv(sq):
    """``chip_smoke.py`` holds the bf16 kernels on a bidirectional call
    without window or prefix (whisper's encoder, 1,500 x 1,500, and its
    cross-attention, 64 x 1,500) on an end ladder (``lay_end_ladder``):
    every key scores low, the last one higher.  The plain version over
    keys padded with zeros past Skv (a kernel that takes the zeros its
    TMA fills the last kv tile with: one of them, or all 36 up to the
    tile edge at 1,536) moves every row past the bf16 tolerance, while
    the float32 answer on the same bf16 inputs stays within it."""
    import chip_smoke

    gen = torch.Generator().manual_seed(1)
    b, h, skv, d = 1, 2, 1500, 64
    q = _bf16_normal(gen, b, h, sq, d)
    k, v = (_bf16_normal(gen, b, h, skv, d) for _ in range(2))
    chip_smoke.lay_end_ladder(q, k)
    want = attention_ref(q, k, v, causal=False)
    assert not _off(attention_ref(q.float(), k.float(), v.float(),
                                  causal=False), want).any()
    for pad in (1, 1536 - skv):
        zeros = torch.zeros(b, h, pad, d, dtype=torch.bfloat16)
        got = attention_ref(q, torch.cat([k, zeros], 2),
                            torch.cat([v, zeros], 2), causal=False)
        assert _off(got, want).all()


@pytest.mark.parametrize("s,d", [(1100, 64), (256, 192)])
def test_causal_ladder_exposes_a_key_past_the_diagonal(s, d):
    """``chip_smoke.py`` holds the bf16 kernels on a causal call without
    window or prefix (hymba's global layer, S 1,100; MLA's D 192) on a
    diagonal ladder (``lay_causal_ladder``): each row scores the keys
    higher the later they are.  A softmax that also takes key r + 1 into
    row r (a kernel whose causal bound is one key late) moves every row
    but the last past the bf16 tolerance, while the float32 answer on the
    same bf16 inputs stays within it."""
    import chip_smoke

    gen = torch.Generator().manual_seed(2)
    q, k, v = (_bf16_normal(gen, 1, 2, s, d) for _ in range(3))
    chip_smoke.lay_causal_ladder(q, k)
    want = attention_ref(q, k, v, causal=True)
    assert not _off(attention_ref(q.float(), k.float(), v.float(),
                                  causal=True), want).any()
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / d ** 0.5
    late = torch.ones(s, s, dtype=torch.bool).tril(1)
    got = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(
        scores.masked_fill(~late, -1e30), -1), v.float())
    assert _off(got, want)[:, :, :-1].all()


MASKS = [(512, 512, True, None, 256), (300, 300, True, None, 77),
         (300, 300, True, None, 1), (200, 200, True, 50, 90),
         (1100, 1100, True, 1024, None), (1100, 1100, True, None, None),
         (260, 260, True, None, 300), (1500, 1500, False, None, None),
         (64, 1500, False, None, None), (10, 16, False, None, None),
         (130, 130, False, 40, 20), (200, 90, False, 30, None)]


@pytest.mark.parametrize("sq,skv,causal,window,prefix", MASKS)
def test_attention_mask_is_the_reference_mask(sq, skv, causal, window,
                                              prefix):
    """``kernels/ref.py::attention_mask``, the one mask of the plain
    versions and of ``chip_smoke.py``'s bounds and SDPA calls, is the
    reference's ``make_mask_fn`` key for key: prefixes on and off a tile
    edge, past Sq, with a window, bidirectional, and Skv != Sq."""
    from repro_torch.kernels.ref import attention_mask
    np.testing.assert_array_equal(
        attention_mask(sq, skv, causal, window, prefix).numpy(),
        _mask(sq, skv, causal, window, prefix))


# ---------------------------------------------------------------------------
# paligemma-3b, reduced
# ---------------------------------------------------------------------------

def _setup(dtype="float32", seed=1):
    jcfg = jreduced(ARCH, dtype=dtype, remat=False)
    tcfg = get_reduced_config(ARCH, dtype=dtype, remat=False)
    jm, tm = JModel.from_config(jcfg), Model.from_config(tcfg)
    jparams = jm.init_params(jax.random.key(seed))
    tparams = interop.lm_params_from_jax(jax.tree.map(np.asarray, jparams),
                                         "cpu")
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    patches = rng.standard_normal(
        (B, jcfg.vis_prefix_len, jcfg.d_model)).astype(np.float32)
    return jm, jparams, tm, tparams, toks, patches


def test_paligemma_reduced_is_mqa_with_a_prefix():
    cfg = get_reduced_config(ARCH)
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.vis_prefix_len) == (4, 1, 8)
    assert cfg.scale_embed and cfg.mlp_kind == "geglu"


def test_paligemma_param_tree_equals_reference():
    check_param_tree(ARCH)


def test_paligemma_forward_matches_reference():
    """Logits over [prefix + text] under the prefix-LM mask."""
    jm, jparams, tm, tparams, toks, patches = _setup()
    want, _ = jax.jit(lambda p, t, e: jtr.forward(jm.cfg, p, t,
                                                  extra_embeds=e))(
        jparams, toks, patches)
    got = ttr.forward(tm.cfg, tparams, _t(toks), extra_embeds=_t(patches))
    assert tuple(got.shape) == (B, S + 8, jm.cfg.vocab_size)
    close(got, want, F32_TOL[0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paligemma_prefill_and_decode_match_reference(dtype):
    """Prefill of the patch prefix and a 24-token prompt, then decode
    steps (no prefix at decode, as in the reference) from the port's own
    cache and from the reference's carried over."""
    jm, jparams, tm, tparams, toks, patches = _setup(dtype, 2)
    batch = {"tokens": toks, "patch_embeds": patches}
    jl, jcache = jax.jit(jm.prefill, static_argnums=2)(jparams, batch,
                                                       MAXLEN)
    tl, cache = tm.prefill(tparams, {k: _t(v) for k, v in batch.items()},
                           MAXLEN)
    if dtype == "float32":
        tol_p, tol_d = F32_TOL

        def tol_of(want):
            return F32_TOL[0]
    else:
        tol_p = tol_d = 0.02 * float(jnp.abs(jl).max())

        def tol_of(want):
            return 0.02 * float(np.abs(np.asarray(want, np.float32)).max())
    close(tl, jl, tol_p, msg="prefill logits")
    _close_cache(cache, jcache, tol_of)
    assert int(cache["len"]) == S + 8
    carried = interop.lm_cache_from_jax(jax.tree.map(np.asarray, jcache),
                                        "cpu")
    jdec = jax.jit(jm.decode_step)
    nxt = np.asarray(jnp.argmax(jl, -1), np.int32)[:, None]
    for t in range(STEPS):
        jd, jcache = jdec(jparams, nxt, jcache)
        lg, cache = tm.decode_step(tparams, _t(nxt), cache)
        close(lg, jd, tol_d, msg=f"decode {t}, own cache")
        lg, carried = tm.decode_step(tparams, _t(nxt), carried)
        close(lg, jd, tol_d, msg=f"decode {t}, carried cache")
        nxt = np.asarray(jnp.argmax(jd[:, -1], -1), np.int32)[:, None]


def test_paligemma_loss_and_train_step_match_reference():
    """``lm_loss`` over the text positions only (the prefix in the
    forward, not in the loss), its gradients, then one AdamW step."""
    jm, jparams, tm, tparams, _, _ = _setup(seed=3)
    rng = np.random.default_rng(13)
    toks = rng.integers(0, jm.cfg.vocab_size, (B, S + 1)).astype(np.int32)
    mask = np.ones((B, S), np.float32)
    mask[1, -5:] = 0.0
    jbatch = {"tokens": toks[:, :-1], "targets": toks[:, 1:],
              "loss_mask": mask,
              "patch_embeds": rng.standard_normal(
                  (B, jm.cfg.vis_prefix_len, jm.cfg.d_model)).astype(
                      np.float32)}
    tbatch = {k: _t(v) for k, v in jbatch.items()}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jtr.lm_loss(jm.cfg, p, jbatch), has_aux=True))(jparams)
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(tparams)]
    loss, met = tm.loss(tts._unflatten_like(tparams, leaves), tbatch)
    close(loss, jloss, ATOL, RTOL, msg="loss")
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
    for k in jm2:
        close(tm2[k], jm2[k], ATOL, RTOL, msg=k)
    got = interop.lm_train_state_to_numpy(tstate)
    for a, b in zip(jax.tree.leaves(got.params),
                    jax.tree.leaves(jstate.params)):
        close(a, b, 2e-3)


def test_paligemma_generate_equals_reference():
    from repro.serving import Engine as JEngine
    from repro_torch.serving import Engine
    jm, jparams, tm, tparams, toks, patches = _setup(seed=4)
    want = JEngine(jm, jparams).generate(
        {"tokens": jnp.asarray(toks), "patch_embeds": jnp.asarray(patches)},
        5)
    got = Engine(tm, tparams).generate({"tokens": _t(toks),
                                        "patch_embeds": _t(patches)}, 5)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    close(got.logits_last, want.logits_last, F32_TOL[1])
    # the cache made room for the prefix: prompt + gen + 1 + 8
    assert got.cache["blocks"]["k"].shape[3] == S + 5 + 1 + 8


# ---------------------------------------------------------------------------
# The CLIs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["whisper-tiny", "paligemma-3b"])
def test_serve_inputs_equal_reference_cli(arch):
    """The serve CLI's prompts (bit for bit), frames and patch embeddings
    (``prng.normal``: torch's ``erfinv``, whose float32 rounding grows in
    the tails, within rtol 1e-5 / atol 1e-6) are the reference CLI's for
    one seed."""
    cfg = get_reduced_config(arch)
    got = serve.cli_inputs(cfg, 3, 2, 8)
    k_tok, k_aud, k_vis = jax.random.split(jax.random.key(4), 3)
    np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(
        jax.random.randint(k_tok, (2, 8), 0, cfg.vocab_size,
                           dtype=jnp.int32)))
    if arch == "whisper-tiny":
        want = jax.random.normal(k_aud, (2, cfg.enc_seq, cfg.d_model),
                                 jnp.float32)
        close(got["frames"], want, 1e-6, 1e-5)
        assert "patch_embeds" not in got
    else:
        want = jax.random.normal(k_vis, (2, cfg.vis_prefix_len,
                                         cfg.d_model), jnp.float32)
        close(got["patch_embeds"], want, 1e-6, 1e-5)
        assert "frames" not in got


def test_new_archs_through_the_launchers_on_cpu(capsys):
    """``launch.serve`` takes the four arch ids reduced on the CPU, and
    ``launch.train`` the three decoder-only ones."""
    from repro_torch.launch import train as launch_train
    archs = ("rwkv6-7b", "hymba-1.5b", "whisper-tiny", "paligemma-3b")
    for arch in archs:
        assert serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                           "--batch", "2", "--prompt-len", "8",
                           "--gen", "3"]) == 0
    for arch in archs[:2] + archs[3:]:
        assert launch_train.main(["--arch", arch, "--reduced", "--device",
                                  "cpu", "--steps", "2", "--batch", "2",
                                  "--seq-len", "16", "--n-seqs", "16",
                                  "--log-every", "1"]) == 0
    out = capsys.readouterr().out
    assert out.count("ms/token") == 4 and out.count("done: 2 steps") == 3


def test_every_config_equals_reference():
    """All ten arch ids resolve, full and reduced, field for field the
    reference's, and ``Model.from_config`` takes each."""
    from repro.configs import ARCH_IDS as JIDS
    from repro.configs import get_config as jget
    from repro_torch.configs import ARCH_IDS
    assert set(ARCH_IDS) == set(JIDS) and len(ARCH_IDS) == 10
    for arch in ARCH_IDS:
        assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(
            jget(arch))
        assert dataclasses.asdict(get_reduced_config(arch)) == \
            dataclasses.asdict(jreduced(arch))
        Model.from_config(get_config(arch))
