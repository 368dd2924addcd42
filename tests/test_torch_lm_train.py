"""The port's LM training path against the JAX reference, on the CPU.

Inputs come from numpy seeds; the reference's params (``jax.random``)
are carried to the port with ``interop``.  The reference runs jitted.

The optimizer, the train step and the other dense configs are in
``test_torch_lm_optim.py``.  Tolerances:

* float32 (reduced configs with ``dtype="float32"``): values within
  rtol 1e-5 / atol 1e-6 (ROADMAP C3: XLA and torch sum in different
  orders and XLA fuses multiply-adds); gradients, which sum those
  differences over the sequence and the batch, within rtol 1e-4 / atol
  1e-5 of values whose scale is 0.1-10.
* bfloat16 (the reduced configs' default activations): the loss within
  1% (one bf16 rounding step is 2^-8 relative, and the packages round
  at different places), gradients within 5% of each leaf's max |grad|.
* Exact: the block skip against the full sweep (same per-block ops), the
  int8 compressor's integers, the flash wrapper's refusal.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jreduced
from repro.models import attention as jattn
from repro.models import transformer as jtr
from repro.models.model_api import Model as JModel
from repro_torch import interop
from repro_torch.configs import get_reduced_config
from repro_torch.kernels import ops
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttr
from repro_torch.models.model_api import Model
from repro_torch.models.qhead import tree_leaves

RTOL, ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol,
                               err_msg=msg)


def _jleaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


# ---------------------------------------------------------------------------
# chunked attention
# ---------------------------------------------------------------------------

# (B, Hq, Hkv, S, D, causal, window, bq, bkv)
ATTN_CASES = {
    "causal-mha-S40": (2, 4, 4, 40, 16, True, None, 16, 16),
    "causal-gqa-window": (1, 4, 2, 37, 16, True, 8, 16, 8),
    "causal-mqa": (2, 4, 1, 33, 16, True, None, 16, 32),
    "bidirectional-gqa": (1, 4, 2, 33, 16, False, None, 32, 16),
    "window-wide-blocks": (1, 2, 1, 70, 8, True, 20, 16, 16),
}


def _attn_inputs(case, seed=0):
    B, Hq, Hkv, S, D = ATTN_CASES[case][:5]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(sh).astype(np.float32)
            for sh in ((B, Hq, S, D), (B, Hkv, S, D), (B, Hkv, S, D))]


@pytest.mark.parametrize("skip", [False, True], ids=["full", "skip"])
@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_chunked_attention_and_grads_match_reference(case, skip):
    _, _, _, S, _, causal, window, bq, bkv = ATTN_CASES[case]
    q, k, v = _attn_inputs(case)
    info = (True, window) if (skip and causal) else None
    w = np.random.default_rng(1).standard_normal(q.shape).astype(np.float32)

    def jf(q, k, v):
        return jattn.chunked_attention(
            q, k, v, jattn.make_mask_fn(causal, window, None), bq=bq,
            bkv=bkv, skip_info=info)

    want = jax.jit(jf)(q, k, v)
    jgrads = jax.jit(jax.grad(lambda q, k, v: (jf(q, k, v) * w).sum(),
                              argnums=(0, 1, 2)))(q, k, v)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    got = tattn.chunked_attention(
        tq, tk, tv, tattn.make_mask_fn(causal, window, None), bq=bq,
        bkv=bkv, skip_info=info)
    _close(got, want, msg="forward")
    tgrads = torch.autograd.grad((got * torch.from_numpy(w)).sum(),
                                 (tq, tk, tv))
    for name, a, b in zip("qkv", tgrads, jgrads):
        _close(a, b, GRAD_RTOL, GRAD_ATOL, f"d{name}")


@pytest.mark.parametrize("case", [c for c, v in ATTN_CASES.items() if v[5]])
def test_block_skip_is_bit_exact_with_full_sweep(case):
    """Forward and gradients, bit for bit, with and without the skip."""
    _, _, _, _, _, causal, window, bq, bkv = ATTN_CASES[case]
    outs = []
    for info in (None, (True, window)):
        q, k, v = (torch.from_numpy(a).requires_grad_(True)
                   for a in _attn_inputs(case, seed=3))
        out = tattn.chunked_attention(
            q, k, v, tattn.make_mask_fn(causal, window, None), bq=bq,
            bkv=bkv, skip_info=info)
        grads = torch.autograd.grad(out.square().sum(), (q, k, v))
        outs.append([out.detach(), *grads])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_chunked_attention_matches_attention_ref_in_bf16():
    """The chunked route against the flash kernel's plain version on one
    bf16 input: within 2e-2 (the kernels' bf16 tolerance, ATTN_TOL)."""
    from repro_torch.kernels.ref import attention_ref
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _attn_inputs("causal-gqa-window", seed=5))
    got = tattn.chunked_attention(q, k, v, tattn.make_mask_fn(True, 8, None),
                                  bq=16, bkv=8)
    want = attention_ref(q, k, v, causal=True, window=8)
    assert got.dtype == torch.bfloat16
    _close(got, want, 2e-2, 2e-2)


def test_flash_wrapper_refuses_inputs_that_require_grad():
    q = torch.zeros(1, 2, 8, 16)
    k = torch.zeros(1, 2, 8, 16)
    with pytest.raises(RuntimeError, match="require grad"):
        ops.flash_attention(q.requires_grad_(True), k, k)
    with torch.no_grad():  # no recording: the plain version runs
        assert ops.flash_attention(q, k, k).shape == q.shape
    assert not ops.flash_attention(q.detach(), k, k).requires_grad


def test_gqa_apply_routes_by_grad_mode(monkeypatch):
    """Recording -> chunked_attention (the flash wrapper is never
    called); no grad -> the flash wrapper."""
    cfg = get_reduced_config("stablelm-1.6b", dtype="float32")
    params = Model.from_config(cfg).init_params(
        torch.Generator().manual_seed(0), device="cpu")
    lp = {k: v[0] for k, v in params["blocks"]["mix"].items()}
    x = torch.randn(2, 12, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    pos = torch.arange(12).expand(2, 12)
    calls = []
    real = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    with torch.no_grad():
        tattn.gqa_apply(cfg, lp, x, pos)
    assert calls == [1]
    lp = {k: v.requires_grad_(True) for k, v in lp.items()}
    out = tattn.gqa_apply(cfg, lp, x, pos)
    assert calls == [1] and out.requires_grad
    torch.autograd.grad(out.sum(), lp["wq"])


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _lm_setup(arch="stablelm-1.6b", seed=0, b=2, s=40, **over):
    jcfg = jreduced(arch, **over)
    tcfg = get_reduced_config(arch, **over)
    jparams = JModel.from_config(jcfg).init_params(jax.random.key(seed))
    tparams = interop.lm_params_from_jax(jax.tree.map(np.asarray, jparams),
                                         "cpu")
    toks = np.random.default_rng(seed + 10).integers(
        0, jcfg.vocab_size, (b, s + 1)).astype(np.int32)
    mask = np.ones((b, s), np.float32)
    mask[0, -7:] = 0.0  # a masked tail
    jbatch = {"tokens": toks[:, :-1], "targets": toks[:, 1:],
              "loss_mask": mask}
    tbatch = {k: torch.from_numpy(np.ascontiguousarray(v))
              for k, v in jbatch.items()}
    return jcfg, tcfg, jparams, tparams, jbatch, tbatch


LOSS_CASES = {
    "tied-full": ("stablelm-1.6b", {}),
    "tied-blockwise": ("stablelm-1.6b", {"ce_block": 64}),
    "tied-blockwise-ragged": ("stablelm-1.6b", {"ce_block": 48,
                                                "vocab_size": 250}),
    "untied-mqa-full": ("granite-34b", {}),
    "untied-blockwise-ragged": ("granite-34b", {"ce_block": 100}),
    "gqa-untied-full": ("phi3-medium-14b", {}),
    "no-skip-no-remat": ("stablelm-1.6b", {"attn_block_skip": False,
                                           "remat": False}),
}


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_lm_loss_and_grads_match_reference(case):
    arch, over = LOSS_CASES[case]
    jcfg, tcfg, jparams, tparams, jbatch, tbatch = _lm_setup(
        arch, dtype="float32", **over)
    jfn = jax.jit(jax.value_and_grad(
        lambda p: jtr.lm_loss(jcfg, p, jbatch)[0]))
    jloss, jgrads = jfn(jparams)
    leaves = [p.requires_grad_(True) for p in tree_leaves(tparams)]
    loss, metrics = ttr.lm_loss(tcfg, tparams, tbatch)
    _close(loss, jloss, msg="loss")
    assert metrics["nll"] is loss
    grads = torch.autograd.grad(loss, leaves)
    for a, b in zip(grads, _jleaves(jgrads)):
        assert tuple(a.shape) == b.shape
        _close(a, b, GRAD_RTOL, GRAD_ATOL)


def test_blockwise_nll_equals_full_logits_in_the_port():
    """``ce_block`` set against unset on one model (the reference's
    ``test_blockwise_ce_matches_standard``, in the port)."""
    _, tcfg, _, tparams, _, tbatch = _lm_setup(dtype="float32")
    l1, _ = ttr.lm_loss(tcfg, tparams, tbatch)
    l2, _ = ttr.lm_loss(dataclasses.replace(tcfg, ce_block=64), tparams,
                        tbatch)
    _close(l1, l2, atol=1e-5)


def test_lm_loss_in_bfloat16_matches_reference():
    jcfg, tcfg, jparams, tparams, jbatch, tbatch = _lm_setup(seed=3)
    assert tcfg.dtype == "bfloat16"
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jtr.lm_loss(jcfg, p, jbatch)[0]))(jparams)
    leaves = [p.requires_grad_(True) for p in tree_leaves(tparams)]
    loss, _ = ttr.lm_loss(tcfg, tparams, tbatch)
    _close(loss, jloss, rtol=1e-2, atol=0)
    for a, b in zip(torch.autograd.grad(loss, leaves), _jleaves(jgrads)):
        _close(a, b, rtol=0, atol=0.05 * float(np.abs(b).max()) + 1e-6)


def test_lm_loss_refuses_the_patch_prefix():
    """The loss keeps the patch prefix out: with ``patch_embeds`` it is
    the masked mean NLL of the text positions of the forward over
    [prefix + text] (the prefix in the forward, never in the loss); and
    the audio family's loss is ``encdec.encdec_loss``."""
    _, tcfg, _, tparams, _, tbatch = _lm_setup(dtype="float32")
    patches = torch.randn(2, 4, tcfg.d_model,
                          generator=torch.Generator().manual_seed(0))
    loss, _ = ttr.lm_loss(tcfg, tparams, dict(tbatch, patch_embeds=patches))
    logits = ttr.forward(tcfg, tparams, tbatch["tokens"],
                         extra_embeds=patches)[:, 4:]
    nll = -torch.gather(torch.log_softmax(logits, -1), -1, tbatch[
        "targets"].to(torch.int64)[..., None])[..., 0]
    mask = tbatch["loss_mask"]
    torch.testing.assert_close(loss, (nll * mask).sum() / mask.sum(),
                               rtol=1e-6, atol=1e-6)
    from repro_torch.models import encdec
    audio = dataclasses.replace(tcfg, family="audio")
    calls = []
    real = encdec.encdec_loss
    try:
        encdec.encdec_loss = lambda cfg, p, b: calls.append(cfg) or (0, {})
        Model(audio).loss(tparams, tbatch)
    finally:
        encdec.encdec_loss = real
    assert calls == [audio]
