"""MLA with its latent cache (deepseek-v2-lite-16b, reduced) against the
JAX reference.

The block alone (``mla_apply`` through the flash kernel's plain version
and through the differentiable chunked route, ``mla_decode`` with the
latent written in place), then the reduced arch as a whole: forward,
prefill and 4 decode steps, the loss with the MoE's aux terms and one
train step (``test_torch_lm_window.py``'s checks).  Reduced MLA scores
over qk_nope 16 + qk_rope 8 = 24 columns and averages v_head_dim 16 of
them (Dv != D), from a 32 + 8 latent.  Inputs come from numpy seeds;
the reference runs jitted, its attention the jnp ``chunked_attention``
and ``decode_attention`` (no Pallas kernel).  Tolerances: float32 2e-5
for the block's outputs and the latent (the flash and decode kernels'
own, the packages summing in other orders), the block's gradients rtol
1e-4 / atol 1e-6 of each leaf's largest |grad| (the sum-of-squares loss
makes them 10-100); the arch checks' as stated in
``test_torch_lm_window.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jreduced
from repro.models import attention as jattn
from repro_torch.configs import get_reduced_config
from repro_torch.kernels import ops
from repro_torch.models import attention as tattn
from test_torch_lm_window import (check_forward, check_loss_and_train_step,
                                  check_param_tree, check_prefill_decode,
                                  close)

ARCH = "deepseek-v2-lite-16b"
TOL = 2e-5
GRAD_RTOL, GRAD_ATOL_OF_MAX = 1e-4, 1e-6


@pytest.fixture(autouse=True)
def partitionable():
    with jax.threefry_partitionable(True):
        yield


def _cfgs():
    return (jreduced(ARCH, dtype="float32"),
            get_reduced_config(ARCH, dtype="float32"))


def _mla_params(jcfg, seed):
    """MLA's leaves from a numpy seed (fan-in-scaled normals; kv_norm
    small, so that its rms-norm scale is not 1 everywhere)."""
    rng = np.random.default_rng(seed)
    out = {}
    for n, sp in jattn.mla_specs(jcfg, None).items():
        x = rng.standard_normal(sp.shape).astype(np.float32)
        out[n] = x * 0.1 if n == "kv_norm" else x / np.sqrt(sp.shape[0])
    return out


def _torch(p):
    return {n: torch.from_numpy(w.copy()) for n, w in p.items()}


def test_reduced_mla_has_two_head_dims():
    cfg = get_reduced_config(ARCH)
    assert (cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim,
            cfg.kv_lora_rank) == (24, 16, 32)
    assert cfg.n_experts == 8 and cfg.first_dense_layers == 1


@pytest.mark.parametrize("window", [None, 8])
def test_mla_apply_matches_reference(window):
    """The prefill path (no grad: the flash kernel's plain version with
    D 24, Dv 16) and the latent it returns; S 40 against the reference's
    32-row blocks."""
    jcfg, tcfg = _cfgs()
    p = _mla_params(jcfg, 5)
    x = np.random.default_rng(6).standard_normal(
        (2, 40, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(40), (2, 40))
    want, jlat = jax.jit(lambda p, x: jattn.mla_apply(
        jcfg, p, x, jnp.asarray(pos), jattn.make_mask_fn(True, window, None),
        return_latent=True, skip_info=(True, window)))(p, x)
    got, lat = tattn.mla_apply(tcfg, _torch(p), torch.from_numpy(x),
                               torch.from_numpy(pos.copy()), window=window,
                               return_latent=True)
    close(got, want, TOL, TOL)
    close(lat, jlat, TOL, TOL)
    assert lat.shape == (2, 40, tcfg.kv_lora_rank + tcfg.qk_rope_dim)


def test_mla_apply_routes_by_grad_mode_and_its_grads_match(monkeypatch):
    """With grad the chunked route runs (the flash wrapper is not
    called), and the gradients of every leaf equal jax.grad's."""
    jcfg, tcfg = _cfgs()
    p = _mla_params(jcfg, 7)
    x = np.random.default_rng(8).standard_normal(
        (2, 33, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(33), (2, 33))
    mask = jattn.make_mask_fn(True, None, None)

    def jloss(p, x):
        return jnp.sum(jattn.mla_apply(jcfg, p, x, jnp.asarray(pos), mask,
                                       skip_info=(True, None)) ** 2)

    jl, (jgp, jgx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(p, x)
    called = []
    real = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention",
                        lambda *a, **k: called.append(1) or real(*a, **k))
    tp = {n: w.requires_grad_(True) for n, w in _torch(p).items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    out = tattn.mla_apply(tcfg, tp, tx, torch.from_numpy(pos.copy()),
                          skip_info=(True, None))
    loss = (out ** 2).sum()
    assert not called
    close(loss, jl, 0, 1e-5)
    grads = torch.autograd.grad(loss, [tp[n] for n in sorted(tp)] + [tx])
    for g, name in zip(grads, sorted(tp) + ["x"]):
        want = jgx if name == "x" else jgp[name]
        close(g, want, GRAD_ATOL_OF_MAX * float(np.abs(want).max()),
              GRAD_RTOL, msg=name)


@pytest.mark.parametrize("pos,window", [(0, None), (29, None), (47, None),
                                        (40, 8)])
def test_mla_decode_matches_reference(pos, window):
    """One decode step at ``pos`` of a 48-row latent cache (first row,
    middle, last, and past a window): the latent written in place at
    ``len``, the whole cache expanded through ``wkv_b``, the decode
    kernel's plain version with Hkv = H, group 1, D 24, Dv 16."""
    jcfg, tcfg = _cfgs()
    p = _mla_params(jcfg, 9)
    rng = np.random.default_rng(10)
    lat_dim = jcfg.kv_lora_rank + jcfg.qk_rope_dim
    x = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
    lat = rng.standard_normal((2, 48, lat_dim)).astype(np.float32)
    want, jc = jax.jit(lambda p, x, c: jattn.mla_decode(
        jcfg, p, x, c, jattn.make_mask_fn(True, window, None)))(
        p, x, {"latent": lat, "len": jnp.int32(pos)})
    buf = torch.from_numpy(lat.copy())
    got, tc = tattn.mla_decode(
        tcfg, _torch(p), torch.from_numpy(x),
        {"latent": buf, "len": torch.tensor(pos, dtype=torch.int32)},
        window=window)
    close(got, want, TOL, TOL)
    close(tc["latent"], jc["latent"], TOL, TOL)
    assert tc["latent"] is buf and int(tc["len"]) == pos + 1
    assert tc["len"].dtype == torch.int32


def test_mla_cache_holds_only_the_latent():
    from repro_torch.models import transformer as ttr
    _, tcfg = _cfgs()
    cache = ttr.init_cache(tcfg, 3, 20, device="cpu")
    assert set(cache) == {"blocks", "dense_blocks", "len"}
    assert {k: tuple(v.shape) for k, v in cache["blocks"].items()} == {
        "latent": (1, 3, 20, 40)}
    assert {k: tuple(v.shape) for k, v in cache["dense_blocks"].items()} == {
        "latent": (1, 3, 20, 40)}


def test_mla_param_tree_equals_reference():
    check_param_tree(ARCH)


def test_mla_forward_matches_reference():
    check_forward(ARCH)


def test_mla_prefill_and_decode_match_reference():
    check_prefill_decode(ARCH)


def test_mla_loss_and_train_step_match_reference():
    check_loss_and_train_step(ARCH)
