"""hymba-1.5b (reduced) and the Mamba head against the JAX reference.

The Mamba modules alone (``_conv1d`` with and without its cache,
``_ssm_scan``, ``mamba_apply`` in its three cache modes) take
numpy-seeded inputs and params; then the reduced arch as a whole, from
the reference's params carried over with ``interop``: its per-layer
windows (layer 0 global, layer 1 under the window, as the reduced
config's ``global_attn_layers = (0, 15, 31)`` leaves them), forward,
prefill and token-by-token decode, the loss and one train step
(``test_torch_lm_window.py``'s checks).  The reduced window is 32 keys,
so the 40-token prompt and the decode steps run past it on layer 1.
The reference runs jitted; its Mamba path is jnp (no Pallas kernel).

Tolerances: the modules in float32 within atol = rtol = 2e-5 (XLA fuses
the scan's multiply-add; the packages sum in other orders); the arch
checks as stated in ``test_torch_lm_window.py``.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jreduced
from repro.models import mamba as jmamba
from repro_torch.configs import get_reduced_config
from repro_torch.models import mamba as tmamba
from repro_torch.models import transformer as ttr
from test_torch_lm_window import (check_forward, check_loss_and_train_step,
                                  check_param_tree, check_prefill_decode,
                                  close)

ARCH = "hymba-1.5b"
TOL = 2e-5


@pytest.fixture(autouse=True)
def partitionable():
    with jax.threefry_partitionable(True):
        yield


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _cfgs():
    return (jreduced(ARCH, dtype="float32"),
            get_reduced_config(ARCH, dtype="float32"))


def _mamba_params(jcfg, seed):
    """numpy leaves of one Mamba head (d_inner = expand * d_model): fan-in
    scaled normals, a_log, dt_bias, d_skip and conv_b drawn small."""
    d_inner = jcfg.ssm_expand * jcfg.d_model
    rng = np.random.default_rng(seed)
    out = {}
    for n, sp in jmamba.mamba_specs(jcfg, None, jcfg.d_model,
                                    d_inner).items():
        if len(sp.shape) == 1 or sp.init in ("zeros", "ones"):
            out[n] = (0.3 * rng.standard_normal(sp.shape)).astype(np.float32)
        else:
            out[n] = (rng.standard_normal(sp.shape) * sp.scale
                      / np.sqrt(sp.shape[-2])).astype(np.float32)
    return out


@pytest.mark.parametrize("cached", [False, True])
def test_conv1d_matches_reference(cached):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    b = rng.standard_normal((12,)).astype(np.float32)
    cache = rng.standard_normal((2, 3, 12)).astype(np.float32) if cached \
        else None
    out, nc = jax.jit(jmamba._conv1d)(x, w, b, cache)
    tout, tnc = tmamba._conv1d(_t(x), _t(w), _t(b),
                               None if cache is None else _t(cache))
    close(tout, out, TOL, TOL)
    np.testing.assert_array_equal(tnc.numpy(), np.asarray(nc))


def test_ssm_scan_matches_reference():
    rng = np.random.default_rng(2)
    B, S, Di, Ns = 2, 9, 16, 8
    u = rng.standard_normal((B, S, Di)).astype(np.float32)
    dt = rng.uniform(0.01, 1.0, (B, S, Di)).astype(np.float32)
    b_in, c_in = (rng.standard_normal((B, S, Ns)).astype(np.float32)
                  for _ in range(2))
    a_log = (0.5 * rng.standard_normal((Di, Ns))).astype(np.float32)
    d_skip = rng.standard_normal((Di,)).astype(np.float32)
    state = rng.standard_normal((B, Di, Ns)).astype(np.float32)
    y, h = jax.jit(jmamba._ssm_scan)(u, dt, b_in, c_in, a_log, d_skip, state)
    ty, th = tmamba._ssm_scan(*map(_t, (u, dt, b_in, c_in, a_log, d_skip,
                                        state)))
    close(ty, y, TOL, TOL, msg="y")
    close(th, h, TOL, TOL, msg="state")


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_mamba_apply_matches_reference(mode):
    """The three cache modes: none (training: no cache back), a fresh
    cache from a full sequence (prefill), a given cache (decode, one
    token)."""
    jcfg, tcfg = _cfgs()
    p = _mamba_params(jcfg, 3)
    rng = np.random.default_rng(4)
    d_inner = jcfg.ssm_expand * jcfg.d_model
    S = 1 if mode == "decode" else 11
    x = rng.standard_normal((2, S, jcfg.d_model)).astype(np.float32)
    kw = {}
    if mode == "prefill":
        kw = {"return_cache": True}
    if mode == "decode":
        kw = {"cache": {
            "h": rng.standard_normal((2, d_inner, jcfg.ssm_state)).astype(
                np.float32),
            "conv": rng.standard_normal((2, jcfg.ssm_conv - 1,
                                         d_inner)).astype(np.float32)}}
    want, wc = jax.jit(lambda p, x, c: jmamba.mamba_apply(
        jcfg, p, x, cache=c, return_cache=mode == "prefill"))(
        p, x, kw.get("cache"))
    tkw = dict(kw)
    if "cache" in kw:
        tkw["cache"] = {n: _t(w) for n, w in kw["cache"].items()}
    got, tc = tmamba.mamba_apply(tcfg, {n: _t(w) for n, w in p.items()},
                                 _t(x), **tkw)
    close(got, want, TOL, TOL)
    if mode == "train":
        assert tc is None and wc is None
    else:
        assert set(tc) == set(wc) == {"h", "conv"}
        for n in wc:
            close(tc[n], wc[n], TOL, TOL, msg=n)


# ---------------------------------------------------------------------------
# hymba-1.5b, reduced
# ---------------------------------------------------------------------------

def test_hymba_reduced_has_a_global_and_a_windowed_layer():
    cfg = get_reduced_config(ARCH)
    assert ttr.layer_windows(cfg) == [ttr.GLOBAL_WINDOW, 32]
    assert cfg.n_heads // cfg.n_kv_heads == 2
    cache = ttr.init_cache(cfg, 2, 48, "cpu")["blocks"]
    assert set(cache) == {"k", "v", "mamba_h", "mamba_conv"}
    assert cache["mamba_h"].dtype == torch.float32
    assert tuple(cache["mamba_h"].shape) == (2, 2, 128, 8)
    assert tuple(cache["mamba_conv"].shape) == (2, 2, 3, 128)


def test_hymba_param_tree_equals_reference():
    check_param_tree(ARCH)


def test_hymba_forward_matches_reference():
    check_forward(ARCH)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hymba_prefill_and_decode_match_reference(dtype):
    check_prefill_decode(ARCH, dtype)


def test_hymba_loss_and_train_step_match_reference():
    check_loss_and_train_step(ARCH)


def test_hymba_global_layers_take_no_window_in_the_kernels(monkeypatch):
    """The global layer's ``GLOBAL_WINDOW`` reaches the kernels as no
    window, the windowed layer's as its 32 keys, at prefill and decode."""
    from repro_torch.kernels import ops
    seen = {"flash": [], "decode": []}
    real_f, real_d = ops.flash_attention, ops.decode_attention

    def flash(q, k, v, **kw):
        seen["flash"].append(kw["window"])
        return real_f(q, k, v, **kw)

    def decode(q, k, v, cur, **kw):
        seen["decode"].append(kw["window"])
        return real_d(q, k, v, cur, **kw)

    monkeypatch.setattr(ops, "flash_attention", flash)
    monkeypatch.setattr(ops, "decode_attention", decode)
    from repro_torch.models.model_api import Model
    from repro_torch.serving import Engine
    cfg = get_reduced_config(ARCH, dtype="float32")
    m = Model.from_config(cfg)
    p = m.init_params(torch.Generator().manual_seed(0), device="cpu")
    Engine(m, p).generate({"tokens": torch.zeros(1, 8, dtype=torch.int32)},
                          3)
    assert seen == {"flash": [None, 32], "decode": [None, 32] * 2}
