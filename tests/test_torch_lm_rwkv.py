"""rwkv6-7b (reduced) and its modules against the JAX reference.

The modules alone (``token_shift``, the rwkv channel-mix, ``_rkvwg``,
``wkv_recurrent``, ``wkv_chunked``, ``rwkv_apply`` in both modes,
``rwkv_decode``) take numpy-seeded inputs and params; then the reduced
arch as a whole, from the reference's params carried over with
``interop``: forward, prefill and token-by-token decode, the loss and
one train step (``test_torch_lm_window.py``'s checks), once with the
reduced chunk of 16 (the 40-token sequences run the recurrence) and once
with a chunk of 8 (they run the chunked path).  The reference runs
jitted; its rwkv path is jnp (no Pallas kernel).

Tolerances: the modules in float32 within atol = rtol = 2e-5 (the
packages sum the chunk products and the recurrence in other orders, and
XLA fuses multiply-adds); the arch checks as stated in
``test_torch_lm_window.py``.  C12 (ROADMAP): at the reference config's
chunk of 128 and a log-decay of -1 or -2.5, the reference's chunked WKV
is NaN, and the port's, run as sub-chunks of 32, equals the reference's
recurrence within 1e-4; at -0.3, where the reference's chunked result is
finite, the port's equals it within 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jreduced
from repro.models import mlp as jmlp
from repro.models import rwkv6 as jrwkv
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.models import mlp as tmlp
from repro_torch.models import rwkv6 as trwkv
from repro_torch.models import transformer as ttr
from test_torch_lm_window import (arch_setup, check_forward,
                                  check_loss_and_train_step,
                                  check_param_tree, check_prefill_decode,
                                  close)

ARCH = "rwkv6-7b"
TOL = 2e-5
C12_TOL = 1e-4


@pytest.fixture(autouse=True)
def partitionable():
    with jax.threefry_partitionable(True):
        yield


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _cfgs(**over):
    return (jreduced(ARCH, dtype="float32", **over),
            get_reduced_config(ARCH, dtype="float32", **over))


def _params(specs, seed):
    """numpy leaves for a spec dict: fan-in-scaled normals, and the
    ones / zeros leaves drawn too (mu in [0, 1], the rest small), so no
    leaf is trivial."""
    rng = np.random.default_rng(seed)
    out = {}
    for n, sp in specs.items():
        if n.startswith("mu"):
            out[n] = rng.uniform(0, 1, sp.shape).astype(np.float32)
        elif sp.init in ("zeros", "ones") or len(sp.shape) == 1:
            out[n] = (0.3 * rng.standard_normal(sp.shape)).astype(np.float32)
        else:
            out[n] = (rng.standard_normal(sp.shape)
                      / np.sqrt(sp.shape[-2])).astype(np.float32)
    return out


def _wkv_inputs(seed, B=2, H=4, S=48, N=16, lw=None):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, H, S, N)).astype(np.float32)
               for _ in range(3))
    if lw is None:
        lw = rng.uniform(jrwkv.LW_MIN, jrwkv.LW_MAX,
                         (B, H, S, N)).astype(np.float32)
    else:
        lw = np.full((B, H, S, N), lw, np.float32)
    u = (0.5 * rng.standard_normal((H, N))).astype(np.float32)
    state = (0.1 * rng.standard_normal((B, H, N, N))).astype(np.float32)
    return r, k, v, lw, u, state


def test_token_shift_matches_reference():
    x = np.random.default_rng(0).standard_normal((2, 5, 8)).astype(
        np.float32)
    np.testing.assert_array_equal(tmlp.token_shift(_t(x)).numpy(),
                                  np.asarray(jmlp.token_shift(x)))


@pytest.mark.parametrize("shifted", [False, True])
def test_rwkv_cmix_matches_reference(shifted):
    """The channel-mix over a sequence (its own token shift) and at
    decode (the previous token's input given)."""
    jcfg, _ = _cfgs()
    p = _params(jmlp.mlp_specs("rwkv_cmix", jcfg.d_model, jcfg.d_ff, None),
                1)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 6, jcfg.d_model)).astype(np.float32)
    xp = (rng.standard_normal((2, 6, jcfg.d_model)).astype(np.float32)
          if shifted else None)
    want = jax.jit(lambda p, x, xp: jmlp.mlp_apply("rwkv_cmix", p, x, xp))(
        p, x, xp)
    got = tmlp.mlp_apply("rwkv_cmix", {n: _t(w) for n, w in p.items()},
                         _t(x), None if xp is None else _t(xp))
    close(got, want, TOL, TOL)


def test_rkvwg_matches_reference():
    jcfg, tcfg = _cfgs()
    p = _params(jrwkv.rwkv_specs(jcfg, None), 3)
    rng = np.random.default_rng(4)
    x, xp = (rng.standard_normal((2, 7, jcfg.d_model)).astype(np.float32)
             for _ in range(2))
    want = jax.jit(lambda p, x, xp: jrwkv._rkvwg(jcfg, p, x, xp))(p, x, xp)
    got = trwkv._rkvwg(tcfg, {n: _t(w) for n, w in p.items()}, _t(x), _t(xp))
    for g, w, name in zip(got, want, "r k v g lw".split()):
        assert tuple(g.shape) == w.shape, name
        close(g, w, TOL, TOL, msg=name)


def test_wkv_recurrent_matches_reference():
    r, k, v, lw, u, state = _wkv_inputs(5)
    y, s = jax.jit(jrwkv.wkv_recurrent)(r, k, v, lw, u, state)
    ty, ts = trwkv.wkv_recurrent(*map(_t, (r, k, v, lw, u, state)))
    close(ty, y, TOL, TOL, msg="y")
    close(ts, s, TOL, TOL, msg="state")


@pytest.mark.parametrize("chunk", [16, 8])
def test_wkv_chunked_matches_reference(chunk):
    r, k, v, lw, u, state = _wkv_inputs(6)
    y, s = jax.jit(jrwkv.wkv_chunked, static_argnums=6)(r, k, v, lw, u,
                                                        state, chunk)
    ty, ts = trwkv.wkv_chunked(*map(_t, (r, k, v, lw, u, state)), chunk)
    close(ty, y, TOL, TOL, msg="y")
    close(ts, s, TOL, TOL, msg="state")


def test_wkv_chunked_gradients_match_the_recurrence():
    """The chunk steps are checkpointed when autograd records; their
    gradients equal the recurrence's (rtol 1e-4)."""
    ins = [_t(x).requires_grad_(True) for x in _wkv_inputs(7, S=32)]
    y, s = trwkv.wkv_chunked(*ins, 16)
    g1 = torch.autograd.grad((y ** 2).sum() + s.sum(), ins)
    y, s = trwkv.wkv_recurrent(*ins)
    g2 = torch.autograd.grad((y ** 2).sum() + s.sum(), ins)
    for a, b in zip(g1, g2):
        close(a, b, 1e-4 * float(b.abs().max()), 1e-4)


@pytest.mark.parametrize("lw,ref_nan", [(-1.0, True), (-2.5, True),
                                        (-0.3, False)])
def test_c12_chunk_128_stays_finite(lw, ref_nan):
    """C12: at the reference config's chunk of 128 (B 1, H 2, S 256, N 16,
    a constant log-decay), the reference's chunked WKV is NaN at lw -1 and
    -2.5; the port's is finite and within 1e-4 of the reference's
    recurrence.  At -0.3 both chunked results are finite and agree."""
    assert get_config(ARCH).rwkv_chunk == 128
    assert trwkv.sub_chunk(128) == 32 and trwkv.sub_chunk(16) == 16
    r, k, v, lwa, u, state = _wkv_inputs(8, B=1, H=2, S=256, N=16, lw=lw)
    state = np.zeros_like(state)
    yc, _ = jax.jit(jrwkv.wkv_chunked, static_argnums=6)(r, k, v, lwa, u,
                                                         state, 128)
    yr, sr = jax.jit(jrwkv.wkv_recurrent)(r, k, v, lwa, u, state)
    assert bool(np.isnan(np.asarray(yc)).any()) == ref_nan
    ty, ts = trwkv.wkv_chunked(*map(_t, (r, k, v, lwa, u, state)), 128)
    assert bool(torch.isfinite(ty).all()) and bool(torch.isfinite(ts).all())
    close(ty, yr, C12_TOL, msg="y against the recurrence")
    close(ts, sr, C12_TOL, C12_TOL, msg="state against the recurrence")
    if not ref_nan:
        close(ty, yc, C12_TOL, msg="y against the reference's chunks")


@pytest.mark.parametrize("mode,S,with_state", [
    ("chunked", 48, False), ("chunked", 48, True), ("recurrent", 48, True),
    ("chunked", 40, False)])    # 40 % 16 != 0: the recurrence
def test_rwkv_apply_matches_reference(mode, S, with_state):
    jcfg, tcfg = _cfgs(rwkv_mode=mode)
    p = _params(jrwkv.rwkv_specs(jcfg, None), 9)
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, S, jcfg.d_model)).astype(np.float32)
    H, N = jcfg.d_model // jcfg.rwkv_head_dim, jcfg.rwkv_head_dim
    kw = {}
    if with_state:
        kw = {"x_prev": rng.standard_normal(x.shape).astype(np.float32),
              "state": (0.1 * rng.standard_normal((2, H, N, N))).astype(
                  np.float32)}
    y, s = jax.jit(lambda p, x, kw: jrwkv.rwkv_apply(jcfg, p, x, **kw))(
        p, x, kw)
    ty, ts = trwkv.rwkv_apply(tcfg, {n: _t(w) for n, w in p.items()}, _t(x),
                              **{n: _t(w) for n, w in kw.items()})
    close(ty, y, TOL, TOL, msg="y")
    close(ts, s, TOL, TOL, msg="state")


def test_rwkv_decode_matches_reference():
    jcfg, tcfg = _cfgs()
    p = _params(jrwkv.rwkv_specs(jcfg, None), 11)
    rng = np.random.default_rng(12)
    H, N = jcfg.d_model // jcfg.rwkv_head_dim, jcfg.rwkv_head_dim
    x, xp = (rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
             for _ in range(2))
    cache = {"state": (0.1 * rng.standard_normal((2, H, N, N))).astype(
        np.float32), "x_prev": xp, "cx_prev": np.zeros_like(xp)}
    y, c = jax.jit(lambda p, x, c: jrwkv.rwkv_decode(jcfg, p, x, c))(
        p, x, cache)
    ty, tc = trwkv.rwkv_decode(tcfg, {n: _t(w) for n, w in p.items()},
                               _t(x), {n: _t(w) for n, w in cache.items()})
    close(ty, y, TOL, TOL)
    assert set(tc) == set(c)
    for n in c:
        close(tc[n], c[n], TOL, TOL, msg=n)


# ---------------------------------------------------------------------------
# rwkv6-7b, reduced
# ---------------------------------------------------------------------------

def test_rwkv_cache_holds_the_state_and_two_inputs():
    cfg = get_reduced_config(ARCH)
    cache = ttr.init_cache(cfg, 2, 48, "cpu")
    blocks = cache["blocks"]
    assert set(blocks) == {"state", "x_prev", "cx_prev"}
    assert blocks["state"].dtype == torch.float32
    assert tuple(blocks["state"].shape) == (2, 2, 4, 16, 16)
    assert tuple(blocks["x_prev"].shape) == (2, 2, 1, 64)


def test_rwkv_param_tree_equals_reference():
    check_param_tree(ARCH)


@pytest.mark.parametrize("chunk", [16, 8])
def test_rwkv_forward_matches_reference(chunk):
    check_forward(ARCH, rwkv_chunk=chunk)


@pytest.mark.parametrize("dtype,chunk", [("float32", 16), ("float32", 8),
                                         ("bfloat16", 8)])
def test_rwkv_prefill_and_decode_match_reference(dtype, chunk):
    check_prefill_decode(ARCH, dtype, rwkv_chunk=chunk)


@pytest.mark.parametrize("chunk", [16, 8])
def test_rwkv_loss_and_train_step_match_reference(chunk):
    check_loss_and_train_step(ARCH, rwkv_chunk=chunk)


def test_rwkv_generate_equals_reference():
    from repro.serving import Engine as JEngine
    from repro_torch.serving import Engine
    jm, jparams, tm, tparams, toks = arch_setup(ARCH, seed=4, rwkv_chunk=8)
    want = JEngine(jm, jparams).generate({"tokens": jnp.asarray(toks)}, 6)
    got = Engine(tm, tparams).generate({"tokens": torch.from_numpy(toks)}, 6)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    close(got.logits_last, want.logits_last, 5e-4)
