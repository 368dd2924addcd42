"""The port's attention kernels and GQA block against the JAX reference.

Inputs come from numpy with fixed seeds and go to both packages.  The
plain versions (the CPU path of ``ops.flash_attention`` and
``ops.decode_attention``) are held against ``repro.kernels.ref`` and
against the Pallas kernels through ``repro.kernels.ops`` (interpret mode
on the CPU), over the reference's own sweep
(``tests/test_kernels.py``) at its tolerances: float32 2e-5 (flash) and
3e-5 (decode), bfloat16 2e-2, atol and rtol.  The ``cuda``-marked tests
hold the CUDA kernels against the plain versions on a card.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro.configs import get_reduced_config as jreduced
from repro_torch.configs import get_reduced_config
from repro_torch.kernels import ops
from repro_torch.kernels.ref import attention_ref, decode_attention_ref
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as tlm

FLASH_CASES = [
    (2, 4, 2, 256, 64, True, None),    # GQA
    (1, 8, 1, 256, 128, True, None),   # MQA
    (2, 4, 4, 256, 128, True, 64),     # MHA + sliding window
    (1, 2, 2, 256, 256, False, None),  # bidirectional (encoder)
    (1, 4, 2, 300, 64, True, None),    # non-tile-aligned seq
]
DECODE_CASES = [
    (2, 2, 4, 1024, 64, 700),    # GQA
    (1, 1, 8, 512, 128, 512),    # MQA, full cache
    (2, 4, 1, 300, 96, 37),      # MHA, ragged S and D
]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def partitionable():
    with jax.threefry_partitionable(True):
        yield


def _normal(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _both(xs, dtype):
    jdt, tdt = DTYPES[dtype]
    return ([jnp.asarray(x, jdt) for x in xs],
            [torch.from_numpy(x).to(tdt) for x in xs])


def _close(got, want, tol):
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,hq,hkv,s,d,causal,window", FLASH_CASES)
def test_flash_plain_matches_reference(dtype, b, hq, hkv, s, d, causal,
                                       window):
    (jq, jk, jv), (q, k, v) = _both(
        _normal(s + d, (b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d)), dtype)
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert got.dtype == q.dtype and got.shape == q.shape
    tol = 2e-5 if dtype == "float32" else 2e-2
    _close(got, jref.attention_ref(jq, jk, jv, causal=causal, window=window),
           tol)
    if causal or s % 128 == 0:  # the Pallas wrapper needs aligned S then
        _close(got, jops.flash_attention(jq, jk, jv, causal=causal,
                                         window=window), tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,hkv,group,s,d,cur", DECODE_CASES)
def test_decode_plain_matches_reference(dtype, b, hkv, group, s, d, cur):
    (jq, jk, jv), (q, k, v) = _both(
        _normal(s + d, (b, hkv, group, d), (b, hkv, s, d), (b, hkv, s, d)),
        dtype)
    tol = 3e-5 if dtype == "float32" else 2e-2
    got = ops.decode_attention(q, k, v, torch.tensor(cur, dtype=torch.int32))
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, jref.decode_attention_ref(jq, jk, jv, cur), tol)
    _close(got, jops.decode_attention(jq, jk, jv, cur, bkv=256), tol)


def test_decode_with_no_live_key_is_uniform():
    """cur_len 0 masks every key: the weights are uniform, as in the
    reference's softmax over -1e30 scores."""
    (jq, jk, jv), (q, k, v) = _both(
        _normal(3, (1, 2, 2, 16), (1, 2, 40, 16), (1, 2, 40, 16)), "float32")
    got = ops.decode_attention(q, k, v, torch.tensor(0, dtype=torch.int32))
    _close(got, jref.decode_attention_ref(jq, jk, jv, 0), 3e-5)
    _close(got, v.mean(dim=2, keepdim=True).expand_as(got), 3e-5)


def test_wrappers_refuse_bad_arguments():
    q, k = torch.zeros(1, 4, 32, 16), torch.zeros(1, 2, 32, 16)
    with pytest.raises(TypeError, match="dtype"):
        ops.flash_attention(q, k.double(), k)
    with pytest.raises(TypeError, match="dtype"):
        ops.flash_attention(q.half(), k.half(), k.half())
    with pytest.raises(ValueError, match="multiple of Hkv"):
        ops.flash_attention(torch.zeros(1, 3, 32, 16), k, k)
    with pytest.raises(ValueError, match="multiple of 8"):
        ops.flash_attention(q[..., :12].contiguous(),
                            k[..., :12].contiguous(),
                            k[..., :12].contiguous())
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(q, k, k, window=0)
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                            k, k)
    with pytest.raises(ValueError, match="length"):
        ops.flash_attention(q, k[:, :, :16].contiguous(),
                            k[:, :, :16].contiguous())
    for cur_len in (torch.tensor(3, dtype=torch.int64), 3):
        with pytest.raises(TypeError, match="cur_len"):
            ops.decode_attention(q[:, :2, :2].contiguous(), k, k, cur_len)
    with pytest.raises(ValueError, match="group"):
        ops.decode_attention(torch.zeros(1, 2, 17, 256), torch.zeros(
            1, 2, 8, 256), torch.zeros(1, 2, 8, 256),
            torch.tensor(3, dtype=torch.int32))
    with pytest.raises(RuntimeError, match="no kernel"):
        ops.flash_attention(q.to("meta"), k.to("meta"), k.to("meta"))


def _cfg():
    return (jreduced("stablelm-1.6b", n_kv_heads=2, dtype="float32"),
            get_reduced_config("stablelm-1.6b", n_kv_heads=2,
                               dtype="float32"))


def _gqa_params(jcfg, seed):
    specs = jattn.gqa_specs(jcfg, None)
    rng = np.random.default_rng(seed)
    return {n: (rng.standard_normal(sp.shape) / np.sqrt(sp.shape[0])
                ).astype(np.float32) for n, sp in specs.items()}


@pytest.mark.parametrize("causal,window", [
    (True, None), (True, 8), (False, None), (False, 8)])
def test_gqa_apply_matches_reference(causal, window):
    """The block's prefill path: the flash kernel's plain version where
    the reference runs its jnp chunked attention under its mask predicate
    (S 40 is not a multiple of the reference's 32-row blocks)."""
    jcfg, tcfg = _cfg()
    p = _gqa_params(jcfg, 5)
    (x,) = _normal(6, (2, 40, jcfg.d_model))
    pos = np.broadcast_to(np.arange(40), (2, 40))
    jmask = jattn.make_mask_fn(causal, window, None)
    want, (jk, jv) = jax.jit(lambda p, x: jattn.gqa_apply(
        jcfg, p, x, jnp.asarray(pos), jmask, return_kv=True,
        skip_info=(True, window) if causal else None))(p, x)
    got, (k, v) = tattn.gqa_apply(
        tcfg, {n: torch.from_numpy(w) for n, w in p.items()},
        torch.from_numpy(x), torch.from_numpy(pos.copy()), causal=causal,
        window=window, return_kv=True)
    _close(got, want, 2e-5)
    _close(k, jk, 2e-5)
    _close(v, jv, 2e-5)


@pytest.mark.parametrize("pos", [0, 29, 47])
def test_gqa_decode_matches_reference(pos):
    """One decode step at position ``pos`` of a 48-row cache (the first
    row, the middle, the last): the in-place cache write and the decode
    kernel's plain version, against the reference's new buffers."""
    jcfg, tcfg = _cfg()
    p = _gqa_params(jcfg, 7)
    (x, kc, vc) = _normal(8, (2, 1, jcfg.d_model), (2, 2, 48, 16),
                          (2, 2, 48, 16))
    jmask = jattn.make_mask_fn(True, None, None)
    want, jc = jax.jit(lambda p, x, c: jattn.gqa_decode(jcfg, p, x, c,
                                                        jmask))(
        p, x, {"k": kc, "v": vc, "len": jnp.int32(pos)})
    cache = {"k": torch.from_numpy(kc.copy()), "v": torch.from_numpy(
        vc.copy()), "len": torch.tensor(pos, dtype=torch.int32)}
    k_buf = cache["k"]
    got, tc = tattn.gqa_decode(
        tcfg, {n: torch.from_numpy(w) for n, w in p.items()},
        torch.from_numpy(x), cache)
    _close(got, want, 2e-5)
    _close(tc["k"], jc["k"], 2e-5)
    _close(tc["v"], jc["v"], 2e-5)
    assert tc["k"] is k_buf and int(tc["len"]) == pos + 1
    assert tc["len"].dtype == torch.int32


def test_masks_without_a_kernel_raise():
    _, tcfg = _cfg()
    with pytest.raises(NotImplementedError, match="prefix-LM"):
        tlm.init_cache(dataclasses.replace(tcfg, vis_prefix_len=2), 1, 8,
                       device="cpu")
    with pytest.raises(NotImplementedError, match="window"):
        tattn.gqa_decode(tcfg, {}, torch.zeros(1, 1, 64), {
            "len": torch.tensor(1, dtype=torch.int32)}, window=8)


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's attention kernels)")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,hq,hkv,s,d,causal,window", FLASH_CASES + [
    (4, 32, 32, 1024, 64, True, None)])
def test_cuda_flash_attention_equals_plain(dtype, b, hq, hkv, s, d, causal,
                                           window):
    _need_cuda()
    _, (q, k, v) = _both(
        _normal(s + d, (b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d)), dtype)
    q, k, v = q.cuda(), k.cuda(), v.cuda()
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    want = attention_ref(q, k, v, causal=causal, window=window)
    tol = 2e-5 if dtype == "float32" else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,hkv,group,s,d,cur", DECODE_CASES + [
    (4, 32, 1, 1089, 64, 1088), (4, 32, 1, 1089, 64, 37)])
def test_cuda_decode_attention_equals_plain(dtype, b, hkv, group, s, d, cur):
    _need_cuda()
    _, (q, k, v) = _both(
        _normal(s + d, (b, hkv, group, d), (b, hkv, s, d), (b, hkv, s, d)),
        dtype)
    q, k, v = q.cuda(), k.cuda(), v.cuda()
    cur_len = torch.tensor(cur, dtype=torch.int32, device="cuda")
    got = ops.decode_attention(q, k, v, cur_len)
    want = decode_attention_ref(q, k, v, cur_len)
    tol = 3e-5 if dtype == "float32" else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
