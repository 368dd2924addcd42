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
import functools
import math

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
from repro_torch.kernels import decode_attention as _da
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
    # any group: 17 query heads of D 256 a kv head are taken
    assert ops.decode_attention(torch.zeros(1, 2, 17, 256), torch.zeros(
        1, 2, 8, 256), torch.zeros(1, 2, 8, 256), torch.tensor(
            3, dtype=torch.int32)).shape == (1, 2, 17, 256)
    # meta tensors (the dry run's) take the meta branch after the same
    # checks: an empty output, no launch
    before = dict(ops.launches)
    out = ops.flash_attention(q.to("meta"), k.to("meta"), k.to("meta"))
    assert out.device.type == "meta" and out.shape == q.shape
    assert ops.launches == before
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(q.to("meta"), k.to("meta"), k.to("meta"),
                            window=0)


def _kv_tile(d):
    """Keys of a kv tile of the bf16 tensor-core flash kernel
    (``csrc/flash_attention.cu``, ``kv_tile``): 128 while D fits two
    64-column panels, else 64."""
    return 128 if -(-d // 64) <= 2 else 64


def _flash_tc_emulation(q, k, v, causal, window):
    """The bf16 tensor-core flash kernel's arithmetic, written out: raw
    scores in float32 from the bf16 inputs, masked (-1e30) where the
    causal or window mask hides a key, an online softmax in log2 units
    over kv tiles of ``_kv_tile(D)`` keys, p rounded to bf16 for p v (the
    denominator sums the unrounded p), float32 accumulation, output
    divided by max(sum, 1e-30) and rounded to bf16."""
    b, hq, s, d = q.shape
    group = hq // k.shape[1]
    qf = q.float()
    kf = k.repeat_interleave(group, dim=1).float()
    vf = v.repeat_interleave(group, dim=1).float()
    c = math.log2(math.e) / math.sqrt(d)
    m = torch.full((b, hq, s), -1e30)
    l = torch.zeros(b, hq, s)
    acc = torch.zeros(b, hq, s, d)
    pos = torch.arange(s)
    for k0 in range(0, s, _kv_tile(d)):
        kp = pos[k0:k0 + _kv_tile(d)]
        raw = qf @ kf[:, :, kp].transpose(-1, -2)
        hide = torch.zeros(s, kp.numel(), dtype=torch.bool)
        if causal:
            hide |= pos[:, None] < kp[None]
        if window is not None:
            hide |= pos[:, None] - kp[None] >= window
        raw = torch.where(hide, torch.tensor(-1e30), raw)
        m_new = torch.maximum(m, raw.amax(-1) * c)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(raw * c - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + p.to(torch.bfloat16).float() @ vf[
            :, :, kp]
        m = m_new
    return (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)


@pytest.mark.parametrize("b,hq,hkv,s,d,causal,window", FLASH_CASES + [
    (1, 8, 2, 256, 120, True, None)])
def test_flash_bf16_p_rounding_fits_the_tolerance(b, hq, hkv, s, d, causal,
                                                  window):
    """The one numeric change of the tensor-core kernel (p rounded to bf16
    before p v) stays within the bf16 tolerance of the reference."""
    (jq, jk, jv), (q, k, v) = _both(
        _normal(s + d, (b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d)),
        "bfloat16")
    got = _flash_tc_emulation(q, k, v, causal, window)
    _close(got, jref.attention_ref(jq, jk, jv, causal=causal, window=window),
           2e-2)


def _split_kv_emulation(q, k, v, cur, chunk):
    """The split-KV decode kernel's algebra, written out: each chunk of
    ``chunk`` keys gives a partial (max, sum, accumulator) in log2 units
    over its keys below cur_len (an empty one, max -inf, past it; every
    key masked, -1e30, when cur_len <= 0), and the partials merge with
    weights exp2(max - max of maxes)."""
    d, s = q.shape[-1], k.shape[2]
    c = math.log2(math.e) / math.sqrt(d)
    live = s if cur <= 0 else min(cur, s)
    parts = []
    for c0 in range(0, s, chunk):
        end = min(c0 + chunk, live)
        if end <= c0:
            parts.append(None)
            continue
        x = torch.einsum("bkgd,bksd->bkgs", q * c, k[:, :, c0:end])
        if cur <= 0:
            x = torch.full_like(x, -1e30)
        mx = x.amax(-1)
        p = torch.exp2(x - mx[..., None])
        parts.append((mx, p.sum(-1), p @ v[:, :, c0:end]))
    big = torch.stack([pt[0] for pt in parts if pt is not None]).amax(0)
    den = torch.zeros_like(big)
    num = torch.zeros_like(q)
    for pt in parts:
        if pt is None:
            continue
        w = torch.exp2(pt[0] - big)
        den += pt[1] * w
        num += pt[2] * w[..., None]
    return num / den.clamp_min(1e-30)[..., None]


# cur_len 0 at an S that the Pallas wrapper's 256-key block divides: it
# pads a ragged S with keys that cur_len 0 would also weigh.
SPLIT_CASES = DECODE_CASES + [(1, 2, 3, 256, 32, 0),
                              (1, 1, 48, 256, 128, 256)]


@functools.lru_cache(maxsize=None)
def _decode_reference(case):
    """The reference and the Pallas kernel (interpret mode) on a case's
    float32 inputs, computed once for every chunk size."""
    b, hkv, group, s, d, cur = case
    xs = _normal(s + d, (b, hkv, group, d), (b, hkv, s, d), (b, hkv, s, d))
    (jq, jk, jv), _ = _both(xs, "float32")
    return (xs, np.asarray(jref.decode_attention_ref(jq, jk, jv, cur)),
            np.asarray(jops.decode_attention(jq, jk, jv, cur, bkv=256)))


@pytest.mark.parametrize("chunk", [16, 48, 112, "one"])
@pytest.mark.parametrize("case", SPLIT_CASES)
def test_split_kv_merge_matches_reference(case, chunk):
    """Chunks that do not divide S (48, 112), chunks wholly past cur_len
    (cur 37 and 700), cur_len 0, cur_len = S, and one chunk."""
    xs, want, pallas = _decode_reference(case)
    q, k, v = (torch.from_numpy(x) for x in xs)
    got = _split_kv_emulation(q, k, v, case[-1],
                              k.shape[2] if chunk == "one" else chunk)
    _close(got, want, 3e-5)
    _close(got, pallas, 3e-5)


@pytest.mark.parametrize("b,hkv,group,s,dtype,blocks", [
    (4, 32, 1, 1089, torch.bfloat16, 640),   # the serving shape
    (1, 1, 48, 4096, torch.bfloat16, 192),   # granite-34b MQA
    (1, 1, 48, 4096, torch.float32, 384),
    (2, 4, 1, 300, torch.float32, 24),
    (64, 32, 1, 100, torch.bfloat16, 2048),  # many heads: one split
])
def test_decode_plan_covers_the_cache(b, hkv, group, s, dtype, blocks):
    cut = _da.plan(b, hkv, group, s, dtype, 132)
    assert 1 <= cut.n_split <= _da.MAX_SPLITS and cut.chunk % 16 == 0
    assert (cut.n_split - 1) * cut.chunk < s <= cut.n_split * cut.chunk
    assert cut.n_gt * cut.gt >= group > (cut.n_gt - 1) * cut.gt
    assert cut.blocks(b, hkv) == blocks


def test_decode_takes_any_group():
    """granite-34b's MQA, 48 q heads of D 128 on one kv head (group * D =
    6,144), at a reduced cache: the port equals the JAX wrapper."""
    (jq, jk, jv), (q, k, v) = _both(
        _normal(48, (1, 1, 48, 128), (1, 1, 96, 128), (1, 1, 96, 128)),
        "float32")
    got = ops.decode_attention(q, k, v, torch.tensor(90, dtype=torch.int32))
    _close(got, jops.decode_attention(jq, jk, jv, 90, bkv=32), 3e-5)


def _cfg():
    return (jreduced("stablelm-1.6b", n_kv_heads=2, dtype="float32"),
            get_reduced_config("stablelm-1.6b", n_kv_heads=2,
                               dtype="float32"))


def _gqa_params(jcfg, seed):
    specs = jattn.gqa_specs(jcfg, None)
    rng = np.random.default_rng(seed)
    return {n: (rng.standard_normal(sp.shape) / np.sqrt(sp.shape[0])
                ).astype(np.float32) for n, sp in specs.items()}


def test_decode_scratch_is_per_stream_and_capture_is_refused(monkeypatch):
    """The CUDA wrapper with the launch recorded instead of run: each
    stream gets its own partials and counters (two streams decoding on one
    card never share them), a larger call gets larger ones, and a call
    under CUDA graph capture is refused before anything is made or
    launched."""
    calls = []
    stream = [1]
    capturing = [False]
    monkeypatch.setattr(_da.build, "_scratch", {})
    monkeypatch.setattr(_da.build, "_retired", [])
    monkeypatch.setattr(_da.build, "stream_key", lambda dev: stream[0])
    monkeypatch.setattr(_da.build, "sm_count", lambda dev: 132)
    monkeypatch.setattr(_da.build, "launch", lambda name, argtypes, dev,
                        *args: calls.append(args[5:7]))  # (part, cnt)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing[0])

    def call(s):
        q = torch.zeros(2, 4, 1, 64)
        k = torch.zeros(2, 4, s, 64)
        return _da.decode_attention_cuda(q, k, k, torch.tensor(s // 2))

    call(1024)
    call(1024)
    stream[0] = 2
    call(1024)
    assert calls[0] == calls[1] and calls[2][0] != calls[0][0]
    assert calls[2][1] != calls[0][1]
    call(4096)  # more splits: the partials grow
    assert calls[3][0] != calls[2][0] and len(_da.build._retired) == 1
    capturing[0] = True
    with pytest.raises(RuntimeError, match="CUDA graph"):
        call(1024)
    assert len(calls) == 4


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
    """No mask is left without a kernel path, so none raises: the
    prefix-LM mask (the VLM prefix) goes to the flash kernel with its
    ``prefix_len``, and a window at decode goes to the decode kernel: one
    step at position 40 of a 48-row cache under window 8 equals the
    reference's masked decode."""
    jcfg, tcfg = _cfg()
    cache = tlm.init_cache(dataclasses.replace(tcfg, vis_prefix_len=2), 1,
                           8, device="cpu")
    assert tuple(cache["blocks"]["k"].shape[1:]) == (1, 2, 8, 16)
    from repro_torch.models.model_api import Model
    params = Model.from_config(tcfg).init_params(
        torch.Generator().manual_seed(0), device="cpu")
    seen = []
    real = ops.flash_attention
    try:
        ops.flash_attention = lambda *a, **kw: seen.append(
            kw["prefix_len"]) or real(*a, **kw)
        tlm.prefill(tcfg, params, torch.zeros(1, 6, dtype=torch.int32), 12,
                    extra_embeds=torch.zeros(1, 2, tcfg.d_model))
    finally:
        ops.flash_attention = real
    assert seen == [2] * tcfg.n_layers
    p = _gqa_params(jcfg, 7)
    (x, kc, vc) = _normal(8, (2, 1, jcfg.d_model), (2, 2, 48, 16),
                          (2, 2, 48, 16))
    jmask = jattn.make_mask_fn(True, 8, None)
    want, _ = jax.jit(lambda p, x, c: jattn.gqa_decode(jcfg, p, x, c,
                                                       jmask))(
        p, x, {"k": kc, "v": vc, "len": jnp.int32(40)})
    got, _ = tattn.gqa_decode(
        tcfg, {n: torch.from_numpy(w) for n, w in p.items()},
        torch.from_numpy(x), {"k": torch.from_numpy(kc.copy()),
                              "v": torch.from_numpy(vc.copy()),
                              "len": torch.tensor(40, dtype=torch.int32)},
        window=8)
    _close(got, want, 2e-5)


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's attention kernels)")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,hq,hkv,s,d,causal,window", FLASH_CASES + [
    (4, 32, 32, 1024, 64, True, None), (1, 32, 8, 512, 120, True, None),
    (2, 4, 4, 700, 64, True, 100)])
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
    (4, 32, 1, 1089, 64, 1088), (4, 32, 1, 1089, 64, 37),
    (1, 1, 48, 4096, 128, 4000), (4, 32, 1, 1089, 64, 0)])
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
