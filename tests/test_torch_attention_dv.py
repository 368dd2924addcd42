"""The attention kernels' new arguments against the JAX reference: a
value head dim Dv that differs from the query/key one (MLA: D 192, Dv
128; reduced, 24 and 16) in both kernels, and a sliding window at
decode.

Inputs come from numpy seeds and go to both packages.  The port's plain
versions (the CPU path of ``ops.flash_attention`` and
``ops.decode_attention``) are held against the reference's jnp
attention, which takes Dv: ``repro.kernels.ref.attention_ref`` and the
model's ``decode_attention`` under its mask predicate
(``make_mask_fn(True, window, None)``).  The Pallas kernels take one D,
so they are not the oracle here.  Tolerances are the reference's kernel
tolerances (``tests/test_kernels.py``): float32 2e-5 (flash) and 3e-5
(decode), bfloat16 2e-2, atol and rtol.  The emulations write out the
CUDA kernels' algebra at these shapes (the tensor-core kernel's v
panels and kv tile, the split-KV decode's window bound), on the CPU;
the ``cuda``-marked tests hold the kernels themselves on a card.
"""
import math

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import ops
from repro_torch.kernels.ref import attention_ref, decode_attention_ref
from test_torch_attention import DTYPES, _both, _close, _need_cuda, _normal

# (b, hq, hkv, s, d, dv, causal, window)
FLASH_DV = [
    (2, 4, 4, 40, 24, 16, True, None),     # reduced MLA
    (1, 4, 4, 96, 192, 128, True, None),   # MLA's head dims
    (2, 4, 2, 70, 120, 64, True, 32),      # GQA, ragged D, a window
    (1, 2, 1, 33, 64, 128, False, None),   # Dv > D, bidirectional
]
# (b, hkv, group, s, d, dv, cur_len, window)
DECODE_DV = [
    (2, 4, 1, 48, 24, 16, 41, None),        # reduced MLA decode
    (1, 4, 1, 300, 192, 128, 271, None),    # MLA's head dims
    (2, 2, 4, 300, 120, 120, 290, 64),      # h2o's GQA, window < cur_len
    (1, 2, 2, 128, 32, 16, 100, 100),       # window = cur_len: all live
    (1, 2, 2, 128, 32, 32, 40, 1),          # window 1: the last key only
    (2, 1, 3, 256, 64, 64, 0, 16),          # no live key: uniform
]


@pytest.fixture(autouse=True)
def partitionable():
    with jax.threefry_partitionable(True):
        yield


def _jdecode(jq, jk, jv, cur, window):
    """The reference model's decode attention (q as [B, Hq, 1, D])."""
    b, hkv, g, d = jq.shape
    out = jattn.decode_attention(jq.reshape(b, hkv * g, 1, d), jk, jv,
                                 jnp.int32(cur),
                                 jattn.make_mask_fn(True, window, None))
    return out.reshape(b, hkv, g, jv.shape[-1])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,hq,hkv,s,d,dv,causal,window", FLASH_DV)
def test_flash_plain_with_dv_matches_reference(dtype, b, hq, hkv, s, d, dv,
                                               causal, window):
    (jq, jk, jv), (q, k, v) = _both(
        _normal(s + d + dv, (b, hq, s, d), (b, hkv, s, d), (b, hkv, s, dv)),
        dtype)
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert got.dtype == q.dtype and got.shape == (b, hq, s, dv)
    tol = 2e-5 if dtype == "float32" else 2e-2
    _close(got, jref.attention_ref(jq, jk, jv, causal=causal, window=window),
           tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,hkv,g,s,d,dv,cur,window", DECODE_DV)
def test_decode_plain_with_window_and_dv_matches_reference(
        dtype, b, hkv, g, s, d, dv, cur, window):
    (jq, jk, jv), (q, k, v) = _both(
        _normal(s + d + cur, (b, hkv, g, d), (b, hkv, s, d),
                (b, hkv, s, dv)), dtype)
    got = ops.decode_attention(q, k, v, torch.tensor(cur, dtype=torch.int32),
                               window=window)
    assert got.dtype == q.dtype and got.shape == (b, hkv, g, dv)
    tol = 3e-5 if dtype == "float32" else 2e-2
    _close(got, _jdecode(jq, jk, jv, cur, window), tol)


def test_decode_window_leaves_out_exactly_the_keys_below_the_bound():
    """Keys below cur_len - window weigh exactly 0: changing them changes
    nothing, while changing the lowest live key does."""
    (q, k, v) = (torch.from_numpy(x) for x in _normal(
        5, (1, 2, 2, 16), (1, 2, 64, 16), (1, 2, 64, 8)))
    cur = torch.tensor(50, dtype=torch.int32)
    base = decode_attention_ref(q, k, v, cur, 20)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, :30] = 100.0
    v2[:, :, :30] = -100.0
    assert torch.equal(decode_attention_ref(q, k2, v2, cur, 20), base)
    v2[:, :, 30] += 1.0
    assert not torch.allclose(decode_attention_ref(q, k2, v2, cur, 20), base)


def test_wrappers_take_dv_and_refuse_bad_ones():
    q, k = torch.zeros(1, 4, 32, 24), torch.zeros(1, 2, 32, 24)
    assert ops.flash_attention(q, k, torch.zeros(1, 2, 32, 16)).shape == (
        1, 4, 32, 16)
    with pytest.raises(ValueError, match="value head dim"):
        ops.flash_attention(q, k, torch.zeros(1, 2, 32, 12))
    with pytest.raises(ValueError, match="value head dim"):
        ops.flash_attention(q, k, torch.zeros(1, 2, 32, 264))
    with pytest.raises(ValueError, match="length"):
        ops.flash_attention(q, k, torch.zeros(1, 2, 31, 16))
    cur = torch.tensor(3, dtype=torch.int32)
    qd = torch.zeros(1, 2, 2, 24)
    assert ops.decode_attention(qd, k, torch.zeros(1, 2, 32, 8),
                                cur).shape == (1, 2, 2, 8)
    with pytest.raises(ValueError, match="window"):
        ops.decode_attention(qd, k, k, cur, window=0)
    with pytest.raises(ValueError, match="kv heads"):
        ops.decode_attention(qd, torch.zeros(1, 1, 32, 24),
                             torch.zeros(1, 1, 32, 24), cur)


def _tc_pair(d, dv):
    """Whether the tensor-core kernel is built for D and Dv: Dv's
    64-column panels number D's or one fewer."""
    panels, v_panels = -(-d // 64), -(-dv // 64)
    return v_panels in (panels, panels - 1)


@pytest.mark.parametrize("dtype,d,dv,launched", [
    ("bfloat16", 192, 128, True), ("bfloat16", 120, 120, True),
    ("bfloat16", 64, 128, False), ("bfloat16", 256, 64, False),
    ("float32", 64, 128, True)])
def test_flash_wrapper_refuses_unbuilt_panel_pairs(monkeypatch, dtype, d, dv,
                                                   launched):
    """On CUDA (the device check and the launch recorded instead of run),
    bfloat16 takes the pairs the tensor-core kernel is built for and
    raises on the others before a launch; float32 (the SIMT kernel) takes
    any Dv."""
    calls = []
    monkeypatch.setattr(ops, "_check_attention", lambda fn, q, k, v: "cuda")
    monkeypatch.setattr(ops._fa, "flash_attention_cuda",
                        lambda q, k, v, causal, window, prefix_len=None:
                        calls.append(v.shape[3]) or q)
    monkeypatch.setattr(ops, "_launched", lambda name: None)
    dt = getattr(torch, dtype)
    q, k = torch.zeros(1, 2, 8, d, dtype=dt), torch.zeros(1, 2, 8, d, dtype=dt)
    v = torch.zeros(1, 2, 8, dv, dtype=dt)
    if launched:
        ops.flash_attention(q, k, v)
        assert calls == [dv]
    else:
        with pytest.raises(ValueError, match="panels"):
            ops.flash_attention(q, k, v)
        assert calls == []


def _kv_tile(d, dv):
    """Keys of a kv tile of the tensor-core flash kernel
    (``csrc/flash_attention.cu``, ``kv_tile``), from the wider of D's and
    Dv's 64-column panel counts: 128 up to 2 panels, 64 at 3, 32 at 4."""
    panels = max(-(-d // 64), -(-dv // 64))
    return 128 if panels <= 2 else 64 if panels == 3 else 32


def _flash_tc_emulation(q, k, v, causal, window):
    """The bf16 tensor-core kernel's arithmetic with Dv: raw float32
    scores over D, masked (-1e30), an online softmax in log2 units over
    kv tiles of ``_kv_tile(D, Dv)`` keys, p rounded to bf16 for p v over
    Dv, float32 accumulation, the output divided by max(sum, 1e-30)."""
    b, hq, s, d = q.shape
    dv = v.shape[-1]
    group = hq // k.shape[1]
    kf = k.repeat_interleave(group, dim=1).float()
    vf = v.repeat_interleave(group, dim=1).float()
    c = math.log2(math.e) / math.sqrt(d)
    m = torch.full((b, hq, s), -1e30)
    l = torch.zeros(b, hq, s)
    acc = torch.zeros(b, hq, s, dv)
    pos = torch.arange(s)
    tile = _kv_tile(d, dv)
    for k0 in range(0, s, tile):
        kp = pos[k0:k0 + tile]
        raw = q.float() @ kf[:, :, kp].transpose(-1, -2)
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


@pytest.mark.parametrize("b,hq,hkv,s,d,dv,causal,window", FLASH_DV)
def test_flash_tc_with_dv_fits_the_tolerance(b, hq, hkv, s, d, dv, causal,
                                             window):
    """The tensor-core kernel's one numeric change (p rounded to bf16)
    with v in its own panels stays within the bf16 tolerance."""
    (jq, jk, jv), (q, k, v) = _both(
        _normal(s + d + dv, (b, hq, s, d), (b, hkv, s, d), (b, hkv, s, dv)),
        "bfloat16")
    _close(_flash_tc_emulation(q, k, v, causal, window),
           jref.attention_ref(jq, jk, jv, causal=causal, window=window),
           2e-2)


def _split_kv_window_emulation(q, k, v, cur, window, chunk, step_keys=32):
    """The split-KV decode kernel's algebra with a window and Dv: each
    chunk of ``chunk`` keys sweeps from the step (``step_keys`` keys)
    that holds the bound lo = max(0, cur - window) and takes the keys in
    [max(c0, lo), min(c0 + chunk, cur_len)); a chunk with none writes an
    empty partial (max -inf); the partials merge with weights exp2(max -
    max of maxes).  cur_len <= 0: every key of S, scored -1e30."""
    d, s = q.shape[-1], k.shape[2]
    c = math.log2(math.e) / math.sqrt(d)
    none_live = cur <= 0
    live = s if none_live else min(cur, s)
    lo = max(0, cur - window) if window and not none_live else 0
    parts = []
    for c0 in range(0, s, chunk):
        end = min(c0 + chunk, live)
        t0 = (lo - c0) // step_keys if lo > c0 else 0
        first = max(c0 + t0 * step_keys, lo)
        if end <= max(c0, lo):
            parts.append(None)
            continue
        assert c0 + t0 * step_keys <= max(c0, lo)  # the bound's step
        x = torch.einsum("bkgd,bksd->bkgs", q * c, k[:, :, first:end])
        if none_live:
            x = torch.full_like(x, -1e30)
        mx = x.amax(-1)
        p = torch.exp2(x - mx[..., None])
        parts.append((mx, p.sum(-1), p @ v[:, :, first:end]))
    big = torch.stack([pt[0] for pt in parts if pt is not None]).amax(0)
    den = torch.zeros_like(big)
    num = torch.zeros(*q.shape[:-1], v.shape[-1])
    for pt in parts:
        if pt is not None:
            w = torch.exp2(pt[0] - big)
            den += pt[1] * w
            num += pt[2] * w[..., None]
    return num / den.clamp_min(1e-30)[..., None]


@pytest.mark.parametrize("chunk", [16, 48, 112, "one"])
@pytest.mark.parametrize("case", DECODE_DV)
def test_split_kv_window_merge_matches_reference(case, chunk):
    """Chunks wholly below the window's bound, chunks the bound crosses
    (mid-step included), chunks past cur_len, and one chunk."""
    b, hkv, g, s, d, dv, cur, window = case
    (jq, jk, jv), (q, k, v) = _both(
        _normal(s + d + cur, (b, hkv, g, d), (b, hkv, s, d),
                (b, hkv, s, dv)), "float32")
    got = _split_kv_window_emulation(q, k, v, cur, window,
                                     s if chunk == "one" else chunk)
    _close(got, _jdecode(jq, jk, jv, cur, window), 3e-5)


def test_decode_launch_passes_dv_and_window(monkeypatch):
    """The CUDA wrapper, its launch recorded instead of run: the value
    head dim and the window reach the kernel, the partials are sized by
    Dv, and the output is [B, Hkv, group, Dv]; no window passes 0."""
    calls = []
    monkeypatch.setattr(_da.build, "_scratch", {})
    monkeypatch.setattr(_da.build, "_retired", [])
    monkeypatch.setattr(_da.build, "stream_key", lambda dev: 1)
    monkeypatch.setattr(_da.build, "sm_count", lambda dev: 132)
    monkeypatch.setattr(_da.build, "launch", lambda name, argtypes, dev,
                        *args: calls.append((len(argtypes), args)))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    q, k, v = torch.zeros(2, 4, 1, 192), torch.zeros(2, 4, 300, 192), \
        torch.zeros(2, 4, 300, 128)
    out = _da.decode_attention_cuda(q, k, v, torch.tensor(271), 4096)
    assert out.shape == (2, 4, 1, 128)
    n_args, args = calls[-1]
    assert n_args == len(args) == 19
    assert args[7:14] == (2, 4, 1, 300, 192, 128, 4096)
    cut = _da.plan(2, 4, 1, 300, torch.float32, 132)
    assert args[14:17] == (cut.n_split, cut.chunk, cut.gt)
    part = _da.build._scratch
    assert max(t.numel() for t in part.values()) >= (
        2 * 4 * 1 * cut.n_split * (128 + 2))
    _da.decode_attention_cuda(q, k, v, torch.tensor(271))
    assert calls[-1][1][13] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,hq,hkv,s,d,dv,causal,window", FLASH_DV + [
    (2, 32, 8, 700, 120, 120, True, 512),
    (4, 16, 16, 256, 192, 128, True, None)])
def test_cuda_flash_attention_with_dv_equals_plain(dtype, b, hq, hkv, s, d,
                                                   dv, causal, window):
    _need_cuda()
    _, (q, k, v) = _both(
        _normal(s + d, (b, hq, s, d), (b, hkv, s, d), (b, hkv, s, dv)),
        dtype)
    q, k, v = q.cuda(), k.cuda(), v.cuda()
    if dtype == "bfloat16" and not _tc_pair(d, dv):
        with pytest.raises(ValueError, match="panels"):
            ops.flash_attention(q, k, v, causal=causal, window=window)
        return
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    want = attention_ref(q, k, v, causal=causal, window=window)
    tol = 2e-5 if dtype == "float32" else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,hkv,g,s,d,dv,cur,window", DECODE_DV + [
    (2, 8, 4, 4193, 120, 120, 4190, 4096)])
def test_cuda_decode_attention_with_window_and_dv_equals_plain(
        dtype, b, hkv, g, s, d, dv, cur, window):
    _need_cuda()
    _, (q, k, v) = _both(
        _normal(s + d, (b, hkv, g, d), (b, hkv, s, d), (b, hkv, s, dv)),
        dtype)
    q, k, v = q.cuda(), k.cuda(), v.cuda()
    cur_len = torch.tensor(cur, dtype=torch.int32, device="cuda")
    got = ops.decode_attention(q, k, v, cur_len, window=window)
    want = decode_attention_ref(q, k, v, cur_len, window)
    tol = 3e-5 if dtype == "float32" else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_window_ladder_exposes_a_wrong_bound():
    """``chip_smoke.py`` holds the bf16 kernels at atol = rtol = 2e-2,
    about the size of a 4,096-key softmax's outputs over random inputs,
    so with a window it first lays a ladder of scores across the bound
    (``lay_ladder``).  Here the plain version at a window one key wider
    or narrower stands in for a kernel that takes one key below the bound
    or loses the one at it: every laddered row moves past the tolerance,
    while the float32 answer on the same bf16 inputs stays within it."""
    import chip_smoke

    gen = torch.Generator().manual_seed(0)

    def normal(*shape):
        return torch.randn(*shape, generator=gen).to(torch.bfloat16)

    def off(got, want):
        got, want = got.float(), want.float()
        return ((got - want).abs() > 2e-2 + 2e-2 * want.abs()).any(-1)

    # decode: h2o's group and head dim, a window of 400 at cur_len 590
    b, hkv, g, s, d, cur, window = 2, 2, 4, 600, 120, 590, 400
    q, k, v = normal(b, hkv, g, d), normal(b, hkv, s, d), normal(b, hkv, s, d)
    chip_smoke.lay_ladder(q, k, cur - window + 31, 64)
    cur_len = torch.tensor(cur, dtype=torch.int32)
    want = decode_attention_ref(q, k, v, cur_len, window)
    assert not off(decode_attention_ref(q.float(), k.float(), v.float(),
                                        cur_len, window), want).any()
    for wrong in (window + 1, window - 1):
        assert off(decode_attention_ref(q, k, v, cur_len, wrong), want).all()
    # flash: rows r >= window have their bound at r - window + 1
    b, hq, hkv, s, d, window = 1, 4, 2, 300, 120, 256
    q, k, v = normal(b, hq, s, d), normal(b, hkv, s, d), normal(b, hkv, s, d)
    q[:, :, :window, 0] = 0
    chip_smoke.lay_ladder(q[:, :, window:], k, s - window, s - window)
    want = attention_ref(q, k, v, causal=True, window=window)
    assert not off(attention_ref(q.float(), k.float(), v.float(),
                                 causal=True, window=window), want).any()
    for wrong in (window + 1, window - 1):
        got = attention_ref(q, k, v, causal=True, window=wrong)
        assert off(got, want)[:, :, window:].all()
