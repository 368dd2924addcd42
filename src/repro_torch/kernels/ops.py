"""Public wrappers of the port's kernels.

Counterpart of ``repro/kernels/ops.py``.  Each wrapper checks shapes,
dtypes, devices, contiguity and (on CUDA) alignment, then dispatches on where its tensors
lie: on the CPU it runs the kernel's plain PyTorch version, on a CUDA
device it launches the hand-written kernel, and anywhere else it raises.
There is no fallback: a kernel that fails to build or launch raises.

The two attention wrappers also take ``meta`` tensors, the dry run's
(``launch/dryrun.py``): after the same checks they return an empty
``meta`` tensor of the kernel's output shape, run nothing, count no
launch, and append the call's shapes to the list that
:func:`record_meta_calls` opened, if one is open.

``launches`` counts kernel launches per wrapper (never plain runs, nor
calls that raise), so a run can show that its path really went through
the kernels.  A wrapper called while its stream is captured into a CUDA
graph launches nothing: it adds to ``recorded`` instead, and whoever
replays the graph counts the launches of each replay (``replayed``).
"""
from __future__ import annotations

import contextlib
import threading

import torch

from repro_torch.kernels import amper_sample as _as
from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import prng as _pr
from repro_torch.kernels import tcam_match as _tm
from repro_torch.kernels.ref import (attention_ref, decode_attention_ref,
                                     multi_query_match_ref, rank_select_ref,
                                     tcam_match_ref)

launches = {"multi_query_match": 0, "amper_sample": 0, "rank_select": 0,
            "tcam_match": 0, "flash_attention": 0, "decode_attention": 0,
            "prng": 0}


# launches recorded into CUDA graphs being captured, per wrapper
recorded = dict.fromkeys(launches, 0)


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _launched(name: str) -> None:
    """One launch of ``name``'s kernel, or one recorded into a graph."""
    if (torch.cuda.is_initialized()
            and torch.cuda.is_current_stream_capturing()):
        recorded[name] += 1
    else:
        launches[name] += 1


def replayed(counts: dict) -> None:
    """Count one replay of a graph that holds ``counts`` launches (a
    ``recorded`` difference taken around its capture)."""
    for name, n in counts.items():
        launches[name] += n


_META = threading.local()  # .calls: the list record_meta_calls opened


@contextlib.contextmanager
def record_meta_calls():
    """Collect, in a list it yields, one ``(wrapper name, {argument:
    shape or value})`` entry for each call that reaches an attention
    wrapper's meta branch inside the block (this thread only)."""
    calls: list = []
    prev = getattr(_META, "calls", None)
    _META.calls = calls
    try:
        yield calls
    finally:
        _META.calls = prev


def _meta_call(name: str, out: torch.Tensor, **args) -> torch.Tensor:
    """The meta branch's result: ``out``, with the call recorded."""
    calls = getattr(_META, "calls", None)
    if calls is not None:
        calls.append((name, args))
    return out


def _device_kind(fn: str, tensors, aligned: dict | None = None,
                 meta: bool = False) -> str:
    """Check that ``tensors`` share one device and are contiguous, and (on
    CUDA) that each tensor of ``aligned`` (``{name: (tensor, bytes)}``)
    starts on its boundary; returns the device type, ``"meta"`` only
    where ``meta`` allows it."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{fn}: tensors on several devices: {devices}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{fn}: tensors must be contiguous")
    device = tensors[0].device
    kind = device.type
    if kind not in ("cpu", "cuda") and not (meta and kind == "meta"):
        raise RuntimeError(f"{fn}: no kernel for device {device}; "
                           "use CPU tensors for the plain version")
    for name, (t, align) in (aligned or {}).items():
        if kind == "cuda" and t.data_ptr() % align:
            raise ValueError(f"{fn}: {name} must start on a {align}-byte "
                             "boundary (the kernel loads whole vectors); "
                             "pass a fresh tensor, not an offset view")
    return kind


def _check_table(fn: str, pq, valid, lo, hi) -> str:
    """Validate the (pq, valid, lo, hi) arguments; returns the device type."""
    if pq.dtype != torch.int32 or valid.dtype != torch.bool:
        raise TypeError(f"{fn}: pq must be int32 and valid bool, got "
                        f"{pq.dtype} / {valid.dtype}")
    if lo.dtype != torch.int32 or hi.dtype != torch.int32:
        raise TypeError(f"{fn}: lo/hi must be int32, got {lo.dtype} / {hi.dtype}")
    if pq.ndim != 1 or pq.shape != valid.shape:
        raise ValueError(f"{fn}: pq and valid must be flat and of one length, "
                         f"got {tuple(pq.shape)} / {tuple(valid.shape)}")
    if lo.ndim != 1 or lo.shape != hi.shape or not 1 <= lo.shape[0] <= 64:
        raise ValueError(f"{fn}: lo/hi must be int32[m] with 1 <= m <= 64, "
                         f"got {tuple(lo.shape)} / {tuple(hi.shape)}")
    return _device_kind(fn, (pq, valid, lo, hi),
                        {"pq": (pq, 16), "valid": (valid, 4)})


def multi_query_match(pq: torch.Tensor, valid: torch.Tensor,
                      lo: torch.Tensor, hi: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused m-range AMPER search over a flat table.

    Returns ``(sel bool[n], counts int32[m])``: the OR of the m inclusive
    ranges ANDed with ``valid``, and each range's valid-match count.
    """
    if _check_table("multi_query_match", pq, valid, lo, hi) == "cpu":
        return multi_query_match_ref(pq, valid, lo, hi)
    out = _tm.multi_query_match_cuda(pq, valid, lo, hi)
    _launched("multi_query_match")
    return out


def amper_sample(pq: torch.Tensor, valid: torch.Tensor, lo: torch.Tensor,
                 hi: torch.Tensor, shift, key: torch.Tensor, *,
                 batch: int, csp_capacity: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The whole AMPER-fr draw: match, CSP count, pick, rank select.

    Bit-identical to the reference ``_compact`` + ``sample_from_csp``
    pipeline under the same ``(shift, key)``: ``shift`` is the compaction
    rotation (``randint(kroll, (), 0, n)``) and ``key`` the un-split pick
    key.  Either a host int and a host int64 ``(2,)`` key (see
    :mod:`repro_torch.prng`), which a launch takes as arguments, or an
    int32 0-d tensor and an int64 ``(2,)`` tensor (uint32 words) on the
    table's device, which the kernel reads there: the form a CUDA graph
    captures, and which the wrapper does not range-check on the card
    (that would sync); the kernel counts the members at index < shift.

    Returns ``(idx int32[batch], stats int32[4] = [members, members below
    shift, live rows, truncated CSP count])``.
    """
    kind = _check_table("amper_sample", pq, valid, lo, hi)
    n = pq.shape[0]
    if batch < 1 or csp_capacity < 1 or n >= 2 ** 31:
        raise ValueError(f"amper_sample: batch and csp_capacity must be "
                         f">= 1 and n < 2^31, got {batch} / {csp_capacity} "
                         f"/ {n}")
    if tuple(key.shape) != (2,):
        raise ValueError(f"amper_sample: key must have shape (2,), got "
                         f"{tuple(key.shape)}")
    if isinstance(shift, torch.Tensor):
        if (shift.dtype != torch.int32 or shift.ndim
                or key.dtype != torch.int64):
            raise TypeError(f"amper_sample: a tensor shift must be an int32 "
                            f"scalar and its key int64, got {shift.dtype} "
                            f"{tuple(shift.shape)} / {key.dtype}")
        _device_kind("amper_sample", (pq, shift, key))
        host_shift = int(shift) if kind == "cpu" else None
    else:
        if key.device.type != "cpu":
            raise ValueError("amper_sample: a host shift goes with a host "
                             f"key, got a key on {key.device}")
        host_shift = shift = int(shift)
    if host_shift is not None and not 0 <= host_shift < n:
        raise ValueError(f"amper_sample: need 0 <= shift < n, got "
                         f"shift={host_shift}, n={n}")
    if kind == "cpu":
        return _as.amper_sample_ref(pq, valid, lo, hi, host_shift, key,
                                    batch=batch, csp_capacity=csp_capacity)
    out = _as.amper_sample_cuda(pq, valid, lo, hi, shift, key, batch=batch,
                                csp_capacity=csp_capacity)
    _launched("amper_sample")
    return out


def rank_select(pq: torch.Tensor, valid: torch.Tensor, lo: torch.Tensor,
                hi: torch.Tensor, rank: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Flat index of each ``rank``-th member (index order) of the fused
    m-range match, in one pass: the per-shard pick of the sharded draw.

    ``rank`` is an int32[b] tensor on the table's device.  Returns
    ``(idx int32[b], count int32)``: ``count`` is the (untruncated) member
    count, and ``idx[j]`` is 0 where ``rank[j] < 0`` or ``>= count``
    (callers mask by ownership).
    """
    if rank.dtype != torch.int32 or rank.ndim != 1:
        raise TypeError(f"rank_select: rank must be int32[b], got "
                        f"{rank.dtype} {tuple(rank.shape)}")
    kind = _check_table("rank_select", pq, valid, lo, hi)
    if rank.device != pq.device or not rank.is_contiguous():
        raise ValueError("rank_select: rank must be contiguous and on the "
                         f"table's device {pq.device}, got {rank.device}")
    if not 1 <= pq.shape[0] < 2 ** 31:
        raise ValueError(f"rank_select: need 1 <= n < 2^31 rows, got "
                         f"{pq.shape[0]}")
    if kind == "cpu":
        return rank_select_ref(pq, valid, lo, hi, rank)
    out = _as.rank_select_cuda(pq, valid, lo, hi, rank)
    _launched("rank_select")
    return out


def tcam_match(pq: torch.Tensor, query, mask) -> torch.Tensor:
    """One ternary-CAM query over a flat int32[n] table -> bool[n]:
    ``((pq ^ query) & ~mask) == 0``.

    ``query`` and ``mask`` are ints or int32 scalar tensors on the
    table's device.
    """
    query, mask = (torch.as_tensor(x, dtype=torch.int32, device=pq.device)
                   if not isinstance(x, torch.Tensor) else x
                   for x in (query, mask))
    if pq.dtype != torch.int32 or pq.ndim != 1:
        raise TypeError(f"tcam_match: pq must be int32[n], got {pq.dtype} "
                        f"{tuple(pq.shape)}")
    if (query.dtype != torch.int32 or mask.dtype != torch.int32
            or query.ndim or mask.ndim):
        raise TypeError("tcam_match: query and mask must be int32 scalars")
    if _device_kind("tcam_match", (pq, query, mask),
                    {"pq": (pq, 16)}) == "cpu":
        return tcam_match_ref(pq, query, mask)
    out = _tm.tcam_match_cuda(pq, query, mask)
    _launched("tcam_match")
    return out


def _check_attention(fn: str, q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> str:
    """Validate q, k, v of an attention kernel (one float32 or bfloat16
    dtype, 4-D, k and v of one batch, head count and length, q and k of
    one batch and head dim, each head dim (D of q and k, Dv of v) a
    multiple of 8 up to 256, one device, contiguous, on CUDA 16-byte
    aligned); returns the device type, ``"meta"`` included."""
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            q.dtype == k.dtype == v.dtype):
        raise TypeError(f"{fn}: q, k, v must share one dtype, float32 or "
                        f"bfloat16, got {q.dtype} / {k.dtype} / {v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4 or k.shape[:3] != v.shape[:3]:
        raise ValueError(f"{fn}: need 4-D q, k, v, with k and v of one "
                         f"batch, head count and length, got "
                         f"{tuple(q.shape)} / {tuple(k.shape)} / "
                         f"{tuple(v.shape)}")
    d = q.shape[3]
    if k.shape[0] != q.shape[0] or k.shape[3] != d:
        raise ValueError(f"{fn}: q and k differ in batch or head dim: "
                         f"{tuple(q.shape)} / {tuple(k.shape)}")
    for name, x in (("head dim", d), ("value head dim", v.shape[3])):
        if x % 8 or not 8 <= x <= 256:
            raise ValueError(f"{fn}: {name} must be a multiple of 8 in "
                             f"[8, 256], got {x}")
    return _device_kind(fn, (q, k, v),
                        {"q": (q, 16), "k": (k, 16), "v": (v, 16)},
                        meta=True)


def _check_window(fn: str, window) -> int | None:
    """A window is None or a host int >= 1."""
    if window is not None and int(window) < 1:
        raise ValueError(f"{fn}: window must be >= 1, got {window}")
    return None if window is None else int(window)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    prefix_len: int | None = None) -> torch.Tensor:
    """Blockwise attention forward: q [B, Hq, Sq, D], k [B, Hkv, Skv, D]
    and v [B, Hkv, Skv, Dv] with ``Hq % Hkv == 0`` (q head h reads kv
    head ``h // (Hq // Hkv)``), a causal mask, an optional sliding
    ``window`` (``qpos - kpos < window``) and an optional ``prefix_len``
    P (the prefix-LM mask: keys below P visible to every row, and, when
    causal, rows below P see keys below P only), as
    ``kernels.ref.attention_ref`` masks.  Any lengths; Sq and Skv may
    differ only without the causal mask (cross-attention); the value
    head dim Dv may differ from D (MLA); float32 accumulation; output
    [B, Hq, Sq, Dv] in q's dtype.  In bfloat16 on CUDA, Dv takes as many
    64-column panels as D or one fewer (MLA: D 192, Dv 128), the pairs
    the tensor-core kernel is built for; other pairs raise there.

    A forward only: with grad mode on, inputs that require grad raise on
    either device (the CUDA kernel's output has no ``grad_fn``, so a
    training step routed here would lose every attention weight's
    gradient; ``models.attention.chunked_attention`` is the
    differentiable route).  On ``meta`` tensors the CUDA checks run too
    and nothing else (the module docstring's meta branch)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention: a forward-only kernel got "
                           "inputs that require grad; differentiate "
                           "through models.attention.chunked_attention")
    kind = _check_attention("flash_attention", q, k, v)
    if causal and k.shape[2] != q.shape[2]:
        raise ValueError(f"flash_attention: a causal call needs q and k of "
                         f"one length, got {q.shape[2]} / {k.shape[2]}")
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"flash_attention: Hq = {q.shape[1]} is not a "
                         f"multiple of Hkv = {k.shape[1]}")
    window = _check_window("flash_attention", window)
    if prefix_len is not None and int(prefix_len) < 0:
        raise ValueError(f"flash_attention: prefix_len must be >= 0, got "
                         f"{prefix_len}")
    prefix_len = None if prefix_len is None else int(prefix_len)
    if kind == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             prefix_len=prefix_len)
    panels, v_panels = -(-q.shape[3] // 64), -(-v.shape[3] // 64)
    if q.dtype == torch.bfloat16 and v_panels not in (panels, panels - 1):
        raise ValueError(f"flash_attention: bfloat16 on CUDA takes Dv in "
                         f"as many 64-column panels as D or one fewer, got "
                         f"D {q.shape[3]}, Dv {v.shape[3]}")
    if kind == "meta":
        return _meta_call(
            "flash_attention", q.new_empty(q.shape[:3] + v.shape[3:]),
            q=tuple(q.shape), k=tuple(k.shape), v=tuple(v.shape),
            dtype=q.dtype, causal=causal, window=window,
            prefix_len=prefix_len)
    out = _fa.flash_attention_cuda(q, k, v, causal, window, prefix_len)
    _launched("flash_attention")
    return out


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     cur_len, *, window: int | None = None) -> torch.Tensor:
    """One query position against a KV cache: q [B, Hkv, group, D] (the
    group query heads of each kv head, which share its cache), k
    [B, Hkv, S, D] and v [B, Hkv, S, Dv]; keys at ``cur_len`` and past it
    are masked, and with a sliding ``window`` (a host int, the same for
    every call of a model) the keys below ``cur_len - window`` too.
    ``cur_len`` is an int32 scalar tensor on the cache's device, which
    the kernel reads there (no host sync; the window's bound comes from
    it on the card).  Any group.  Returns [B, Hkv, group, Dv] in q's
    dtype (on ``meta``, an empty one: the module docstring's meta
    branch)."""
    kind = _check_attention("decode_attention", q, k, v)
    if k.shape[1] != q.shape[1]:
        raise ValueError(f"decode_attention: q and k differ in kv heads: "
                         f"{tuple(q.shape)} / {tuple(k.shape)}")
    if (not isinstance(cur_len, torch.Tensor)
            or cur_len.dtype != torch.int32 or cur_len.ndim
            or cur_len.device != q.device):
        got = (f"{cur_len.dtype} {tuple(cur_len.shape)} on {cur_len.device}"
               if isinstance(cur_len, torch.Tensor)
               else type(cur_len).__name__)
        raise TypeError(f"decode_attention: cur_len must be an int32 scalar "
                        f"tensor on {q.device}, got {got}")
    window = _check_window("decode_attention", window)
    if kind == "cpu":
        return decode_attention_ref(q, k, v, cur_len, window)
    if kind == "meta":
        return _meta_call(
            "decode_attention", q.new_empty(q.shape[:3] + v.shape[3:]),
            q=tuple(q.shape), k=tuple(k.shape), v=tuple(v.shape),
            dtype=q.dtype, window=window)
    out = _da.decode_attention_cuda(q, k, v, cur_len, window)
    _launched("decode_attention")
    return out


def _check_key(fn: str, key: torch.Tensor) -> str:
    """Validate a key or batch of keys (int64 ``[..., 2]``); returns the
    device type."""
    if key.dtype != torch.int64 or key.ndim < 1 or key.shape[-1] != 2:
        raise TypeError(f"{fn}: a key is an int64 [..., 2] tensor, got "
                        f"{key.dtype} {tuple(key.shape)}")
    kind = key.device.type
    if kind not in ("cpu", "cuda"):
        raise RuntimeError(f"{fn}: no kernel for device {key.device}")
    return kind


def _prng(fn: str, op: int, key: torch.Tensor, shape: tuple, ref,
          **kw) -> torch.Tensor:
    """Dispatch one PRNG call: the plain version for a key on the CPU,
    one launch of ``csrc/prng.cu`` for a key on CUDA (none for an empty
    output)."""
    if _check_key(fn, key) == "cpu":
        return ref()
    if key.numel() == 0 or 0 in shape:
        return _pr.prng_out(op, key, shape)  # nothing to draw: no launch
    out = _pr.prng_cuda(op, key, shape, **kw)
    _launched("prng")
    return out


def prng_split(key: torch.Tensor, shape: tuple) -> torch.Tensor:
    """``jax.random.split(key, shape)``: int64 keys ``key.shape[:-1] +
    shape + (2,)``."""
    shape = tuple(shape)
    return _prng("prng_split", _pr.CIPHER, key, shape,
                 lambda: _pr.split_ref(key, shape))


def prng_fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for a uint32 ``data``."""
    data = int(data) & _pr.MASK32
    out = _prng("prng_fold_in", _pr.CIPHER, key, (1,),
                lambda: _pr.fold_in_ref(key, data)[..., None, :],
                offset=data)
    return out[..., 0, :]


def prng_bits(key: torch.Tensor, shape: tuple) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as int64 in [0, 2^32)."""
    shape = tuple(shape)
    return _prng("prng_bits", _pr.BITS, key, shape,
                 lambda: _pr.bits_ref(key, shape))


def prng_uniform(key: torch.Tensor, shape: tuple, minval: float = 0.0,
                 maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` for float32 (host bounds)."""
    shape = tuple(shape)
    minval, maxval = float(minval), float(maxval)
    return _prng("prng_uniform", _pr.UNIFORM, key, shape,
                 lambda: _pr.uniform_ref(key, shape, minval, maxval),
                 minval=minval, maxval=maxval)


def prng_randint(key: torch.Tensor, shape: tuple, minval=0,
                 maxval=1) -> torch.Tensor:
    """``jax.random.randint`` for int32.  ``minval`` and ``maxval`` are
    ints, 0-d CPU tensors, or int32 / int64 0-d tensors on the key's
    device, which the kernel reads there (no host sync)."""
    shape = tuple(shape)
    for name, b in (("minval", minval), ("maxval", maxval)):
        if isinstance(b, torch.Tensor) and b.device != key.device and (
                b.device.type != "cpu" or b.ndim):
            raise ValueError(f"prng_randint: {name} on {b.device} for a key "
                             f"on {key.device}")
        if isinstance(b, torch.Tensor) and b.device.type == "cuda" and (
                b.ndim or b.dtype not in (torch.int32, torch.int64)):
            raise TypeError(f"prng_randint: a {name} on the card must be an "
                            f"int32 or int64 scalar, got {b.dtype} "
                            f"{tuple(b.shape)}")
    return _prng("prng_randint", _pr.RANDINT, key, shape,
                 lambda: _pr.randint_ref(key, shape, minval, maxval),
                 minval=minval, maxval=maxval)
