"""Public wrappers of the port's kernels.

Counterpart of ``repro/kernels/ops.py``.  Each wrapper checks shapes,
dtypes, devices, contiguity and (on CUDA) alignment, then dispatches on where its tensors
lie: on the CPU it runs the kernel's plain PyTorch version, on a CUDA
device it launches the hand-written kernel, and anywhere else it raises.
There is no fallback: a kernel that fails to build or launch raises.

``launches`` counts kernel launches per wrapper (never plain runs), so a
run can show that its path really went through the kernels.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import amper_sample as _as
from repro_torch.kernels import tcam_match as _tm
from repro_torch.kernels.ref import multi_query_match_ref

launches = {"multi_query_match": 0, "amper_sample": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


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
    devices = {t.device for t in (pq, valid, lo, hi)}
    if len(devices) != 1:
        raise ValueError(f"{fn}: tensors on several devices: {devices}")
    if not all(t.is_contiguous() for t in (pq, valid, lo, hi)):
        raise ValueError(f"{fn}: tensors must be contiguous")
    kind = pq.device.type
    if kind not in ("cpu", "cuda"):
        raise RuntimeError(f"{fn}: no kernel for device {pq.device}; "
                           "use CPU tensors for the plain version")
    if kind == "cuda" and (pq.data_ptr() % 16 or valid.data_ptr() % 4):
        raise ValueError(f"{fn}: pq must start on a 16-byte and valid on a "
                         "4-byte boundary (the kernels load 4 rows at once); "
                         "pass a fresh tensor, not an offset view")
    return kind


def multi_query_match(pq: torch.Tensor, valid: torch.Tensor,
                      lo: torch.Tensor, hi: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused m-range AMPER search over a flat table.

    Returns ``(sel bool[n], counts int32[m])``: the OR of the m inclusive
    ranges ANDed with ``valid``, and each range's valid-match count.
    """
    if _check_table("multi_query_match", pq, valid, lo, hi) == "cpu":
        return multi_query_match_ref(pq, valid, lo, hi)
    launches["multi_query_match"] += 1
    return _tm.multi_query_match_cuda(pq, valid, lo, hi)


def amper_sample(pq: torch.Tensor, valid: torch.Tensor, lo: torch.Tensor,
                 hi: torch.Tensor, shift: int, key: torch.Tensor, *,
                 batch: int, csp_capacity: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The whole AMPER-fr draw: match, CSP count, pick, rank select.

    Bit-identical to the reference ``_compact`` + ``sample_from_csp``
    pipeline under the same ``(shift, key)``: ``shift`` is the compaction
    rotation (``randint(kroll, (), 0, n)``) and ``key`` the un-split pick
    key (an int64 ``(2,)`` host tensor, see :mod:`repro_torch.prng`).

    Returns ``(idx int32[batch], stats int32[4] = [members, members below
    shift, live rows, truncated CSP count])``.
    """
    kind = _check_table("amper_sample", pq, valid, lo, hi)
    n = pq.shape[0]
    shift = int(shift)
    if not 0 <= shift < n or n >= 2 ** 31:
        raise ValueError(f"amper_sample: need 0 <= shift < n < 2^31, got "
                         f"shift={shift}, n={n}")
    if batch < 1 or csp_capacity < 1:
        raise ValueError(f"amper_sample: batch and csp_capacity must be "
                         f">= 1, got {batch} / {csp_capacity}")
    if tuple(key.shape) != (2,) or key.device.type != "cpu":
        raise ValueError("amper_sample: key must be a (2,) host key")
    if kind == "cpu":
        return _as.amper_sample_ref(pq, valid, lo, hi, shift, key,
                                    batch=batch, csp_capacity=csp_capacity)
    launches["amper_sample"] += 1
    return _as.amper_sample_cuda(pq, valid, lo, hi, shift, key, batch=batch,
                                 csp_capacity=csp_capacity)
