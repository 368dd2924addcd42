"""The TCAM searches as CUDA kernels for Hopper.

Counterpart of ``repro/kernels/tcam_match.py``: ``multi_query_match``
(the Pallas kernel ``multi_query_kernel``, ``tcam_match.py:73``) and the
single ternary query ``tcam_match`` (``tcam_match_kernel``, ``:38``).
The kernel sources are ``csrc/multi_query_match.cu`` and
``csrc/tcam_match.cu``, whose headers give their bounds and designs; the
plain versions are :func:`repro_torch.kernels.ref.multi_query_match_ref`
and :func:`repro_torch.kernels.ref.tcam_match_ref`.  Callers go through
:func:`repro_torch.kernels.ops.multi_query_match` and
:func:`repro_torch.kernels.ops.tcam_match`.  The match is one launch:
its blocks add their partial counts into a per-range word of a scratch
buffer kept per device and stream (:func:`repro_torch.kernels.build.scratch`),
and the block completing a range writes its count and puts the word back
to zero, so nothing is zero-filled before a call.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_VP, _LL, _INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int

# launch arguments of csrc/multi_query_match.cu and csrc/tcam_match.cu
_MATCH_ARGS = (_VP, _VP, _LL, _VP, _VP, _INT, _VP, _VP, _VP, _INT)
_TCAM_ARGS = (_VP, _LL, _VP, _VP, _VP)


def multi_query_match_cuda(pq: torch.Tensor, valid: torch.Tensor,
                           lo: torch.Tensor, hi: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on CUDA tensors already checked by the wrapper."""
    n, dev = pq.shape[0], pq.device
    sel = torch.empty(n, dtype=torch.bool, device=dev)
    counts = torch.empty(lo.shape[0], dtype=torch.int32, device=dev)
    scratch = build.scratch("multi_query_match", dev, 128)  # 64 words
    build.launch("multi_query_match", _MATCH_ARGS, dev, pq.data_ptr(),
                 valid.data_ptr(), n, lo.data_ptr(), hi.data_ptr(),
                 lo.shape[0], sel.data_ptr(), counts.data_ptr(),
                 scratch.data_ptr(), build.sm_count(dev))
    return sel, counts


def tcam_match_cuda(pq: torch.Tensor, query: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on CUDA tensors already checked by the wrapper."""
    out = torch.empty(pq.shape[0], dtype=torch.bool, device=pq.device)
    build.launch("tcam_match", _TCAM_ARGS, pq.device, pq.data_ptr(),
                 pq.shape[0], query.data_ptr(), mask.data_ptr(),
                 out.data_ptr())
    return out
