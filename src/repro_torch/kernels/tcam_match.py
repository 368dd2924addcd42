"""The m-range TCAM match as a CUDA kernel for Hopper.

Counterpart of ``repro/kernels/tcam_match.py::multi_query_match`` (the
Pallas kernel ``multi_query_kernel``, ``tcam_match.py:73``).  The kernel
source is ``csrc/multi_query_match.cu``, whose header gives its bound and
design; the plain version is :func:`repro_torch.kernels.ref.multi_query_match_ref`.
Callers go through :func:`repro_torch.kernels.ops.multi_query_match`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

_VP, _LL, _INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


@functools.cache
def _lib():
    lib = build.load("multi_query_match")
    fn = lib.multi_query_match_launch
    fn.argtypes = [_VP, _VP, _LL, _VP, _VP, _INT, _VP, _VP, _VP]
    fn.restype = _INT
    lib.multi_query_match_error.argtypes = [_INT]
    lib.multi_query_match_error.restype = ctypes.c_char_p
    return lib


def multi_query_match_cuda(pq: torch.Tensor, valid: torch.Tensor,
                           lo: torch.Tensor, hi: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on CUDA tensors already checked by the wrapper."""
    lib = _lib()
    n = pq.shape[0]
    sel = torch.empty(n, dtype=torch.bool, device=pq.device)
    counts = torch.zeros(lo.shape[0], dtype=torch.int32, device=pq.device)
    stream = torch.cuda.current_stream(pq.device).cuda_stream
    code = lib.multi_query_match_launch(
        pq.data_ptr(), valid.data_ptr(), n, lo.data_ptr(), hi.data_ptr(),
        lo.shape[0], sel.data_ptr(), counts.data_ptr(), stream)
    if code:
        raise RuntimeError("multi_query_match launch failed: "
                           + lib.multi_query_match_error(code).decode())
    return sel, counts
