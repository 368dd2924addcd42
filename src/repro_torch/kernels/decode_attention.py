"""Single-position (decode) attention over a KV cache as a CUDA kernel
for Hopper.

Counterpart of ``repro/kernels/decode_attention.py`` (the Pallas kernel
``_decode_kernel``, ``decode_attention.py:28``, called through
``decode_attention_fwd`` at ``:61``).  The kernel source is
``csrc/decode_attention.cu``, whose header gives its bound and design;
the plain version is :func:`repro_torch.kernels.ref.decode_attention_ref`.
Callers go through :func:`repro_torch.kernels.ops.decode_attention`,
which checks the arguments.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_VP, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# launch arguments of csrc/decode_attention.cu
_ARGS = (_VP, _VP, _VP, _VP, _VP, _INT, _INT, _INT, _INT, _INT, _FLOAT,
         _INT)


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          cur_len: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on CUDA tensors already checked by the wrapper;
    ``cur_len`` is an int32 scalar on the card, read there."""
    b, hkv, group, d = q.shape
    out = torch.empty_like(q)
    build.launch("decode_attention", _ARGS, q.device, q.data_ptr(),
                 k.data_ptr(), v.data_ptr(), cur_len.data_ptr(),
                 out.data_ptr(), b, hkv, group, k.shape[2], d,
                 1.0 / d ** 0.5, int(q.dtype == torch.bfloat16))
    return out
