"""Blockwise (flash) attention forward as a CUDA kernel for Hopper.

Counterpart of ``repro/kernels/flash_attention.py`` (the Pallas kernel
``_flash_fwd_kernel``, ``flash_attention.py:30``, called through
``flash_attention_fwd`` at ``:72``).  The kernel source is
``csrc/flash_attention.cu``, whose header gives its bound and design; the
plain version is :func:`repro_torch.kernels.ref.attention_ref`.  Callers
go through :func:`repro_torch.kernels.ops.flash_attention`, which checks
the arguments.  The launch function picks one of the source's two
kernels by the dtype: bfloat16 runs on the tensor cores (wgmma fed by
TMA), float32 on the SIMT cores.  Both take a value head dim ``Dv`` that
may differ from the query/key one (MLA: 192 and 128), a prefix-LM
length, and keys of another length than the queries when the call is
not causal (cross-attention).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_VP, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# launch arguments of csrc/flash_attention.cu
_ARGS = (_VP, _VP, _VP, _VP, _INT, _INT, _INT, _INT, _INT, _INT, _INT, _INT,
         _INT, _INT, _FLOAT, _INT)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool, window: int | None,
                         prefix_len: int | None = None) -> torch.Tensor:
    """Launch the kernel on CUDA tensors already checked by the wrapper;
    the output is [B, Hq, Sq, Dv], Sq being q's length and Dv v's head
    dim (k and v of length Skv)."""
    b, hq, s, d = q.shape
    dv = v.shape[3]
    out = q.new_empty((b, hq, s, dv))
    build.launch("flash_attention", _ARGS, q.device, q.data_ptr(),
                 k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq,
                 k.shape[1], s, k.shape[2], d, dv, int(causal), window or 0,
                 prefix_len or 0, 1.0 / d ** 0.5,
                 int(q.dtype == torch.bfloat16))
    return out
