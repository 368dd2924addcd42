"""The whole AMPER-fr draw as a CUDA kernel for Hopper, and its plain version.

Counterpart of ``repro/kernels/amper_sample.py::amper_sample`` (the
Pallas kernel ``amper_sample_kernel``, ``amper_sample.py:103``).  The
kernel source is ``csrc/amper_sample.cu``, whose header gives its bound
and design, including its in-kernel threefry (bit-exact with
:mod:`repro_torch.prng`).  Callers go through
:func:`repro_torch.kernels.ops.amper_sample`.

:func:`amper_sample_ref` is the reference semantics written out: roll
the match by ``-shift``, compact it into a fixed-size CSP, pick from it.
It never uses the rank identity the kernel rests on, so holding the two
against each other checks that identity instead of repeating it.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import prng
from repro_torch.kernels import build
from repro_torch.kernels.ref import multi_query_match_ref, nonzero_static

TILE_ROWS = 1024  # rows per count tile (kTileRows in the source)

_VP, _LL, _INT, _UINT = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                         ctypes.c_uint)


def amper_sample_ref(pq: torch.Tensor, valid: torch.Tensor, lo: torch.Tensor,
                     hi: torch.Tensor, shift: int, key: torch.Tensor, *,
                     batch: int, csp_capacity: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain AMPER-fr draw: ``(idx int32[batch], stats int32[4])``.

    ``stats = [members, members below shift, live rows, truncated CSP
    count]``.  The pick key and the fallback key are ``split(key)``; an
    empty CSP falls back to uniform over the live rows.
    """
    n = pq.shape[0]
    sel, _ = multi_query_match_ref(pq, valid, lo, hi)
    total = sel.sum(dtype=torch.int64)
    s_shift = sel[:shift].sum(dtype=torch.int64)
    live = valid.sum(dtype=torch.int64)
    count = torch.clamp(total, max=csp_capacity)
    rolled = torch.roll(sel, -shift)
    csp = nonzero_static(rolled, csp_capacity)
    csp = torch.where(csp >= 0, (csp + shift) % n, csp)
    k_pick, k_fb = prng.split(key)
    u = prng.bits(k_pick, (batch,), pq.device) % count.clamp(min=1)
    fb = prng.bits(k_fb, (batch,), pq.device) % live.clamp(min=1)
    idx = torch.where(total > 0, csp[u], fb).to(torch.int32)
    stats = torch.stack([total, s_shift, live, count]).to(torch.int32)
    return idx, stats


@functools.cache
def _lib():
    lib = build.load("amper_sample")
    fn = lib.amper_sample_launch
    fn.argtypes = [_VP, _VP, _LL, _VP, _VP, _INT, _LL, _UINT, _UINT, _INT,
                   _INT, _VP, _VP, _VP, _VP]
    fn.restype = _INT
    lib.amper_sample_error.argtypes = [_INT]
    lib.amper_sample_error.restype = ctypes.c_char_p
    return lib


def amper_sample_cuda(pq: torch.Tensor, valid: torch.Tensor, lo: torch.Tensor,
                      hi: torch.Tensor, shift: int, key: torch.Tensor, *,
                      batch: int, csp_capacity: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the three kernels on CUDA tensors checked by the wrapper."""
    lib = _lib()
    n = pq.shape[0]
    dev = pq.device
    nblk = -(-n // TILE_ROWS)
    idx = torch.empty(batch, dtype=torch.int32, device=dev)
    stats = torch.empty(4, dtype=torch.int32, device=dev)
    scratch = torch.empty(4 * nblk + 2 * batch, dtype=torch.int32, device=dev)
    k0, k1 = prng.key_data(key).tolist()
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.amper_sample_launch(
        pq.data_ptr(), valid.data_ptr(), n, lo.data_ptr(), hi.data_ptr(),
        lo.shape[0], shift, k0, k1, batch, csp_capacity, idx.data_ptr(),
        stats.data_ptr(), scratch.data_ptr(), stream)
    if code:
        raise RuntimeError("amper_sample launch failed: "
                           + lib.amper_sample_error(code).decode())
    return idx, stats
