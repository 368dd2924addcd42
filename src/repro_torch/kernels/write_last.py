"""The sharded priority write as a CUDA kernel for Hopper.

It replaces no Pallas kernel: the reference writes its sharded table
with XLA's scatter.  The kernel source is ``csrc/write_last.cu``, whose
header gives its bound and design: one cooperative launch that claims
each row in an open-addressing table of (row, last position) slots,
then lets the row's last writer store every field and empty its slot.
The slots are a scratch buffer per device and stream
(:func:`repro_torch.kernels.build.scratch`), zeroed once and left empty
by every call, so the host counts nothing and a call can be captured in
a CUDA graph once the stream has run one as large.  Callers go through
:func:`repro_torch.kernels.ops.write_last`; the plain version is
:func:`repro_torch.kernels.ref.write_last_ref`.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from repro_torch.kernels import build

MAX_FIELDS = 2  # kMaxFields in the source: fields one call writes
MAX_HELD = 32   # kMaxHeld: shards one call writes

_VP, _LL, _INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_ARGS = (_VP, _INT, _INT, _LL, _INT, _VP, _VP, _VP, _INT, _VP, _VP, _INT,
         _VP, _INT)


def slot_bits(b: int) -> int:
    """log2 of the slots a call of ``b`` positions probes: the least power
    of two at or above 2b."""
    return max(2 * b - 1, 1).bit_length()


def write_last_cuda(idx: torch.Tensor, values: Sequence[torch.Tensor],
                    tables: Sequence[Sequence[torch.Tensor]],
                    shards: Sequence[int], n_local: int) -> None:
    """Launch the kernel on CUDA tensors whose dtypes and shapes the
    wrapper checked, with ``b`` >= 1 and at least one held shard; raises
    ``ValueError`` past the kernel's limits (the one place they are
    checked), before any launch."""
    dev, b = idx.device, idx.shape[0]
    if (len(values) > MAX_FIELDS or len(shards) > MAX_HELD
            or (max(shards) + 1) * n_local >= 2 ** 32 - 1 or b >= 2 ** 30):
        raise ValueError(
            f"write_last: the kernel takes at most {MAX_FIELDS} fields and "
            f"{MAX_HELD} shards with every row below 2^32 - 1, and b < "
            f"2^30; got {len(values)} / {shards} x {n_local} / {b}")
    bits = slot_bits(b)
    slots = build.scratch("write_last", dev, 1 << bits, torch.int64)
    where = torch.empty(b, dtype=torch.int32, device=dev)
    nf, nh = len(values), len(shards)
    ptrs = (_VP * nf)(*(v.data_ptr() for v in values))
    sizes = (_INT * nf)(*(v.element_size() for v in values))
    tabs = (_VP * (nf * nh))(*(t.data_ptr() for f in tables for t in f))
    held = (_INT * nh)(*shards)
    try:
        build.launch("write_last", _ARGS, dev, idx.data_ptr(),
                     int(idx.dtype == torch.int64), b, n_local, nf, ptrs,
                     sizes, tabs, nh, held, slots.data_ptr(), bits,
                     where.data_ptr(), build.sm_count(dev))
    except RuntimeError:
        # whether the kernel ran, and left slots claimed, is unknown: the
        # next call starts on a fresh zeroed scratch
        build.drop_scratch("write_last", dev)
        raise
