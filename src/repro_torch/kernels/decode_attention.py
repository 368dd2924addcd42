"""Single-position (decode) attention over a KV cache as a CUDA kernel
for Hopper.

Counterpart of ``repro/kernels/decode_attention.py`` (the Pallas kernel
``_decode_kernel``, ``decode_attention.py:28``, called through
``decode_attention_fwd`` at ``:61``).  The kernel source is
``csrc/decode_attention.cu``, whose header gives its bound and design;
the plain version is :func:`repro_torch.kernels.ref.decode_attention_ref`.
Callers go through :func:`repro_torch.kernels.ops.decode_attention`,
which checks the arguments.  The kernel is split-KV in one launch:
:func:`plan` cuts the keys into chunks on the host, each block writes a
partial softmax state to a scratch buffer kept per device and stream
(:func:`repro_torch.kernels.build.scratch`), and the last block of each
kv head merges them.  A sliding window's lower bound is computed on the
card from ``cur_len``; the split count stays a function of S and the
shapes.  A call is refused under CUDA graph capture: a
larger call would replace the buffers a captured one points at.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import build

_VP, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# launch arguments of csrc/decode_attention.cu
_ARGS = (_VP, _VP, _VP, _VP, _VP, _VP, _VP, _INT, _INT, _INT, _INT, _INT,
         _INT, _INT, _INT, _INT, _INT, _FLOAT, _INT)

MIN_CHUNK = 128      # fewest keys a split takes (one block's sweep)
MAX_SPLITS = 64      # the kernel's cap on splits of a call
BLOCKS_PER_SM = 4    # blocks the split count aims at, per SM


class Plan(NamedTuple):
    """How one call is cut: ``gt`` query heads a group tile, ``n_gt``
    tiles per kv head, ``n_split`` chunks of ``chunk`` keys."""
    gt: int
    n_gt: int
    n_split: int
    chunk: int

    def blocks(self, b: int, hkv: int) -> int:
        return self.n_split * hkv * self.n_gt * b


def plan(b: int, hkv: int, group: int, s: int, dtype: torch.dtype,
         sms: int) -> Plan:
    """The split-KV cut of a call, from the shapes and the card's SM count
    alone (never from ``cur_len``): group tiles of up to 8 query heads (4
    in float32), and enough splits for about ``BLOCKS_PER_SM`` blocks an
    SM, at most ``MAX_SPLITS`` and no more than S / ``MIN_CHUNK`` rounded
    up; chunks are multiples of 16 keys."""
    gt_max = 8 if dtype == torch.bfloat16 else 4
    gt = min(gt_max, 1 << (group - 1).bit_length())
    n_gt = -(-group // gt)
    want = -(-BLOCKS_PER_SM * sms // (b * hkv * n_gt))
    n_split = max(1, min(-(-s // MIN_CHUNK), want, MAX_SPLITS))
    per_split = -(-s // n_split)
    chunk = -(-per_split // 16) * 16
    return Plan(gt, n_gt, -(-s // chunk), chunk)


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          cur_len: torch.Tensor,
                          window: int | None = None) -> torch.Tensor:
    """Launch the kernel on CUDA tensors already checked by the wrapper;
    ``cur_len`` is an int32 scalar on the card, read there, and the
    kernel takes the window's lower bound ``cur_len - window`` from it.
    The output is [B, Hkv, group, Dv], Dv being v's head dim.  The merge
    counters are zeros when made and the kernel leaves them zero."""
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "decode_attention cannot be captured in a CUDA graph yet: its "
            "scratch is replaced when a call needs more, under a captured "
            "call's feet")
    b, hkv, group, d = q.shape
    s, dv = k.shape[2], v.shape[3]
    cut = plan(b, hkv, group, s, q.dtype, build.sm_count(q.device))
    n_part = b * hkv * group * cut.n_split * (dv + 2) if cut.n_split > 1 else 0
    part = build.scratch("decode_attention.partials", q.device,
                         max(n_part, 1), torch.float32)
    cnt = build.scratch("decode_attention.counters", q.device,
                        b * hkv * cut.n_gt)
    out = q.new_empty((b, hkv, group, dv))
    build.launch("decode_attention", _ARGS, q.device, q.data_ptr(),
                 k.data_ptr(), v.data_ptr(), cur_len.data_ptr(),
                 out.data_ptr(), part.data_ptr(), cnt.data_ptr(), b, hkv,
                 group, s, d, dv, window or 0, cut.n_split, cut.chunk, cut.gt,
                 1.0 / d ** 0.5, int(q.dtype == torch.bfloat16))
    return out
