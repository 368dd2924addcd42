"""The whole AMPER-fr draw and the rank select as CUDA kernels for Hopper.

Counterpart of ``repro/kernels/amper_sample.py``: ``amper_sample`` (the
Pallas kernel ``amper_sample_kernel``, ``amper_sample.py:103``) and
``rank_select`` (``rank_select_kernel``, ``:276``).  The kernel sources
are ``csrc/amper_sample.cu`` and ``csrc/rank_select.cu``, whose headers
give their bounds and designs.  The draw runs the three-launch
rank-select scheme of ``csrc/common.cuh`` and an in-kernel threefry
(bit-exact with :mod:`repro_torch.prng`); the rank select is one launch
(``csrc/onepass.cuh``: decoupled look-back over 1024-row tiles), whose
ticket and status words live in a scratch buffer kept here per device
and stream, set apart from call to call by an epoch and a ticket base
counted on the host.  Callers go through
:func:`repro_torch.kernels.ops.amper_sample` and
:func:`repro_torch.kernels.ops.rank_select`; the plain rank select is
:func:`repro_torch.kernels.ref.rank_select_ref`.

:func:`amper_sample_ref` is the reference semantics written out: roll
the match by ``-shift``, compact it into a fixed-size CSP, pick from it.
It never uses the rank identity the kernel rests on, so holding the two
against each other checks that identity instead of repeating it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import prng
from repro_torch.kernels import build
from repro_torch.kernels.ref import multi_query_match_ref, nonzero_static

TILE_ROWS = 1024  # rows per count tile (kTileRows in common.cuh)
RANK_TILE_ROWS = 1024  # rows per tile of csrc/rank_select.cu (kRows)

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


# launch arguments of csrc/amper_sample.cu and csrc/rank_select.cu
_SAMPLE_ARGS = (_VP, _VP, _LL, _VP, _VP, _INT, _LL, _UINT, _UINT, _INT, _INT,
                _VP, _VP, _VP)
_RANK_ARGS = (_VP, _VP, _LL, _VP, _VP, _INT, _VP, _INT, _VP, _VP, _VP, _UINT,
              _UINT)
EPOCHS = 1 << 30  # the kernel's epochs are 1 .. EPOCHS - 1


class _LookbackScratch:
    """The rank select's scratch on one device and stream: the ticket and
    a status word per tile, zeroed once when made, with the host's count
    of calls (the epoch of the next) and of tickets taken (its ``base``).
    Nothing on the card resets it: each call's epoch and base set its
    words apart from every earlier call's."""

    def __init__(self, device: torch.device, nblk: int):
        # the ticket's 128-byte line, then one line a tile's status word
        self.buf = torch.zeros(32 * (nblk + 1), dtype=torch.int32,
                               device=device)
        self.nblk, self.epoch, self.base = nblk, 0, 0

    def next_call(self, nblk: int) -> tuple[int, int]:
        """The (epoch, base) of a call over nblk tiles."""
        self.epoch += 1
        base, self.base = self.base, (self.base + nblk) % (1 << 32)
        return self.epoch, base


_lookback: dict = {}  # (device, stream) -> _LookbackScratch


def _lookback_key(device: torch.device) -> tuple:
    return device, torch.cuda.current_stream(device).cuda_stream


def _lookback_scratch(device: torch.device, nblk: int) -> _LookbackScratch:
    key = _lookback_key(device)
    sc = _lookback.get(key)
    if sc is None or sc.nblk < nblk or sc.epoch == EPOCHS - 1:
        sc = _lookback[key] = _LookbackScratch(device, nblk)
    return sc


def amper_sample_cuda(pq: torch.Tensor, valid: torch.Tensor, lo: torch.Tensor,
                      hi: torch.Tensor, shift: int, key: torch.Tensor, *,
                      batch: int, csp_capacity: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the three kernels on CUDA tensors checked by the wrapper."""
    n = pq.shape[0]
    dev = pq.device
    nblk = -(-n // TILE_ROWS)
    idx = torch.empty(batch, dtype=torch.int32, device=dev)
    stats = torch.empty(4, dtype=torch.int32, device=dev)
    scratch = torch.empty(4 * nblk + 2 * batch, dtype=torch.int32, device=dev)
    k0, k1 = prng.key_data(key).tolist()
    build.launch("amper_sample", _SAMPLE_ARGS, dev, pq.data_ptr(),
                 valid.data_ptr(), n, lo.data_ptr(), hi.data_ptr(),
                 lo.shape[0], shift, k0, k1, batch, csp_capacity,
                 idx.data_ptr(), stats.data_ptr(), scratch.data_ptr())
    return idx, stats


def rank_select_cuda(pq: torch.Tensor, valid: torch.Tensor, lo: torch.Tensor,
                     hi: torch.Tensor, rank: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on CUDA tensors checked by the wrapper.

    Refuses a stream under CUDA graph capture: a replay would reuse the
    captured epoch and ticket base, which the host no longer counts."""
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("rank_select cannot be captured in a CUDA graph: "
                           "each call takes its epoch and ticket base from "
                           "the host")
    n = pq.shape[0]
    dev = pq.device
    nblk = -(-n // RANK_TILE_ROWS)
    idx = torch.empty(rank.shape[0], dtype=torch.int32, device=dev)
    count = torch.empty((), dtype=torch.int32, device=dev)
    sc = _lookback_scratch(dev, nblk)
    epoch, base = sc.next_call(nblk)
    try:
        build.launch("rank_select", _RANK_ARGS, dev, pq.data_ptr(),
                     valid.data_ptr(), n, lo.data_ptr(), hi.data_ptr(),
                     lo.shape[0], rank.data_ptr(), rank.shape[0],
                     idx.data_ptr(), count.data_ptr(), sc.buf.data_ptr(),
                     epoch, base)
    except RuntimeError:
        # whether the kernel took its tickets is unknown: the next call
        # starts on a fresh zeroed scratch
        _lookback.pop(_lookback_key(dev), None)
        raise
    return idx, count
