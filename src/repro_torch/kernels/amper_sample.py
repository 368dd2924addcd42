"""The whole AMPER-fr draw and the rank select as CUDA kernels for Hopper.

Counterpart of ``repro/kernels/amper_sample.py``: ``amper_sample`` (the
Pallas kernel ``amper_sample_kernel``, ``amper_sample.py:103``) and
``rank_select`` (``rank_select_kernel``, ``:276``).  The kernel sources
are ``csrc/amper_sample.cu`` and ``csrc/rank_select.cu``, whose headers
give their bounds and designs; both are one launch built from
``csrc/onepass.cuh`` (1024-row tiles read once, membership kept as bit
words in shared memory, a decoupled look-back for the tiles' member
prefixes).  The draw is one cooperative launch, every block resident, so
that each can wait for the table's total: block b takes tiles b, b + G,
..., the tile holding ``shift`` publishes the members below it, an
in-kernel threefry (bit-exact with :mod:`repro_torch.prng`) draws the
ranks, and each block resolves the ranks in its own tiles; its largest
table is :func:`max_rows`.  The rank select takes its tiles from a
ticket.  Both keep their cross-block words in a scratch buffer per
device and stream (:func:`repro_torch.kernels.build.scratch`), zeroed
once: the kernels advance a call epoch there themselves and reset their
tickets and counters, so the host counts nothing and both can be
captured in a CUDA graph once the stream has run them.  The draw takes
``shift`` and the key as launch arguments or, for a capture, from
device tensors.  Callers go through
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
import functools

import torch

from repro_torch import prng
from repro_torch.kernels import build
from repro_torch.kernels.ref import multi_query_match_ref, nonzero_static

TILE_ROWS = 1024  # rows per tile of both kernels (kRows in their sources)

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
_SAMPLE_ARGS = (_VP, _VP, _LL, _VP, _VP, _INT, _LL, _VP, _UINT, _UINT, _VP,
                _INT, _INT, _VP, _VP, _VP, _INT, _INT)
_RANK_ARGS = (_VP, _VP, _LL, _VP, _VP, _INT, _VP, _INT, _VP, _VP, _VP, _INT)


def _tiles(n: int) -> int:
    return -(-n // TILE_ROWS)


@functools.cache
def max_rows(device: torch.device) -> int:
    """The largest table ``amper_sample_cuda`` takes on ``device``: the
    rows whose 1024-row tiles fit in the shared memory of one resident
    grid (each tile's bit words stay there for the whole call)."""
    fn = build.symbol("amper_sample", "amper_sample_max_rows", (_INT,), _LL)
    with torch.cuda.device(device):
        rows = fn(build.sm_count(device))
    if rows < 1:
        raise RuntimeError("amper_sample: the kernel's occupancy query failed")
    return rows


def amper_sample_cuda(pq: torch.Tensor, valid: torch.Tensor, lo: torch.Tensor,
                      hi: torch.Tensor, shift, key: torch.Tensor, *,
                      batch: int, csp_capacity: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on CUDA tensors checked by the wrapper.

    ``shift`` and ``key`` are a host int and a host ``(2,)`` key (launch
    arguments), or an int32 0-d and an int64 ``(2,)`` tensor on the card,
    which the kernel reads there.  The host form is refused under CUDA
    graph capture, where a replay would draw again with the captured key;
    a table past :func:`max_rows` is refused too."""
    n, dev = pq.shape[0], pq.device
    on_card = isinstance(shift, torch.Tensor)
    if not on_card and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "amper_sample: a host shift and key would be frozen into the "
            "CUDA graph; pass them as tensors on the card to capture")
    limit = max_rows(dev)
    if n > limit:
        raise ValueError(
            f"amper_sample: n = {n} rows is past the kernel's limit of "
            f"{limit} rows on this card (every 1024-row tile keeps its "
            "bit words in the shared memory of one resident grid)")
    nblk = _tiles(n)
    sc = build.scratch("amper_sample", dev, 64 + 32 * nblk)
    idx = torch.empty(batch, dtype=torch.int32, device=dev)
    stats = torch.empty(4, dtype=torch.int32, device=dev)
    if on_card:
        host = (0, shift.data_ptr(), 0, 0, key.data_ptr())
    else:
        k0, k1 = prng.key_data(key).tolist()
        host = (shift, None, k0, k1, None)
    try:
        build.launch("amper_sample", _SAMPLE_ARGS, dev, pq.data_ptr(),
                     valid.data_ptr(), n, lo.data_ptr(), hi.data_ptr(),
                     lo.shape[0], *host, batch, csp_capacity,
                     idx.data_ptr(), stats.data_ptr(), sc.data_ptr(),
                     (sc.numel() - 64) // 32, build.sm_count(dev))
    except RuntimeError:
        # whether the kernel ran, and left its words, is unknown: the next
        # call starts on a fresh zeroed scratch
        build.drop_scratch("amper_sample", dev)
        raise
    return idx, stats


def rank_select_cuda(pq: torch.Tensor, valid: torch.Tensor, lo: torch.Tensor,
                     hi: torch.Tensor, rank: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on CUDA tensors checked by the wrapper."""
    n, dev = pq.shape[0], pq.device
    nblk = _tiles(n)
    sc = build.scratch("rank_select", dev, 32 * (nblk + 1))
    idx = torch.empty(rank.shape[0], dtype=torch.int32, device=dev)
    count = torch.empty((), dtype=torch.int32, device=dev)
    try:
        build.launch("rank_select", _RANK_ARGS, dev, pq.data_ptr(),
                     valid.data_ptr(), n, lo.data_ptr(), hi.data_ptr(),
                     lo.shape[0], rank.data_ptr(), rank.shape[0],
                     idx.data_ptr(), count.data_ptr(), sc.data_ptr(),
                     sc.numel() // 32 - 1)
    except RuntimeError:
        build.drop_scratch("rank_select", dev)
        raise
    return idx, count
