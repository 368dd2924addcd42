"""Plain PyTorch versions of the kernels (the correctness contract).

Counterpart of ``repro/kernels/ref.py``.  The CPU path of every kernel
wrapper runs these, and ``chip_smoke.py`` holds each CUDA kernel against
them on the card.
"""
from __future__ import annotations

from typing import Callable

import torch


def nonzero_static(mask: torch.Tensor, size: int, fill: int = -1
                   ) -> torch.Tensor:
    """``jnp.nonzero(mask, size=size, fill_value=fill)`` for a flat mask.

    A cumsum gives each set row its output slot; rows past ``size`` and
    unset rows scatter into distinct discard slots, so no two writes
    collide and the output shape never depends on the data (no host
    sync).  Returns int64[size].
    """
    n = mask.shape[0]
    pos = torch.cumsum(mask, 0, dtype=torch.int64) - 1
    rows = torch.arange(n, device=mask.device)
    target = torch.where(mask & (pos < size), pos, size + rows)
    out = torch.full((size + n,), fill, dtype=torch.int64, device=mask.device)
    return out.scatter_(0, target, rows)[:size]


def multi_query_match_ref(pq: torch.Tensor, valid: torch.Tensor,
                          lo: torch.Tensor, hi: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """OR of the m inclusive ranges ``lo_i <= pq <= hi_i``, AND ``valid``.

    Returns ``(sel bool[n], counts int32[m])``; ``counts[i]`` is the number
    of valid rows in range i.  One range at a time, so no (m, n)
    intermediate exists.
    """
    sel = torch.zeros_like(valid)
    counts = []
    for i in range(lo.shape[0]):
        match = (pq >= lo[i]) & (pq <= hi[i]) & valid
        sel |= match
        counts.append(match.sum(dtype=torch.int32))
    return sel, torch.stack(counts).to(torch.int32)


def rank_select_ref(pq: torch.Tensor, valid: torch.Tensor, lo: torch.Tensor,
                    hi: torch.Tensor, rank: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Flat index of each ``rank``-th member (index order) of the m-range
    match: ``(idx int32[b], count int32)``.

    ``count`` is the number of members; ``idx[j]`` is 0 where
    ``rank[j] < 0`` or ``rank[j] >= count``.  A cumsum of the membership
    and a binary search keep every shape static.
    """
    sel, _ = multi_query_match_ref(pq, valid, lo, hi)
    cum = torch.cumsum(sel, 0, dtype=torch.int64)
    count = cum[-1]
    r = rank.to(torch.int64)
    hit = (r >= 0) & (r < count)
    pos = torch.searchsorted(cum, r.clamp(min=0) + 1)
    idx = torch.where(hit, pos, torch.zeros_like(pos))
    return idx.to(torch.int32), count.to(torch.int32)


def tcam_match_ref(pq: torch.Tensor, query, mask) -> torch.Tensor:
    """One ternary query over the table: ``((pq ^ query) & ~mask) == 0``."""
    return ((pq ^ query) & ~mask) == 0


def make_mask_fn(causal: bool, window, prefix_len) -> Callable:
    """The reference's ``make_mask_fn``: mask_fn(qpos, kpos) -> bool,
    causal ``qpos >= kpos`` and a sliding ``window`` ``qpos - kpos <
    window``, then with a prefix ``P`` every key below P visible (``|
    kpos < P``) and, when causal, no key past ``max(qpos, P - 1)``.
    ``window`` and ``prefix_len`` are None, ints or tensors."""

    def mask_fn(qpos: torch.Tensor, kpos: torch.Tensor) -> torch.Tensor:
        ok = torch.ones(torch.broadcast_shapes(qpos.shape, kpos.shape),
                        dtype=torch.bool, device=qpos.device)
        if causal:
            ok &= qpos >= kpos
        if window is not None:
            ok &= (qpos - kpos) < window
        if prefix_len is not None:
            ok |= kpos < prefix_len  # bidirectional over the prefix
            if causal:
                ok &= kpos <= torch.clamp(qpos, min=prefix_len - 1)
        return ok

    return mask_fn


def attention_mask(sq: int, skv: int, causal: bool, window, prefix_len,
                   device=None) -> torch.Tensor:
    """``make_mask_fn``'s mask over query rows [0, Sq) and keys [0, Skv),
    [Sq, Skv] bool: what the flash kernel lets each row see."""
    qpos = torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(skv, device=device)[None, :]
    return make_mask_fn(causal, window, prefix_len)(qpos, kpos)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int | None = None,
                  prefix_len: int | None = None) -> torch.Tensor:
    """Attention with the softmax written out, in float32; the output is
    in q's dtype.  q [B, Hq, Sq, D], k [B, Hkv, Skv, D], v [B, Hkv, Skv,
    Dv]; each kv head serves ``Hq // Hkv`` consecutive q heads; the
    output is [B, Hq, Sq, Dv].  The mask is ``attention_mask``."""
    d = q.shape[-1]
    group = q.shape[1] // k.shape[1]
    k = k.repeat_interleave(group, dim=1).to(torch.float32)
    v = v.repeat_interleave(group, dim=1).to(torch.float32)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32), k) / (d ** 0.5)
    mask = attention_mask(q.shape[2], k.shape[2], causal, window,
                          prefix_len, q.device)
    s = torch.where(mask, s, torch.tensor(-1e30, device=q.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v).to(q.dtype)


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         cur_len, window: int | None = None) -> torch.Tensor:
    """One query position against a KV cache, in float32; the output is
    in q's dtype.  q [B, Hkv, group, D] (the group query heads of each kv
    head), k [B, Hkv, S, D], v [B, Hkv, S, Dv]; the output is [B, Hkv,
    group, Dv].  Keys at ``cur_len`` (an int or an int32 scalar tensor on
    q's device) and past it are masked, and with a sliding ``window`` the
    keys below ``cur_len - window`` too (the reference's ``qpos - kpos <
    window`` at ``qpos = cur_len - 1``)."""
    d = q.shape[-1]
    s = torch.einsum("bkgd,bksd->bkgs", q.to(torch.float32),
                     k.to(torch.float32)) / (d ** 0.5)
    kpos = torch.arange(k.shape[2], device=q.device)
    live = kpos < cur_len
    if window is not None:
        live &= kpos >= cur_len - window
    s = torch.where(live, s, torch.tensor(-1e30, device=q.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgs,bksd->bkgd", p,
                        v.to(torch.float32)).to(q.dtype)
