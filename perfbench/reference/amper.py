"""The AMPER-fr draw and its priority writes, written out plainly.

The semantics of the paper's Algorithm 1 (AMPER-fr) as the program
states them, from the priority table and the PRNG keys alone:

* quantization: float32 priorities in [0, V_max] to int32 fixed point
  with ``frac_bits`` fraction bits, the top code all ones;
* m group representatives ``V_i = V_max i / m + (V_max / m) u_i``, and
  for each an inclusive prefix range around its code, of radius
  ``round(lambda' / m * code)`` widened to the enclosing power-of-two
  block (a TCAM query with don't-care bits);
* the candidate set (CSP): the live rows inside any range.

Two draws read it.  :func:`sharded_draw` is the draw over S equal shards
(each shard's members counted, clamped at its share of the CSP capacity,
each pick owned by one shard and turned into that shard's member of
that rank, in index order).  :func:`table_draw` is the draw of one table
with the CSP compacted from a random rotation.  Neither uses a kernel or
the program's code: membership is a comparison against the merged
ranges, a rank is found by a search in the cumulative member count.

:func:`write_last` is the priority write with duplicates resolved as a
sequential loop would: the last write to a row wins.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import threefry as tf


def quantize(p: torch.Tensor, v_max: float, frac_bits: int) -> torch.Tensor:
    """float32 priorities to int32 codes, half to even."""
    top = (1 << frac_bits) - 1
    q = torch.round(torch.clamp(p.to(torch.float32), 0.0, v_max)
                    * (top / v_max))
    return torch.clamp(q, max=float(top)).to(torch.int32)


def representatives(key, m: int, v_max: float) -> np.ndarray:
    """float32[m]: ``V_max i / m + (V_max / m) u_i`` rounded as one fused
    multiply-add of float32 terms (``i V_max`` times float32 ``1 / m``)."""
    i = np.arange(m, dtype=np.float32)
    lo = (np.float32(v_max) * i) * np.float32(1.0 / m)
    width = np.full(m, v_max / m, dtype=np.float32)
    return tf.fma32(width, tf.uniform(key, (m,)), lo)


def ranges(v_rep: np.ndarray, cfg: dict) -> list[tuple[int, int]]:
    """The m inclusive code ranges ``[q & ~M, (q & ~M) | M]``, where M is
    the mask of the radius's leading one and every bit below it."""
    v_max, bits_ = cfg["v_max"], cfg["frac_bits"]
    code = quantize(torch.from_numpy(v_rep), v_max, bits_)
    radius = torch.round(torch.tensor(cfg["lam_fr"] / cfg["m"],
                                      dtype=torch.float32)
                         * code.to(torch.float32)).to(torch.int64)
    out = []
    for q, r in zip(code.tolist(), radius.tolist()):
        mask = 0 if r <= 0 else (1 << r.bit_length()) - 1
        lo = q & ~mask
        out.append((lo, lo | mask))
    return out


def _merged(rng: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for lo, hi in sorted(rng):
        if out and lo <= out[-1][1] + 1:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [tuple(x) for x in out]


def members(pq: torch.Tensor, valid: torch.Tensor,
            rng: list[tuple[int, int]]) -> torch.Tensor:
    """bool[n]: live rows whose code lies in a range.  The merged ranges'
    bounds, sorted, split the codes into slots; a code is inside iff its
    slot number is odd."""
    edges = []
    for lo, hi in _merged(rng):
        edges += [lo, hi + 1]
    edges_t = torch.tensor(edges, dtype=torch.int32, device=pq.device)
    slot = torch.bucketize(pq, edges_t, right=True)
    return (slot % 2 == 1) & valid


def draw_keys(key):
    """``(kq, kpick, kfb)`` of one sharded draw."""
    kq, kpick = tf.split(key)
    kpick, kfb = tf.split(kpick)
    return kq, kpick, kfb


def sharded_draw(pq: torch.Tensor, valid: torch.Tensor, key, batch: int,
                 cfg: dict, shards: int) -> torch.Tensor:
    """int64[batch] global rows of one sharded AMPER-fr draw over the flat
    table ``pq``/``valid`` split into ``shards`` equal shards."""
    n = pq.shape[0]
    n_local = n // shards
    cap = max(int(n * cfg["csp_ratio"]) // shards, 1)
    kq, kpick, kfb = draw_keys(key)
    rng = ranges(representatives(kq, cfg["m"], cfg["v_max"]), cfg)
    sel = members(pq, valid, rng)
    per_shard = sel.view(shards, n_local).sum(1)
    counts = per_shard.clamp(max=cap)
    total = int(counts.sum())
    if total == 0:  # no candidate: uniform over the whole table
        fb = tf.randint(kfb, (batch,), 0, n)
        return torch.from_numpy(fb).to(pq.device)
    u = torch.from_numpy(tf.randint(kpick, (batch,), 0, total)).to(pq.device)
    cum = torch.cumsum(counts, 0)
    owner = torch.searchsorted(cum, u, right=True)
    offset = u - (cum - counts)[owner]
    # the offset-th member of shard `owner`, in index order
    before = torch.cumsum(per_shard, 0) - per_shard
    rank = before[owner] + offset + 1
    cum_all = torch.cumsum(sel, 0, dtype=torch.int32)
    return torch.searchsorted(cum_all, rank.to(torch.int32))


def table_draw(pq: torch.Tensor, valid: torch.Tensor, key, batch: int,
               cfg: dict, csp_capacity: int) -> torch.Tensor:
    """int64[batch] rows of one AMPER-fr draw of a single table: the CSP
    is the first ``csp_capacity`` members met from a rotation ``shift``
    on, and a pick is uniform over it (over the live rows when empty)."""
    n = pq.shape[0]
    kcsp, kpick = tf.split(key)
    kv, kroll = tf.split(kcsp)
    rng = ranges(representatives(kv, cfg["m"], cfg["v_max"]), cfg)
    shift = int(tf.randint(kroll, (), 0, n))
    sel = members(pq, valid, rng)
    cum = torch.cumsum(sel, 0, dtype=torch.int64)
    total, below = int(cum[-1]), int(cum[shift - 1]) if shift else 0
    k_pick, k_fb = tf.split(kpick)
    if total == 0:
        live = max(int(valid.sum()), 1)
        return torch.from_numpy(tf.bits(k_fb, (batch,)) % live).to(pq.device)
    count = min(total, csp_capacity)
    u = torch.from_numpy(tf.bits(k_pick, (batch,)) % count).to(pq.device)
    # rotated order: the members at or past `shift`, then those below it
    after = total - below
    rank = torch.where(u < after, below + u, u - after)
    return torch.searchsorted(cum, rank + 1)


def write_last(table: torch.Tensor, idx: torch.Tensor,
               values: torch.Tensor) -> None:
    """``table[idx[j]] = values[j]`` for j in order: the last write of a
    row wins."""
    idx = idx.to(torch.int64)
    order = torch.argsort(idx, stable=True)
    s = idx[order]
    last = torch.ones_like(s, dtype=torch.bool)
    last[:-1] = s[1:] != s[:-1]
    table[s[last]] = values[order][last].to(table.dtype)


def write_priorities(pq: torch.Tensor, valid: torch.Tensor, idx, p,
                     cfg: dict) -> None:
    """A priority write of float32 ``p`` at rows ``idx``: the code, and
    the row live iff its priority is above 0."""
    write_last(pq, idx, quantize(p, cfg["v_max"], cfg["frac_bits"]))
    write_last(valid, idx, p > 0)
