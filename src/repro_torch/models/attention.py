"""Attention blocks: GQA/MQA/MHA (with a sliding window, a prefix-LM
mask, cross-attention) and MLA, in training, prefill and decode.

Counterpart of ``repro/models/attention.py`` (its GQA and MLA blocks and
its differentiable ``chunked_attention``).  ``gqa_apply`` and
``mla_apply`` take one of two routes, chosen by grad mode:

* when autograd records (grad mode on and q, k or v requiring grad: a
  training step), :func:`chunked_attention`, the reference's own jnp
  training attention in plain PyTorch: online softmax over kv blocks,
  each block step checkpointed so that backward recomputes its
  probabilities instead of storing S^2 of them.  No Pallas kernel
  computes it, and the reference has no backward kernel;
* otherwise (prefill, the per-sequence loss of the LM replay),
  :func:`repro_torch.kernels.ops.flash_attention`, the port's CUDA
  kernel, which refuses inputs that require grad.

``gqa_decode`` and ``mla_decode`` call
:func:`repro_torch.kernels.ops.decode_attention` where the reference
calls its jnp ``decode_attention``, with the layer's window (the kernel
takes the window's lower bound from ``cur_len`` on the card).  MLA
caches only the latent ``[c_kv, k_rope]`` (``kv_lora_rank +
qk_rope_dim`` a token) and expands the whole cache through ``wkv_b`` at
every step, as the reference does; its kernels score over ``qk_nope_dim
+ qk_rope_dim`` columns and average ``v_head_dim`` ones (Dv != D).  The
chunked route takes the reference's position predicate
(``make_mask_fn``); the kernels take the mask's static form, so the
blocks take ``causal``, an int ``window`` (``GLOBAL_WINDOW``, a global
layer's, goes to the kernels as no window: it hides no key) and an int
``prefix_len`` (paligemma's patch prefix at prefill: the keys below it
are visible to every row, and rows inside it see only it).
``gqa_apply`` takes ``kv_override`` (whisper's cross-attention: the
encoder's k and v, of another length than q, without a mask) and
``rope=False``.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.sharding import merge_dims, split_dim
from repro_torch.kernels import ops
from repro_torch.kernels.ref import make_mask_fn
from repro_torch.models import common
from repro_torch.models.common import ParamSpec

NEG_INF = -1e30
GLOBAL_WINDOW = 2 ** 30  # "no window" on a global layer of a windowed arch


def kernel_window(window):
    """A layer's window as the kernels take it: None for none, and for
    ``GLOBAL_WINDOW``, which hides no key of any sequence they take."""
    return None if window is None or window >= GLOBAL_WINDOW else window


def head_parallel(fn: Callable, q, k, v, *extra):
    """``fn(q, k, v, *extra)``, or, when q is a DTensor (a program under
    the sharding rules), ``fn`` on each rank's own heads in a
    ``local_map`` region: q, k and v [B, H, S, D] split over the rules'
    "batch" and "heads" axes where they divide (k and v redistributed
    to that split, an all-to-all for a cache whose "kv_seq" the serve
    rules split), each rank runs ``fn`` (the kernel, or the chunked
    route) on its block, and the output [B, Hq, S, Dv] comes back split
    as q.  Where Hkv does not split as Hq does, k and v are replicated
    over the head axes and each rank takes the kv heads of its q heads;
    where that leaves a rank part of a kv head's group, the heads are
    not split.  ``extra`` tensors (``cur_len``) enter replicated."""
    from repro_torch.distributed import sharding as shd

    if not shd.is_dtensor(q):
        return fn(q, k, v, *extra)
    from torch.distributed.tensor import Replicate

    rules = shd.active_rules()
    mesh = q.device_mesh
    Hq, Hkv = q.shape[1], k.shape[1]
    g = Hq // Hkv
    qspec = rules.divisible_spec(("batch", "heads", None, None), q.shape)
    kv_split = qspec[1] is not None and rules.divisible_spec(
        ("batch", "heads", None, None), k.shape)[1] == qspec[1]
    if qspec[1] is not None and not kv_split:
        n = Hq // shd.local_block(mesh, rules.placements(qspec), 1, Hq)[1]
        hl = Hq // n
        if hl % g and g % hl:   # a rank would hold part of two groups
            qspec = (qspec[0], None, None, None)
    q_pl = rules.placements(qspec)
    kv_pl = rules.placements(qspec if kv_split else
                             (qspec[0], None, None, None))

    def local(ql, kl, vl, *ex):
        if qspec[1] is not None and not kv_split:
            off = shd.local_block(mesh, q_pl, 1, Hq)[0]
            lo, hi = off // g, (off + ql.shape[1] - 1) // g + 1
            kl, vl = kl[:, lo:hi].contiguous(), vl[:, lo:hi].contiguous()
        return fn(ql, kl, vl, *ex)

    rep = (Replicate(),) * mesh.ndim
    return shd.region(local, mesh, (q, k, v, *extra),
                      (q_pl, kv_pl, kv_pl) + (rep,) * len(extra), (q_pl,))


def write_at(cache, dim: int, pos: torch.Tensor, new):
    """``cache.index_copy_(dim, [pos], new)`` with ``pos`` an int32 scalar
    on the card (no host sync): one position of a cache written in
    place.  On a DTensor cache split along ``dim`` (the serve rules'
    "kv_seq"), ``new`` is replicated along it and each rank writes the
    position only if its block holds it."""
    from repro_torch.distributed import sharding as shd

    if not shd.is_dtensor(cache):
        return cache.index_copy_(dim, pos.reshape(1).to(torch.int64), new)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh, pl = cache.device_mesh, tuple(cache.placements)
    new_pl = tuple(Replicate() if isinstance(p, Shard) and p.dim == dim
                   else p for p in pl)
    off, size = shd.local_block(mesh, pl, dim, cache.shape[dim])

    def local(c, n, p):
        at = p.reshape(1).to(torch.int64) - off
        inside = ((at >= 0) & (at < size)).reshape((1,) * c.ndim)
        at = at.clamp(0, size - 1)
        return c.index_copy_(dim, at, torch.where(
            inside, n, c.index_select(dim, at)))

    local_map(local, out_placements=(pl,),
              in_placements=(pl, new_pl, (Replicate(),) * mesh.ndim),
              device_mesh=mesh, redistribute_inputs=True)(cache, new, pos)
    return cache


def write_prefix(cache, dim: int, t) -> None:
    """``cache.narrow(dim, 0, S).copy_(t)``, S being t's length along
    ``dim`` (a prefill's keys into its cache).  On a DTensor cache split
    along ``dim``: t redistributed to the cache's split where it fills
    the cache, else replicated along ``dim`` and each rank copies the
    part its block holds."""
    from repro_torch.distributed import sharding as shd

    S = t.shape[dim]
    if not shd.is_dtensor(cache) or S == cache.shape[dim]:
        target = cache if S == cache.shape[dim] else cache.narrow(dim, 0, S)
        shd.copy_into(target, t)
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh, pl = cache.device_mesh, tuple(cache.placements)
    t_pl = tuple(Replicate() if isinstance(p, Shard) and p.dim == dim
                 else p for p in pl)
    off, size = shd.local_block(mesh, pl, dim, cache.shape[dim])
    lo, hi = min(off, S), min(off + size, S)

    def local(c, tl):
        if hi > lo:
            c.narrow(dim, lo - off, hi - lo).copy_(tl.narrow(dim, lo, hi - lo))
        return c

    local_map(local, out_placements=(pl,), in_placements=(pl, t_pl),
              device_mesh=mesh, redistribute_inputs=True)(cache, t)


def records(*tensors) -> bool:
    """True when autograd records an op on ``tensors``: grad mode is on
    and one of them requires grad."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


# ---------------------------------------------------------------------------
# Chunked (memory-efficient, differentiable) attention
# ---------------------------------------------------------------------------

def _kv_step(m_prev, l_prev, acc, qblk, kblk, vblk, mask):
    """One kv block of the online softmax (the reference's ``kv_step``):
    qblk [B, Hkv, g, bq, D] (scaled), kblk [B, Hkv, bkv, D], mask
    [bq, bkv]; the carries in float32."""
    s = torch.einsum("bkgqd,bkud->bkgqu", qblk.float(), kblk.float())
    s = torch.where(mask, s, NEG_INF)
    m_new = torch.maximum(m_prev, s.amax(-1))
    p = torch.exp(s - m_new[..., None])
    alpha = torch.exp(m_prev - m_new)
    l_new = alpha * l_prev + p.sum(-1)
    acc = acc * alpha[..., None] + torch.einsum("bkgqu,bkud->bkgqd", p,
                                                vblk.float())
    return m_new, l_new, acc


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mask_fn: Callable, *, bq: int, bkv: int,
                      q_offset: int = 0,
                      skip_info: Optional[tuple] = None) -> torch.Tensor:
    """Online-softmax attention, differentiable.  q [B, Hq, S, D], k and
    v [B, Hkv, Skv, D / Dv]; output [B, Hq, S, Dv] in q's dtype.

    S and Skv are padded to the blocks ``bq`` and ``bkv``; GQA reshapes q
    into (Hkv, group), so no key or value is broadcast.  When autograd
    records, each kv step is checkpointed (the reference's ``jax.remat``):
    backward keeps the (m, l, acc) carries and recomputes the block's
    probabilities, never storing S x Skv of them.

    ``skip_info=(causal, window)``, static: for self-attention with
    ``q_offset`` 0, q block i visits only the kv blocks in its causal /
    window reach.  The q blocks run one at a time in both sweeps, each
    (q block, kv block) step with the same shapes, so the skip is bit
    for bit the full sweep: a skipped block after the reach adds
    exp(-1e30 - m) = 0 with alpha 1, and one before it is wiped by the
    first visible block's alpha = exp(-1e30 - m) = 0.
    """
    B, Hq, S, D = q.shape
    Hkv, Skv, Dv = k.shape[1], k.shape[2], v.shape[3]
    group = Hq // Hkv
    scale = torch.tensor(1.0 / (D ** 0.5), dtype=q.dtype)  # in q's dtype

    s_pad, skv_pad = -S % bq, -Skv % bkv
    q = F.pad(q, (0, 0, 0, s_pad))
    k = F.pad(k, (0, 0, 0, skv_pad))
    v = F.pad(v, (0, 0, 0, skv_pad))
    nq, nkv = (S + s_pad) // bq, (Skv + skv_pad) // bkv
    dev = q.device

    qs = q.reshape(B, Hkv, group, nq, bq, D).permute(3, 0, 1, 2, 4, 5) * scale
    ks = k.reshape(B, Hkv, nkv, bkv, D).permute(2, 0, 1, 3, 4)
    vs = v.reshape(B, Hkv, nkv, bkv, Dv).permute(2, 0, 1, 3, 4)
    kpad = torch.arange(nkv * bkv, device=dev).reshape(nkv, bkv) >= Skv
    remat = records(q, k, v)

    can_skip = (skip_info is not None and skip_info[0] is True
                and (skip_info[1] is None or isinstance(skip_info[1], int))
                and q_offset == 0 and S == Skv)
    window = skip_info[1] if can_skip else None
    outs = []
    for qi in range(nq):
        if can_skip:
            hi = min(-(-((qi + 1) * bq) // bkv), nkv)
            lo = 0 if window is None else max(0, (qi * bq - window) // bkv)
        else:
            lo, hi = 0, nkv
        qpos = q_offset + qi * bq + torch.arange(bq, device=dev)
        carry = (torch.full((B, Hkv, group, bq), NEG_INF, device=dev),
                 torch.zeros((B, Hkv, group, bq), device=dev),
                 torch.zeros((B, Hkv, group, bq, Dv), device=dev))
        for ki in range(lo, hi):
            kpos = ki * bkv + torch.arange(bkv, device=dev)
            mask = mask_fn(qpos[:, None], kpos[None, :]) & ~kpad[ki][None, :]
            args = (*carry, qs[qi], ks[ki], vs[ki], mask)
            carry = (checkpoint(_kv_step, *args, use_reentrant=False)
                     if remat else _kv_step(*args))
        _, l, acc = carry
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None])
    out = torch.stack(outs)  # (nq, B, Hkv, g, bq, Dv)
    out = out.permute(1, 2, 3, 0, 4, 5).reshape(B, Hq, nq * bq, Dv)
    return out[:, :, :S].to(q.dtype)


# ---------------------------------------------------------------------------
# GQA block
# ---------------------------------------------------------------------------

def _attend(cfg, causal, window, prefix_len, skip_info) -> Callable:
    """The full-sequence attention of q, k, v: :func:`chunked_attention`
    (blocks ``cfg.q_block`` / ``cfg.kv_block``) when autograd records,
    else the flash kernel."""
    def attend(q, k, v):
        if records(q, k, v):
            return chunked_attention(
                q, k, v, make_mask_fn(causal, window, prefix_len),
                bq=min(cfg.q_block, q.shape[2]),
                bkv=min(cfg.kv_block, k.shape[2]), skip_info=skip_info)
        return ops.flash_attention(q, k, v, causal=causal,
                                   window=kernel_window(window),
                                   prefix_len=prefix_len)
    return attend


def _decode(window) -> Callable:
    """The decode kernel over a cache, for :func:`head_parallel`."""
    def decode(q, k, v, cur):
        return ops.decode_attention(q, k, v, cur,
                                    window=kernel_window(window))
    return decode


def gqa_specs(cfg, stacked: int | None) -> dict:
    lead = (stacked,) if stacked else ()
    lx = ("layers",) if stacked else ()
    D, Hq, Hkv, Hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "wq": ParamSpec(lead + (D, Hq * Hd), lx + ("embed", "qkv")),
        "wk": ParamSpec(lead + (D, Hkv * Hd), lx + ("embed", "kv")),
        "wv": ParamSpec(lead + (D, Hkv * Hd), lx + ("embed", "kv")),
        "wo": ParamSpec(lead + (Hq * Hd, D), lx + ("qkv", "embed")),
    }


def gqa_project(cfg, p, x, positions, *, rope: bool = True):
    """x: [B, S, D] -> q [B, Hq, S, Hd], k and v [B, Hkv, S, Hd] (roped),
    each contiguous."""
    B, S, _ = x.shape
    Hq, Hkv, Hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = x.dtype
    q = split_dim(x @ p["wq"].to(dt), 2, (Hq, Hd)).transpose(1, 2)
    k = split_dim(x @ p["wk"].to(dt), 2, (Hkv, Hd)).transpose(1, 2)
    v = split_dim(x @ p["wv"].to(dt), 2, (Hkv, Hd)).transpose(1, 2)
    if rope:
        q = common.apply_rope(q, positions[:, None], cfg.rope_theta)
        k = common.apply_rope(k, positions[:, None], cfg.rope_theta)
    return q.contiguous(), k.contiguous(), v.contiguous()


def gqa_apply(cfg, p, x, positions, *, causal: bool = True,
              window: int | None = None, prefix_len: int | None = None,
              rope: bool = True, kv_override=None, return_kv: bool = False,
              skip_info=None):
    """Full-sequence GQA/MQA/MHA attention: :func:`chunked_attention`
    (blocks ``cfg.q_block`` / ``cfg.kv_block``, ``skip_info`` as there)
    when autograd records, else the flash kernel.  kv_override: (k, v)
    [B, Hkv, Skv, Hd] from an encoder for cross-attention (no block
    skip).  return_kv: also return (k, v) for the cache."""
    B, S, _ = x.shape
    q, k, v = gqa_project(cfg, p, x, positions, rope=rope)
    if kv_override is not None:
        k, v = kv_override
        skip_info = None
    out = head_parallel(_attend(cfg, causal, window, prefix_len, skip_info),
                        q, k, v)
    out = merge_dims(out.transpose(1, 2), (B, S, cfg.n_heads * cfg.head_dim))
    out = out @ p["wo"].to(x.dtype)
    if return_kv:
        return out, (k, v)
    return out


def gqa_decode(cfg, p, x, cache: dict, *, window: int | None = None,
               rope: bool = True):
    """One-token decode through the decode kernel.  x: [B, 1, D]; cache:
    ``{"k", "v": [B, Hkv, Smax, Hd], "len": int32 scalar on the card}``.

    The reference returns new buffers (its jitted decode donates the old
    ones); here the cache is a buffer the port owns, so this writes the
    new key and value at ``len`` in place (``index_copy_`` with a device
    index, no host sync) and returns the same tensors with ``len + 1``.
    The decode kernel reads ``len + 1`` on the card, and with a
    ``window`` leaves out the keys below ``len + 1 - window``.
    """
    B = x.shape[0]
    Hq, Hkv, Hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    pos = cache["len"]  # int32 scalar: tokens already in the cache
    positions = pos.expand(B, 1)
    q, k, v = gqa_project(cfg, p, x, positions, rope=rope)
    k_cache = write_at(cache["k"], 2, pos, k)
    v_cache = write_at(cache["v"], 2, pos, v)
    cur = pos + 1
    # causal holds for every cached key (kpos < cur_len = qpos + 1)
    q = split_dim(q[:, :, 0], 1, (Hkv, Hq // Hkv))  # (B, Hkv, group, Hd)
    out = head_parallel(_decode(window), q,
                        k_cache, v_cache, cur)
    out = merge_dims(out[:, None], (B, 1, Hq * Hd)) @ p["wo"].to(x.dtype)
    return out, {"k": k_cache, "v": v_cache, "len": cur}


# ---------------------------------------------------------------------------
# MLA block (deepseek-v2): latent-compressed KV
# ---------------------------------------------------------------------------

def mla_specs(cfg, stacked: int | None) -> dict:
    lead = (stacked,) if stacked else ()
    lx = ("layers",) if stacked else ()
    D, H = cfg.d_model, cfg.n_heads
    r, nope, rdim, vdim = (cfg.kv_lora_rank, cfg.qk_nope_dim,
                           cfg.qk_rope_dim, cfg.v_head_dim)
    return {
        "wq": ParamSpec(lead + (D, H * (nope + rdim)), lx + ("embed", "qkv")),
        "wkv_a": ParamSpec(lead + (D, r + rdim), lx + ("embed", None)),
        "kv_norm": ParamSpec(lead + (r,), lx + (None,), init="zeros"),
        "wkv_b": ParamSpec(lead + (r, H * (nope + vdim)), lx + (None, "qkv")),
        "wo": ParamSpec(lead + (H * vdim, D), lx + ("qkv", "embed")),
    }


def _mla_qkv(cfg, p, x, positions):
    """x [B, S, D] -> q_nope [B, S, H, nope], q_rope [B, S, H, rdim] (roped
    per head), c_kv [B, S, r] (rms-normed) and k_rope [B, S, rdim] (one
    shared head, roped)."""
    B, S, _ = x.shape
    H = cfg.n_heads
    r, nope, rdim = cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim
    dt = x.dtype
    q = split_dim(x @ p["wq"].to(dt), 2, (H, nope + rdim))
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = common.apply_rope(q_rope.transpose(1, 2), positions[:, None],
                               cfg.rope_theta).transpose(1, 2)
    kv = x @ p["wkv_a"].to(dt)
    c_kv, k_rope = kv[..., :r], kv[..., r:]
    c_kv = common.rms_norm(c_kv, p["kv_norm"])
    k_rope = common.apply_rope(k_rope[:, None], positions[:, None],
                               cfg.rope_theta)[:, 0]
    return q_nope, q_rope, c_kv, k_rope


def _mla_expand_kv(cfg, p, c_kv, dtype):
    """Latent [..., r] -> per-head k_nope [..., H, nope] and v [..., H,
    vdim]."""
    H, nope, vdim = cfg.n_heads, cfg.qk_nope_dim, cfg.v_head_dim
    kv = c_kv.to(dtype) @ p["wkv_b"].to(dtype)
    kv = split_dim(kv, -1, (H, nope + vdim))
    return kv[..., :nope], kv[..., nope:]


def _mla_heads(q_nope, q_rope, k_nope, k_rope, v):
    """q [B, H, Sq, nope + rdim], k [B, H, S, nope + rdim] (the shared
    k_rope on every head) and v [B, H, S, vdim], each contiguous."""
    B, S, H, _ = k_nope.shape
    q = torch.cat([q_nope, q_rope], dim=-1).transpose(1, 2)
    k = torch.cat([k_nope, k_rope[:, :, None].expand(B, S, H,
                                                     k_rope.shape[-1])],
                  dim=-1).transpose(1, 2)
    return (q.contiguous(), k.contiguous(), v.transpose(1, 2).contiguous())


def mla_apply(cfg, p, x, positions, *, causal: bool = True,
              window: int | None = None, prefix_len: int | None = None,
              return_latent: bool = False, skip_info=None):
    """Full-sequence MLA: :func:`chunked_attention` when autograd
    records, else the flash kernel with D = nope + rope and Dv = vdim.
    return_latent: also return the latent ``[c_kv, k_rope]`` [B, S,
    r + rdim] for the cache."""
    B, S, _ = x.shape
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(cfg, p, x, positions)
    k_nope, v = _mla_expand_kv(cfg, p, c_kv, x.dtype)
    q, k, v = _mla_heads(q_nope, q_rope, k_nope, k_rope, v)
    out = head_parallel(_attend(cfg, causal, window, prefix_len, skip_info),
                        q, k, v)
    out = merge_dims(out.transpose(1, 2),
                     (B, S, cfg.n_heads * cfg.v_head_dim))
    out = out @ p["wo"].to(x.dtype)
    if return_latent:
        return out, torch.cat([c_kv, k_rope], dim=-1)
    return out


def mla_decode(cfg, p, x, cache: dict, *, window: int | None = None):
    """One-token MLA decode.  x: [B, 1, D]; cache: ``{"latent": [B, Smax,
    r + rdim], "len": int32 scalar on the card}``.  Writes the token's
    latent at ``len`` in place (as ``gqa_decode`` writes k and v), expands
    the whole cache through ``wkv_b`` (the reference's algebra) and
    calls the decode kernel with Hkv = H, group 1, D = nope + rope and
    Dv = vdim."""
    B = x.shape[0]
    H, r, vdim = cfg.n_heads, cfg.kv_lora_rank, cfg.v_head_dim
    pos = cache["len"]
    positions = pos.expand(B, 1)
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(cfg, p, x, positions)
    lat = torch.cat([c_kv, k_rope], dim=-1)                 # (B, 1, r+rdim)
    lat_cache = write_at(cache["latent"], 1, pos, lat)
    k_nope, v = _mla_expand_kv(cfg, p, lat_cache[..., :r], x.dtype)
    q, k, v = _mla_heads(q_nope, q_rope, k_nope, lat_cache[..., r:], v)
    cur = pos + 1
    out = head_parallel(_decode(window), q, k, v, cur)  # (B, H, 1, vdim)
    out = merge_dims(out.transpose(1, 2), (B, 1, H * vdim)) @ p["wo"].to(
        x.dtype)
    return out, {"latent": lat_cache, "len": cur}
