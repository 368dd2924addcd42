"""Selective SSM (Mamba) head used by the hymba hybrid block.

Counterpart of ``repro/models/mamba.py``.  Classic S6: input-dependent
(Delta, B, C) with a diagonal A; the recurrence

    h_t = exp(Delta_t * A) h_{t-1} + Delta_t * B_t * x_t      (per channel)
    y_t = C_t . h_t + D * x_t

keeps a state [B, d_inner, d_state] in float32, O(1) in the sequence
length.  The short depthwise causal conv (k = 4) keeps its last k - 1
inputs as the decode cache.

The scan is a loop over time in plain PyTorch, as the reference's
``lax.scan`` in jnp (no Pallas kernel, so no TPU kernel to port); the
decay factors ``exp(Delta_t A)`` and inputs ``Delta_t B_t x_t`` of every
step are computed before the loop and the contraction with C_t after
it, so a step is one launch (``addcmul``); the states of every step are
kept for the contraction ([B, S, d_inner, d_state] float32: 0.45 GB at
hymba's 2 x 1,100-token prefill).  A hand-written scan kernel is ROADMAP
B18.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import ParamSpec


def mamba_specs(cfg, stacked: int | None, d_in: int, d_inner: int) -> dict:
    lead = (stacked,) if stacked else ()
    lx = ("layers",) if stacked else ()
    Ns, Kc = cfg.ssm_state, cfg.ssm_conv
    dt_rank = max(d_in // 16, 1)
    return {
        "w_in": ParamSpec(lead + (d_in, 2 * d_inner), lx + ("embed", "qkv")),
        "conv_w": ParamSpec(lead + (Kc, d_inner), lx + (None, "qkv"),
                            scale=0.5),
        "conv_b": ParamSpec(lead + (d_inner,), lx + ("qkv",), init="zeros"),
        "w_bdt": ParamSpec(lead + (d_inner, 2 * Ns + dt_rank),
                           lx + ("qkv", None)),
        "w_dt": ParamSpec(lead + (dt_rank, d_inner), lx + (None, "qkv"),
                          scale=0.1),
        "dt_bias": ParamSpec(lead + (d_inner,), lx + ("qkv",), init="zeros"),
        "a_log": ParamSpec(lead + (d_inner, Ns), lx + ("qkv", None),
                           init="zeros"),
        "d_skip": ParamSpec(lead + (d_inner,), lx + ("qkv",), init="ones"),
        "w_out": ParamSpec(lead + (d_inner, d_in), lx + ("qkv", "embed")),
    }


def _conv1d(x, w, b, cache=None):
    """Depthwise causal conv.  x [B, S, Di], w [K, Di], cache [B, K - 1,
    Di] (the inputs before x) or None (zeros).  Returns (out [B, S, Di],
    the new cache: the last K - 1 inputs)."""
    K = w.shape[0]
    if cache is None:
        pad = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = cache.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    S = x.shape[1]
    out = sum(xp[:, i:i + S] * w[i].to(x.dtype) for i in range(K))
    new_cache = xp[:, -(K - 1):] if K > 1 else pad
    return out + b.to(x.dtype), new_cache


def _ssm_scan(u, dt, B_in, C_in, a_log, d_skip, state):
    """u, dt [B, S, Di]; B_in, C_in [B, S, Ns]; state [B, Di, Ns].
    Returns (y [B, S, Di] float32, the new state), in float32."""
    f32 = torch.float32
    A = -torch.exp(a_log.to(f32))                       # (Di, Ns), negative
    u, dt, B_in, C_in = (t.to(f32) for t in (u, dt, B_in, C_in))
    dA = torch.exp(dt[..., None] * A)                   # (B, S, Di, Ns)
    dBu = (dt * u)[..., None] * B_in[:, :, None, :]
    h = state.to(f32)
    hs = []
    for t in range(u.shape[1]):
        h = torch.addcmul(dBu[:, t], dA[:, t], h)
        hs.append(h)
    y = torch.einsum("bsdn,bsn->bsd", torch.stack(hs, dim=1), C_in)
    return y + u * d_skip.to(f32), h


def mamba_apply(cfg, p, x, *, cache=None, return_cache: bool = False):
    """x [B, S, D] -> (y [B, S, D], cache).  ``cache`` is ``{"h", "conv"}``
    (decode: the state and the conv's last inputs) or None (training:
    zeros, and None returned); ``return_cache`` with no cache returns the
    cache a full-sequence run leaves (prefill)."""
    B, S, D = x.shape
    dt_ = x.dtype
    d_inner = p["w_in"].shape[-1] // 2
    Ns = cfg.ssm_state
    xz = x @ p["w_in"].to(dt_)
    u, z = xz.chunk(2, dim=-1)
    conv_cache = None if cache is None else cache["conv"]
    u, new_conv = _conv1d(u, p["conv_w"], p["conv_b"], conv_cache)
    u = F.silu(u)
    bdt = u @ p["w_bdt"].to(dt_)
    B_in, C_in, dt_low = bdt.split([Ns, Ns, bdt.shape[-1] - 2 * Ns], dim=-1)
    dt = F.softplus(dt_low @ p["w_dt"].to(dt_) + p["dt_bias"].to(dt_))
    state = (torch.zeros((B, d_inner, Ns), dtype=torch.float32,
                         device=x.device) if cache is None else cache["h"])
    y, state = _ssm_scan(u, dt, B_in, C_in, p["a_log"], p["d_skip"], state)
    y = y.to(dt_) * F.silu(z)
    out = y @ p["w_out"].to(dt_)
    if cache is None and not return_cache:
        return out, None
    return out, {"h": state, "conv": new_conv.to(dt_)}
