"""RWKV-6 "Finch" time-mix: linear attention with data-dependent decay.

Counterpart of ``repro/models/rwkv6.py``.  State per head is an (N x N)
outer-product memory updated per token:

    S_t[i,j] = w_t[i] * S_{t-1}[i,j] + k_t[i] * v_t[j]
    y_t[j]   = sum_i r_t[i] * (S_{t-1}[i,j] + u[i] * k_t[i] * v_t[j])

with per-channel, data-dependent decay w_t = exp(-exp(w_raw_t)) produced
by a LoRA on the token-shifted input, the log-decay clipped to [-2.5,
-1e-4].  Everything past the projections is float32, as in the
reference.  Two execution modes (``cfg.rwkv_mode``), chosen exactly as
the reference chooses them:

* ``recurrent``: the exact recurrence, a loop over time (the reference's
  ``lax.scan``): decode (S = 1) and the oracle;
* ``chunked`` (when S is a multiple of ``cfg.rwkv_chunk`` and S > 1):
  intra-chunk pairwise products plus inter-chunk state passing.  Every
  exponent is a difference of the in-chunk cumulative log-decay, which
  stays inside float32 range only for chunks of at most 32 (|L| <= 80 at
  the clip).  The reference's own config sets ``rwkv_chunk = 128``,
  where ``k * exp(-L)`` reaches e^128 = inf and ``r * exp(L_prev)`` 0,
  so its chunked result is NaN from a log-decay near -1 (ROADMAP C12).
  The port runs a chunk larger than 32 as consecutive sub-chunks of
  ``gcd(chunk, 32)`` (32 for every power-of-two chunk of 32 or more)
  through the same step, passing the state between them: the
  reference's own algorithm at the size its docstring allows.  Where
  the reference's chunked result is finite the two agree within float32
  rounding; where it is NaN the port's equals the recurrence.  At
  ``rwkv_chunk <= 32`` (every reduced config) the chunking is the
  reference's.  When autograd records, each chunk step is checkpointed,
  as the reference remats it.

The WKV recurrence stays plain PyTorch: the reference computes it in jnp
(no Pallas kernel), so there is no TPU kernel to port; a hand-written
scan kernel is ROADMAP B17.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import mlp as mlp_mod
from repro_torch.models.attention import records
from repro_torch.models.common import ParamSpec, rms_norm

LW_MIN, LW_MAX = -2.5, -1e-4
DECAY_LORA = 64
SAFE_CHUNK = 32  # the longest chunk whose exponents stay in float32 range


def rwkv_specs(cfg, stacked: int | None) -> dict:
    lead = (stacked,) if stacked else ()
    lx = ("layers",) if stacked else ()
    D = cfg.d_model
    H = D // cfg.rwkv_head_dim
    N = cfg.rwkv_head_dim
    return {
        "mu": ParamSpec(lead + (5, D), lx + (None, "embed"), init="ones"),
        "w_base": ParamSpec(lead + (D,), lx + ("embed",), init="zeros"),
        "w_lora_a": ParamSpec(lead + (D, DECAY_LORA), lx + ("embed", None),
                              scale=0.1),
        "w_lora_b": ParamSpec(lead + (DECAY_LORA, D), lx + (None, "embed"),
                              scale=0.1),
        "wr": ParamSpec(lead + (D, D), lx + ("embed", "qkv")),
        "wk": ParamSpec(lead + (D, D), lx + ("embed", "qkv")),
        "wv": ParamSpec(lead + (D, D), lx + ("embed", "qkv")),
        "wg": ParamSpec(lead + (D, D), lx + ("embed", "qkv")),
        "u": ParamSpec(lead + (H, N), lx + ("heads", None), init="zeros"),
        "ln_x": ParamSpec(lead + (D,), lx + ("embed",), init="zeros"),
        "wo": ParamSpec(lead + (D, D), lx + ("qkv", "embed")),
    }


def _rkvwg(cfg, p, x, x_prev):
    """Token-shift lerp + projections.  x [B, S, D] -> r, k, v [B, H, S,
    N] in x's dtype, g [B, S, D], lw [B, H, S, N] float32 (the clipped
    log-decay)."""
    B, S, D = x.shape
    H, N = D // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    dt = x.dtype
    mu = p["mu"].to(dt)                                        # (5, D)
    xr, xk, xv, xw, xg = (x + (x_prev - x) * mu[i] for i in range(5))
    r = xr @ p["wr"].to(dt)
    k = xk @ p["wk"].to(dt)
    v = xv @ p["wv"].to(dt)
    g = xg @ p["wg"].to(dt)
    f32 = torch.float32
    w_raw = (p["w_base"].to(f32)
             + torch.tanh(xw.to(f32) @ p["w_lora_a"].to(f32))
             @ p["w_lora_b"].to(f32))
    lw = torch.clamp(-torch.exp(w_raw), LW_MIN, LW_MAX)

    def heads(t):
        return t.reshape(B, S, H, N).transpose(1, 2)

    return heads(r), heads(k), heads(v), g, heads(lw)


def wkv_recurrent(r, k, v, lw, u, state):
    """The exact recurrence.  r, k, v, lw [B, H, S, N]; u [H, N]; state
    [B, H, N, N].  Returns (y [B, H, S, N] float32, the new state)."""
    r, k, v, lw = (t.to(torch.float32) for t in (r, k, v, lw))
    s = state.to(torch.float32)
    bonus = u[None, :, :, None]
    ys = []
    for t in range(r.shape[2]):
        kv = k[:, :, t, :, None] * v[:, :, t, None, :]        # (B, H, N, N)
        ys.append(torch.einsum("bhi,bhij->bhj", r[:, :, t], s + bonus * kv))
        s = torch.exp(lw[:, :, t])[..., None] * s + kv
    return torch.stack(ys, dim=2), s


def _chunk_step(s, rr, kk, vv, ll, u):
    """One chunk (the reference's ``chunk_step``): rr, kk, vv, ll [B, H, C,
    N] float32, s the state entering it.  Returns (the state leaving it,
    y [B, H, C, N])."""
    C = rr.shape[2]
    L = torch.cumsum(ll, dim=2)               # inclusive cumulative log-decay
    L_prev = L - ll                           # L_{t-1} (exclusive)
    L_last = L[:, :, -1:, :]                  # (B, H, 1, N)
    r_in = rr * torch.exp(L_prev)             # bounded by |r|
    k_out = kk * torch.exp(L_last - L)        # bounded by |k|
    k_in = kk * torch.exp(-L)                 # up to e^80 at C = 32
    A = torch.einsum("bhti,bhji->bhtj", r_in, k_in)
    tri = torch.tril(torch.ones(C, C, dtype=torch.bool, device=rr.device),
                     diagonal=-1)
    A = torch.where(tri, A, 0.0)
    y_intra = torch.einsum("bhtj,bhjn->bhtn", A, vv)
    y_diag = (rr * u[None, :, None, :] * kk).sum(-1, keepdim=True) * vv
    y_inter = torch.einsum("bhti,bhin->bhtn", r_in, s)
    s_new = torch.exp(L_last)[..., 0, :][..., :, None] * s + torch.einsum(
        "bhti,bhtn->bhin", k_out, vv)
    return s_new, y_intra + y_diag + y_inter


def sub_chunk(chunk: int) -> int:
    """The chunk :func:`wkv_chunked` steps by: ``chunk`` up to 32, else
    ``gcd(chunk, 32)`` (ROADMAP C12)."""
    return chunk if chunk <= SAFE_CHUNK else math.gcd(chunk, SAFE_CHUNK)


def wkv_chunked(r, k, v, lw, u, state, chunk: int):
    """Chunked-parallel WKV6 (the module docstring): S a multiple of
    ``chunk``, each chunk run as sub-chunks of :func:`sub_chunk` through
    the reference's step, in float32; each step checkpointed when
    autograd records.  Returns (y [B, H, S, N], the new state)."""
    B, H, S, N = r.shape
    assert S % chunk == 0, (S, chunk)
    C = sub_chunk(chunk)
    f32 = torch.float32
    rc, kc, vc, lc = (t.to(f32).split(C, dim=2) for t in (r, k, v, lw))
    s = state.to(f32)
    remat = records(r, k, v, lw, u, state)
    ys = []
    for args in zip(rc, kc, vc, lc):
        args = (s, *args, u)
        s, y = (checkpoint(_chunk_step, *args, use_reentrant=False)
                if remat else _chunk_step(*args))
        ys.append(y)
    return torch.cat(ys, dim=2), s


def rwkv_apply(cfg, p, x, *, x_prev=None, state=None):
    """Full-sequence time-mix.  x [B, S, D] -> (y [B, S, D], the final
    state [B, H, N, N] float32).  ``x_prev`` defaults to the token shift
    of x, ``state`` to zeros."""
    B, S, D = x.shape
    H, N = D // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    if x_prev is None:
        x_prev = mlp_mod.token_shift(x)
    if state is None:
        state = torch.zeros((B, H, N, N), dtype=torch.float32,
                            device=x.device)
    r, k, v, g, lw = _rkvwg(cfg, p, x, x_prev)
    u = p["u"].to(torch.float32)
    if cfg.rwkv_mode == "chunked" and S % cfg.rwkv_chunk == 0 and S > 1:
        y, state = wkv_chunked(r, k, v, lw, u, state, cfg.rwkv_chunk)
    else:
        y, state = wkv_recurrent(r, k, v, lw, u, state)
    y = y.transpose(1, 2).reshape(B, S, D)
    y = rms_norm(y.to(x.dtype), p["ln_x"])
    y = y * F.silu(g)
    return y @ p["wo"].to(x.dtype), state


def rwkv_decode(cfg, p, x, cache: dict):
    """Single-token decode: O(1) state, no KV growth.  cache: ``{"state":
    [B, H, N, N] float32, "x_prev": [B, 1, D]}`` (the block's
    ``cx_prev`` is the channel-mix's, in ``transformer.py``).  Returns
    (y, the new cache)."""
    y, state = rwkv_apply(cfg, p, x, x_prev=cache["x_prev"],
                          state=cache["state"])
    return y, {**cache, "state": state, "x_prev": x}
