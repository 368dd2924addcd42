"""GQA/MQA/MHA attention blocks, prefill and decode paths.

Counterpart of ``repro/models/attention.py`` (its GQA block).  The
attention core runs the port's two kernels, which compute the
reference's functions (``tests/test_kernels.py`` holds the Pallas
kernels equal to them):

* ``gqa_apply`` (prefill) calls :func:`repro_torch.kernels.ops.flash_attention`
  where the reference calls its jnp ``chunked_attention``;
* ``gqa_decode`` calls :func:`repro_torch.kernels.ops.decode_attention`
  where the reference calls its jnp ``decode_attention``.

The jnp ``chunked_attention`` is the reference's differentiable training
path and waits for the training slice; MLA waits for its own.  The
reference passes its mask as a position predicate (``make_mask_fn``);
the kernels take the mask's static form, so the blocks here take
``causal`` and an int ``window`` directly.  The prefix-LM mask waits for
the VLM prefix (``transformer._check_ported`` refuses it), and a window
at decode raises NotImplementedError: the decode kernel has none, as the
TPU one has none.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models import common
from repro_torch.models.common import ParamSpec


# ---------------------------------------------------------------------------
# GQA block
# ---------------------------------------------------------------------------

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
    q = (x @ p["wq"].to(dt)).reshape(B, S, Hq, Hd).transpose(1, 2)
    k = (x @ p["wk"].to(dt)).reshape(B, S, Hkv, Hd).transpose(1, 2)
    v = (x @ p["wv"].to(dt)).reshape(B, S, Hkv, Hd).transpose(1, 2)
    if rope:
        q = common.apply_rope(q, positions[:, None], cfg.rope_theta)
        k = common.apply_rope(k, positions[:, None], cfg.rope_theta)
    return q.contiguous(), k.contiguous(), v.contiguous()


def gqa_apply(cfg, p, x, positions, *, causal: bool = True,
              window: int | None = None, rope: bool = True,
              return_kv: bool = False):
    """Full-sequence GQA/MQA/MHA attention (prefill) through the flash
    kernel.  return_kv: also return (k, v) for the cache."""
    B, S, _ = x.shape
    q, k, v = gqa_project(cfg, p, x, positions, rope=rope)
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    out = out.transpose(1, 2).reshape(B, S, cfg.n_heads * cfg.head_dim)
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
    The decode kernel reads ``len + 1`` on the card.
    """
    B = x.shape[0]
    Hq, Hkv, Hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if window is not None:
        raise NotImplementedError(
            "gqa_decode: the decode kernel has no window, as the TPU one "
            "has none (ROADMAP A17.2)")
    pos = cache["len"]  # int32 scalar: tokens already in the cache
    positions = pos.expand(B, 1)
    q, k, v = gqa_project(cfg, p, x, positions, rope=rope)
    at = pos.reshape(1).to(torch.int64)
    k_cache = cache["k"].index_copy_(2, at, k)
    v_cache = cache["v"].index_copy_(2, at, v)
    cur = pos + 1
    # causal holds for every cached key (kpos < cur_len = qpos + 1)
    out = ops.decode_attention(q.reshape(B, Hkv, Hq // Hkv, Hd), k_cache,
                               v_cache, cur)
    out = out.reshape(B, 1, Hq * Hd) @ p["wo"].to(x.dtype)
    return out, {"k": k_cache, "v": v_cache, "len": cur}
