"""Whisper-style encoder-decoder backbone (the audio frontend is a stub).

Counterpart of ``repro/models/encdec.py``.  The inputs are precomputed
frame embeddings [B, enc_seq, D] (the conv frontend is out of scope, as
in the reference).  Pre-LN blocks, GELU MLPs, LayerNorm, sinusoidal
positions for both stacks, bidirectional encoder self-attention, causal
decoder self-attention and cross-attention to the encoder's states, no
RoPE.  Stacks are run by a Python loop; with ``cfg.remat`` each block
is checkpointed when autograd records, as the reference remats each.

On the card, without grad, every attention of the full-sequence path
is a launch of the flash kernel: the encoder's (non-causal, Sq = Skv =
enc_seq), the decoder's causal self-attention and its cross-attention
(non-causal, Sq the text, Skv the frames).  The decode caches are, per
decoder layer, the self-attention's k and v (written in place at
``len``) and the cross-attention's k and v, computed once from the
encoder's output at prefill; a decode step's self- and cross-attention
are each a launch of the decode kernel, the cross one at ``cur_len =
enc_seq`` (an int32 scalar made on the card, so no host sync).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.distributed.sharding import (active_rules, copy_into,
                                              is_dtensor,
                                              merge_dims,
                                              recompute_context,
                                              settle, split_dim,
                                              zeros)
from repro_torch.kernels import ops
from repro_torch.models import attention as attn_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.attention import records
from repro_torch.models.common import (ParamSpec, apply_norm, norm_spec,
                                       scan_layers, sinusoidal_embedding)
from repro_torch.models.qhead import tree_leaves
from repro_torch.models.transformer import (_adtype, _positions, lookup,
                                           token_nll, unembed)


def encdec_param_specs(cfg) -> dict:
    L_enc, L_dec, D = cfg.n_enc_layers, cfg.n_layers, cfg.d_model
    enc_block = {
        "norm1": norm_spec(cfg.norm_kind, D, L_enc),
        "attn": attn_mod.gqa_specs(cfg, L_enc),
        "norm2": norm_spec(cfg.norm_kind, D, L_enc),
        "mlp": mlp_mod.mlp_specs("gelu", D, cfg.d_ff, L_enc),
    }
    dec_block = {
        "norm1": norm_spec(cfg.norm_kind, D, L_dec),
        "self": attn_mod.gqa_specs(cfg, L_dec),
        "norm_x": norm_spec(cfg.norm_kind, D, L_dec),
        "cross": attn_mod.gqa_specs(cfg, L_dec),
        "norm2": norm_spec(cfg.norm_kind, D, L_dec),
        "mlp": mlp_mod.mlp_specs("gelu", D, cfg.d_ff, L_dec),
    }
    return {
        "embed": ParamSpec((cfg.vocab_size, D), ("vocab", "embed"),
                           init="embed"),
        "enc_blocks": enc_block,
        "enc_norm": norm_spec(cfg.norm_kind, D),
        "dec_blocks": dec_block,
        "dec_norm": norm_spec(cfg.norm_kind, D),
    }


def _run_stack(cfg, body, x, blocks, *extra):
    """``body(carry, lp, *extra)`` over a stack's layers, each checkpointed
    when autograd records and ``cfg.remat`` is set."""
    def step(carry, lp):
        if cfg.remat and records(carry, *tree_leaves(lp)):
            return checkpoint(body, carry, lp, *extra, use_reentrant=False,
                              context_fn=recompute_context), None
        return body(carry, lp, *extra), None

    return scan_layers(step, x, blocks)[0]


def _enc_block(cfg, lp, x, positions):
    h = apply_norm(cfg.norm_kind, x, lp["norm1"])
    x = x + attn_mod.gqa_apply(cfg, lp["attn"], h, positions,
                                            causal=False, rope=False)
    h2 = apply_norm(cfg.norm_kind, x, lp["norm2"])
    return x + mlp_mod.mlp_apply("gelu", lp["mlp"], h2)


def encode(cfg, params, frames):
    """frames [B, enc_seq, D] (stub embeddings) -> the encoder's states
    [B, enc_seq, D] in the activation dtype."""
    T, D = frames.shape[1:]
    x = frames.to(_adtype(cfg))
    x = x + sinusoidal_embedding(torch.arange(T, device=x.device),
                                 D).to(x.dtype)[None]
    x = _run_stack(cfg, lambda c, lp, pos: _enc_block(cfg, lp, c, pos), x,
                   params["enc_blocks"], _positions(x))
    return apply_norm(cfg.norm_kind, x, params["enc_norm"])


def _cross_kv(cfg, lp_cross, enc_out):
    """Encoder states -> one layer's cross k and v [B, Hkv, T, Hd] (no
    rope), each contiguous."""
    B, T, _ = enc_out.shape
    Hkv, Hd = cfg.n_kv_heads, cfg.head_dim
    dt = enc_out.dtype
    k = split_dim(enc_out @ lp_cross["wk"].to(dt), 2, (Hkv, Hd))
    v = split_dim(enc_out @ lp_cross["wv"].to(dt), 2, (Hkv, Hd))
    return k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()


def _dec_block(cfg, lp, x, positions, enc_out):
    h = apply_norm(cfg.norm_kind, x, lp["norm1"])
    x = x + attn_mod.gqa_apply(cfg, lp["self"], h, positions,
                                            causal=True, rope=False)
    hx = apply_norm(cfg.norm_kind, x, lp["norm_x"])
    x = x + attn_mod.gqa_apply(
        cfg, lp["cross"], hx, positions, causal=False, rope=False,
        kv_override=_cross_kv(cfg, lp["cross"], enc_out))
    h2 = apply_norm(cfg.norm_kind, x, lp["norm2"])
    return x + mlp_mod.mlp_apply("gelu", lp["mlp"], h2)


def _embed_text(cfg, params, tokens, positions):
    """Token embeddings (gather, then cast) plus the sinusoidal positions
    at ``positions`` (broadcast over the batch)."""
    x = lookup(params["embed"], tokens).to(_adtype(cfg))
    return x + sinusoidal_embedding(positions, cfg.d_model).to(x.dtype)


def forward(cfg, params, tokens, frames):
    """Teacher-forced decoder logits [B, S, V] (float32)."""
    enc_out = encode(cfg, params, frames)
    B, S = tokens.shape
    pos = torch.arange(S, device=enc_out.device)
    x = _embed_text(cfg, params, tokens, pos)
    x = _run_stack(cfg, lambda c, lp, p, e: _dec_block(cfg, lp, c, p, e), x,
                   params["dec_blocks"], pos.expand(B, S), enc_out)
    x = apply_norm(cfg.norm_kind, x, params["dec_norm"])
    return unembed(cfg, params, x)


def encdec_loss(cfg, params, batch):
    """batch ``{tokens, targets, loss_mask, frames}`` -> (the mean NLL over
    the mask, ``{"nll": loss}``)."""
    logits = forward(cfg, params, batch["tokens"], batch["frames"])
    nll = token_nll(logits, batch["targets"])
    mask = batch["loss_mask"].to(torch.float32)
    # the sums whole before the divide (torch 2.11 cannot divide a split
    # or partial sum's gradient)
    loss = settle((nll * mask).sum()) / torch.clamp(settle(mask.sum()),
                                                   min=1.0)
    return loss, {"nll": loss}


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def encdec_cache_axes(cfg) -> dict:
    """Logical axes of the stacked decode caches."""
    return {"self_k": ("layers", "batch", None, "kv_seq", None),
            "self_v": ("layers", "batch", None, "kv_seq", None),
            "cross_k": ("layers", "batch", None, "kv_seq", None),
            "cross_v": ("layers", "batch", None, "kv_seq", None),
            "len": ()}


def init_cache(cfg, batch: int, max_len: int, device="cuda", rules=None):
    """Per decoder layer (stacked): the self-attention's k and v over
    ``max_len`` positions, the cross-attention's over ``enc_seq`` frames,
    zeros in the activation dtype; ``len`` an int32 scalar on the
    device.  With ``rules``, DTensors placed by ``encdec_cache_axes``."""
    device = resolve_device(device)
    dt = _adtype(cfg)
    L, Hkv, Hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    axes = encdec_cache_axes(cfg)
    shapes = {"self_k": (L, batch, Hkv, max_len, Hd),
              "self_v": (L, batch, Hkv, max_len, Hd),
              "cross_k": (L, batch, Hkv, cfg.enc_seq, Hd),
              "cross_v": (L, batch, Hkv, cfg.enc_seq, Hd)}
    cache = {k: zeros(sh, dt, axes[k], device, rules)
             for k, sh in shapes.items()}
    cache["len"] = zeros((), torch.int32, (), device, rules)
    return cache


def prefill(cfg, params, frames, bos_tokens, max_len: int):
    """Encode, write every decoder layer's cross k and v, then decode the
    first token.  bos_tokens [B, 1] -> (logits [B, 1, V], cache)."""
    enc_out = encode(cfg, params, frames)
    cache = init_cache(cfg, bos_tokens.shape[0], max_len, enc_out.device,
                       active_rules() if is_dtensor(enc_out) else None)

    def kv_body(_, xs):
        lp_cross, ck, cv = xs
        k, v = _cross_kv(cfg, lp_cross, enc_out)
        copy_into(ck, k)
        copy_into(cv, v)
        return None, None

    scan_layers(kv_body, None, (params["dec_blocks"]["cross"],
                                cache["cross_k"], cache["cross_v"]))
    return decode_step(cfg, params, bos_tokens, cache)


def decode_step(cfg, params, tokens, cache):
    """One decoder token against the cached self and cross k and v:
    tokens [B, 1] -> (logits [B, 1, V], cache with ``len + 1``; the self
    k and v written in place at ``len``)."""
    B = tokens.shape[0]
    Hq, Hkv, Hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    pos = cache["len"]
    x = _embed_text(cfg, params, tokens, pos[None, None])
    enc_len = torch.full((), cache["cross_k"].shape[3], dtype=torch.int32,
                         device=x.device)
    zero_pos = torch.zeros((B, 1), dtype=torch.int32, device=x.device)

    def body(carry, xs):
        lp, sk, sv, ck, cv = xs
        h = apply_norm(cfg.norm_kind, carry, lp["norm1"])
        a, _ = attn_mod.gqa_decode(cfg, lp["self"], h,
                                   {"k": sk, "v": sv, "len": pos},
                                   rope=False)
        x = carry + a
        hx = apply_norm(cfg.norm_kind, x, lp["norm_x"])
        qx = attn_mod.gqa_project(cfg, lp["cross"], hx, zero_pos,
                                  rope=False)[0]            # (B, Hq, 1, Hd)
        o = attn_mod.head_parallel(attn_mod._decode(None),
                                   split_dim(qx[:, :, 0], 1,
                                             (Hkv, Hq // Hkv)), ck, cv,
                                   enc_len)
        x = x + merge_dims(o[:, None], (B, 1, Hq * Hd)) @ lp["cross"]["wo"].to(
            x.dtype)
        h2 = apply_norm(cfg.norm_kind, x, lp["norm2"])
        return x + mlp_mod.mlp_apply("gelu", lp["mlp"], h2), None

    x, _ = scan_layers(body, x, (params["dec_blocks"], cache["self_k"],
                                 cache["self_v"], cache["cross_k"],
                                 cache["cross_v"]))
    x = apply_norm(cfg.norm_kind, x, params["dec_norm"])
    return unembed(cfg, params, x), {**cache, "len": pos + 1}
