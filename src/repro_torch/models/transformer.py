"""Decoder-only LM assembly, dense attention blocks.

Counterpart of ``repro/models/transformer.py`` for the block kind the
port has: attention (GQA/MQA/MHA) with a dense MLP, uniform over the
layers (no per-layer window).  Layers are stored stacked on a leading
"layers" dim, as in the reference, and run by a Python loop
(``common.scan_layers``); with ``cfg.remat`` each block is checkpointed
when autograd records, as the reference's scan remats each.  The
reference's ``logical_constraint`` is dropped: one card, no mesh.
rwkv, hybrid, MLA and MoE blocks (and MoE's auxiliary losses) wait for
their own slices.

Entry points:
  forward()      full-sequence logits
  lm_loss()      the training loss (full logits or ``blockwise_nll``)
  prefill()      forward + cache construction (serving)
  decode_step()  one token with the cache
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.attention import records
from repro_torch.models.common import (ParamSpec, apply_norm, norm_spec,
                                       scan_layers, softcap)
from repro_torch.models.qhead import tree_leaves


def _check_ported(cfg) -> None:
    if cfg.block_kind != "attn" or cfg.attn_kind != "gqa":
        raise NotImplementedError(
            f"{cfg.name}: block {cfg.block_kind}/{cfg.attn_kind} is not "
            "ported (ROADMAP A17)")
    if cfg.n_experts:
        raise NotImplementedError(f"{cfg.name}: MoE is not ported "
                                  "(ROADMAP A17.4)")
    if cfg.global_attn_layers:
        raise NotImplementedError(f"{cfg.name}: per-layer windows are not "
                                  "ported (ROADMAP A17.2)")
    if cfg.vis_prefix_len:
        raise NotImplementedError(f"{cfg.name}: the prefix-LM mask is not "
                                  "ported (ROADMAP A17.8)")


# ---------------------------------------------------------------------------
# Param specs
# ---------------------------------------------------------------------------

def _block_specs(cfg, L: int) -> dict:
    return {
        "norm1": norm_spec(cfg.norm_kind, cfg.d_model, L),
        "mix": attn_mod.gqa_specs(cfg, L),
        "norm2": norm_spec(cfg.norm_kind, cfg.d_model, L),
        "mlp": mlp_mod.mlp_specs(cfg.mlp_kind, cfg.d_model, cfg.d_ff, L),
    }


def lm_param_specs(cfg) -> dict:
    _check_ported(cfg)
    specs = {
        "embed": ParamSpec((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                           init="embed"),
        "blocks": _block_specs(cfg, cfg.n_layers),
        "final_norm": norm_spec(cfg.norm_kind, cfg.d_model),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab_size),
                                     ("embed", "vocab"))
    return specs


# ---------------------------------------------------------------------------
# Embedding and unembedding
# ---------------------------------------------------------------------------

def _adtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def embed_tokens(cfg, params, tokens):
    # gather, then cast: the reference's cast-then-gather, without a cast
    # of the whole table
    x = params["embed"][tokens].to(_adtype(cfg))
    if getattr(cfg, "scale_embed", False):
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def unembed(cfg, params, x):
    """x: [B, S, D] -> float32 logits [B, S, V]."""
    logits = x @ _unembed_weight(cfg, params, x.dtype)
    return softcap(logits.to(torch.float32), cfg.logit_softcap)


# ---------------------------------------------------------------------------
# Full sequence: forward and prefill
# ---------------------------------------------------------------------------

def _positions(x):
    B, S, _ = x.shape
    return torch.arange(S, device=x.device).expand(B, S)


def _static_skip_info(cfg, causal, window, prefix_len):
    """Static mask geometry for causal block-skipping (None = no skip)."""
    if (not getattr(cfg, "attn_block_skip", True) or not causal
            or prefix_len is not None
            or not (window is None or isinstance(window, int))):
        return None
    return (True, window)


def block_prefill(cfg, lp, x, positions):
    """One block over the full sequence; returns (x, this layer's
    (k, v) [B, Hkv, S, Hd])."""
    causal, window = cfg.is_causal_lm, cfg.sliding_window
    h = apply_norm(cfg.norm_kind, x, lp["norm1"])
    mix, kv = attn_mod.gqa_apply(
        cfg, lp["mix"], h, positions, causal=causal, window=window,
        return_kv=True,
        skip_info=_static_skip_info(cfg, causal, window, None))
    x = x + mix
    h2 = apply_norm(cfg.norm_kind, x, lp["norm2"])
    return x + mlp_mod.mlp_apply(cfg.mlp_kind, lp["mlp"], h2), kv


def block_apply(cfg, lp, x, positions):
    """One block over the full sequence (training / forward)."""
    return block_prefill(cfg, lp, x, positions)[0]


def forward_hidden(cfg, params, tokens):
    """tokens [B, S] -> final-norm hidden states [B, S, D].  When
    autograd records and ``cfg.remat`` is set, each block is
    checkpointed: backward keeps its input and recomputes the rest."""
    x = embed_tokens(cfg, params, tokens)
    positions = _positions(x)

    def body(carry, lp):
        if cfg.remat and records(carry, *tree_leaves(lp)):
            return checkpoint(block_apply, cfg, lp, carry, positions,
                              use_reentrant=False), None
        return block_apply(cfg, lp, carry, positions), None

    x, _ = scan_layers(body, x, params["blocks"])
    return apply_norm(cfg.norm_kind, x, params["final_norm"])


def forward(cfg, params, tokens):
    """tokens [B, S] -> logits [B, S, V]."""
    return unembed(cfg, params, forward_hidden(cfg, params, tokens))


def _unembed_weight(cfg, params, dtype):
    """The unembedding as a (D, V) matrix in ``dtype``."""
    if cfg.tie_embeddings:
        return params["embed"].to(dtype).T
    return params["lm_head"].to(dtype)


def _nll_block(cfg, x, targets, m, s, tgt, i: int, wb):
    """One vocab chunk of :func:`blockwise_nll`: its logits, the online
    logsumexp's (max, sum) carries and the target's logit if it lies in
    the chunk."""
    block = wb.shape[1]
    logits = (x @ wb).to(torch.float32)                     # (B, S, block)
    col_ok = i * block + torch.arange(block, device=x.device) < cfg.vocab_size
    logits = softcap(torch.where(col_ok, logits, -1e30), cfg.logit_softcap)
    m_new = torch.maximum(m, logits.amax(-1))
    s = s * torch.exp(m - m_new) + torch.exp(logits - m_new[..., None]).sum(-1)
    loc = targets.to(torch.int64) - i * block
    hit = (loc >= 0) & (loc < block)
    tgt_l = torch.gather(logits, -1, loc.clamp(0, block - 1)[..., None])[..., 0]
    return m_new, s, torch.where(hit, tgt_l, tgt)


def blockwise_nll(cfg, params, x, targets):
    """Streaming cross-entropy: never materialises the [B, S, V] logits.

    An online logsumexp over vocab chunks of ``cfg.ce_block`` (the last
    chunk padded, its pad columns masked); when autograd records each
    chunk is checkpointed, so backward recomputes its logits instead of
    storing them.  Returns the per-token NLL [B, S] in float32."""
    B, S, D = x.shape
    V, block = cfg.vocab_size, cfg.ce_block
    pad = -V % block
    nblk = (V + pad) // block
    W = F.pad(_unembed_weight(cfg, params, x.dtype), (0, pad))
    Wc = W.reshape(D, nblk, block).permute(1, 0, 2)      # (nblk, D, block)
    carry = (torch.full((B, S), -1e30, device=x.device),
             torch.zeros((B, S), device=x.device),
             torch.full((B, S), -1e30, device=x.device))
    remat = records(x, W)
    for i in range(nblk):
        args = (cfg, x, targets, *carry, i, Wc[i])
        carry = (checkpoint(_nll_block, *args, use_reentrant=False)
                 if remat else _nll_block(*args))
    m, s, tgt = carry
    return torch.log(torch.clamp(s, min=1e-30)) + m - tgt


def lm_loss(cfg, params, batch):
    """batch ``{tokens, targets, loss_mask}`` -> (loss, metrics): the mean
    NLL over the mask, through ``blockwise_nll`` when ``cfg.ce_block`` is
    set, else full logits, ``log_softmax`` and a gather."""
    _check_ported(cfg)
    if batch.get("patch_embeds") is not None:
        raise NotImplementedError(f"{cfg.name}: the patch-embedding prefix "
                                  "is not ported (ROADMAP A17.8)")
    targets = batch["targets"]
    x = forward_hidden(cfg, params, batch["tokens"])
    if cfg.ce_block:
        nll = blockwise_nll(cfg, params, x, targets)
    else:
        logp = torch.log_softmax(unembed(cfg, params, x), dim=-1)
        nll = -torch.gather(logp, -1,
                            targets.to(torch.int64)[..., None])[..., 0]
    mask = batch["loss_mask"].to(torch.float32)
    loss = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return loss, {"nll": loss}


def init_cache(cfg, batch: int, max_len: int, device="cuda"):
    """Stacked (n_layers-leading) KV cache, zeros, in the activation
    dtype, with the shared length as an int32 scalar on the device."""
    _check_ported(cfg)
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    dtype = _adtype(cfg)
    return {"blocks": {"k": torch.zeros(shape, dtype=dtype, device=device),
                       "v": torch.zeros(shape, dtype=dtype, device=device)},
            "len": torch.zeros((), dtype=torch.int32, device=device)}


def prefill(cfg, params, tokens, max_len: int):
    """Prompt -> (logits for the last position [B, V], full cache padded
    to ``max_len``)."""
    x = embed_tokens(cfg, params, tokens)
    B, S, _ = x.shape
    if S > max_len:
        raise ValueError(f"prefill: prompt of {S} tokens > max_len {max_len}")
    positions = _positions(x)
    cache = init_cache(cfg, B, max_len, x.device)

    def body(carry, xs):
        lp, k_l, v_l = xs
        y, (k, v) = block_prefill(cfg, lp, carry, positions)
        k_l[:, :, :S] = k
        v_l[:, :, :S] = v
        return y, None

    x, _ = scan_layers(body, x, (params["blocks"], cache["blocks"]["k"],
                                 cache["blocks"]["v"]))
    cache["len"].fill_(S)
    x = apply_norm(cfg.norm_kind, x, params["final_norm"])
    logits = unembed(cfg, params, x[:, -1:])
    return logits[:, 0], cache


# ---------------------------------------------------------------------------
# Decode (one token)
# ---------------------------------------------------------------------------

def block_decode(cfg, lp, x, cache_l):
    """x [B, 1, D]; cache_l: one layer's ``{"k", "v", "len"}``."""
    h = apply_norm(cfg.norm_kind, x, lp["norm1"])
    mix, cache_l = attn_mod.gqa_decode(cfg, lp["mix"], h, cache_l,
                                       window=cfg.sliding_window)
    x = x + mix
    h2 = apply_norm(cfg.norm_kind, x, lp["norm2"])
    return x + mlp_mod.mlp_apply(cfg.mlp_kind, lp["mlp"], h2), cache_l


def decode_step(cfg, params, tokens, cache):
    """tokens [B, 1] -> (logits [B, 1, V], cache).  The cache's k/v are
    written in place at ``len`` (see ``attention.gqa_decode``); the
    returned cache holds the same buffers and ``len + 1``."""
    x = embed_tokens(cfg, params, tokens)
    pos = cache["len"]

    def body(carry, xs):
        lp, k_l, v_l = xs
        return block_decode(cfg, lp, carry, {"k": k_l, "v": v_l, "len": pos})

    x, _ = scan_layers(body, x, (params["blocks"], cache["blocks"]["k"],
                                 cache["blocks"]["v"]))
    x = apply_norm(cfg.norm_kind, x, params["final_norm"])
    return unembed(cfg, params, x), {"blocks": cache["blocks"],
                                     "len": pos + 1}
