"""Decoder-only LM assembly: one stack of blocks covering every decoder
family of the zoo.

Counterpart of ``repro/models/transformer.py``.  Block kinds: ``attn``
(GQA/MQA/MHA, or MLA with its latent cache), ``rwkv`` (the Finch
time-mix of ``rwkv6.py`` with the rwkv channel-mix) and ``hybrid``
(hymba: GQA and a Mamba head in parallel on the same input, each
normed, averaged).  MLPs: dense (swiglu / gelu / geglu), the
fine-grained MoE, the rwkv channel-mix.  A uniform sliding window or
per-layer windows (``layer_windows``: host ints, ``GLOBAL_WINDOW`` on
the global layers, which the kernels take as no window), and the VLM's
patch prefix (``extra_embeds``: the embeddings go before the text and
the prefix-LM mask covers them at forward and prefill; decode passes no
prefix, as the reference's does).  Layers are stored stacked on a
leading "layers" dim, as in the reference, with deepseek's
``first_dense_layers`` in a second stack (``dense_blocks``), run first;
a Python loop runs each stack, and with ``cfg.remat`` each block is
checkpointed when autograd records, as the reference's scan remats
each.  The MoE blocks' metrics (``moe_lb_loss``, ``moe_z_loss``,
``moe_drop_frac``) are averaged over the stack's layers, and
``lm_loss`` adds the reference's aux terms.  Under the sharding rules
the params and inputs are DTensors (``distributed/sharding.py``), and
the reference's two ``logical_constraint``s (each block's input, the
logits) redistribute them.  The encoder-decoder (whisper) is
``encdec.py``.

Caches are buffers the port owns, written in place: k and v (or MLA's
latent) at ``len``; the rwkv block's float32 state and the last token's
time-mix and channel-mix inputs (``x_prev``, ``cx_prev``); the hybrid
block's k and v, Mamba state (float32) and conv inputs.

Entry points:
  forward()      full-sequence logits
  lm_loss()      the training loss (full logits or ``blockwise_nll``)
  prefill()      forward + cache construction (serving)
  decode_step()  one token with the cache
"""
from __future__ import annotations

import itertools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.distributed.sharding import (active_rules, copy_into,
                                              distribute, is_dtensor,
                                              local_block,
                                              logical_constraint,
                                              recompute_context, region,
                                              settle, settle_grad, zeros)
from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv6 as rwkv_mod
from repro_torch.models.attention import GLOBAL_WINDOW, records
from repro_torch.models.common import (ParamSpec, apply_norm, norm_spec,
                                       scan_layers, softcap)
from repro_torch.models.qhead import tree_leaves

# the two stacks, in the order they run: (name, dense MLP)
STACKS = (("dense_blocks", True), ("blocks", False))


def _check_block(cfg) -> None:
    """Refuse a block or attention kind the reference's zoo does not
    have (the reference would run it as GQA)."""
    if cfg.block_kind not in ("attn", "rwkv", "hybrid") or (
            cfg.attn_kind not in ("gqa", "mla")):
        raise ValueError(f"{cfg.name}: unknown block {cfg.block_kind!r} / "
                         f"attention {cfg.attn_kind!r}")


# ---------------------------------------------------------------------------
# Param specs
# ---------------------------------------------------------------------------

def _mix_specs(cfg, L: int) -> dict:
    if cfg.block_kind == "rwkv":
        return rwkv_mod.rwkv_specs(cfg, L)
    if cfg.block_kind == "hybrid":
        d_inner = cfg.ssm_expand * cfg.d_model
        return {
            "attn": attn_mod.gqa_specs(cfg, L),
            "mamba": mamba_mod.mamba_specs(cfg, L, cfg.d_model, d_inner),
            "norm_attn": norm_spec(cfg.norm_kind, cfg.d_model, L),
            "norm_mamba": norm_spec(cfg.norm_kind, cfg.d_model, L),
        }
    if cfg.attn_kind == "mla":
        return attn_mod.mla_specs(cfg, L)
    return attn_mod.gqa_specs(cfg, L)


def _mlp_specs(cfg, L: int, dense: bool) -> dict:
    if cfg.n_experts and not dense:
        return moe_mod.moe_specs(cfg, L)
    return mlp_mod.mlp_specs(cfg.mlp_kind, cfg.d_model, cfg.d_ff, L)


def _block_specs(cfg, L: int, dense_mlp: bool) -> dict:
    return {
        "norm1": norm_spec(cfg.norm_kind, cfg.d_model, L),
        "mix": _mix_specs(cfg, L),
        "norm2": norm_spec(cfg.norm_kind, cfg.d_model, L),
        "mlp": _mlp_specs(cfg, L, dense_mlp),
    }


def _n_dense(cfg) -> int:
    return cfg.first_dense_layers if cfg.n_experts else 0


def lm_param_specs(cfg) -> dict:
    _check_block(cfg)
    n_dense = _n_dense(cfg)
    specs = {
        "embed": ParamSpec((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                           init="embed"),
        "blocks": _block_specs(cfg, cfg.n_layers - n_dense, dense_mlp=False),
        "final_norm": norm_spec(cfg.norm_kind, cfg.d_model),
    }
    if n_dense:
        specs["dense_blocks"] = _block_specs(cfg, n_dense, dense_mlp=True)
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab_size),
                                     ("embed", "vocab"))
    return specs


def layer_windows(cfg) -> list | None:
    """Per-layer attention windows as host ints, or None if attention is
    uniform: ``GLOBAL_WINDOW`` on ``global_attn_layers``, the sliding
    window elsewhere."""
    if not cfg.global_attn_layers:
        return None
    return [GLOBAL_WINDOW if i in cfg.global_attn_layers
            else cfg.sliding_window for i in range(cfg.n_layers)]


def _stack_windows(cfg, dense_mlp: bool):
    """The windows of a stack's layers, in order: the per-layer windows on
    the main stack, ``cfg.sliding_window`` elsewhere (as the reference's
    scans pass them)."""
    windows = None if dense_mlp else layer_windows(cfg)
    return (itertools.repeat(cfg.sliding_window) if windows is None
            else iter(windows))


# ---------------------------------------------------------------------------
# Embedding and unembedding
# ---------------------------------------------------------------------------

def _adtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def lookup(table, tokens):
    """``table[tokens]``.  On a DTensor table (the rules split its vocab
    over "model") the vocab-parallel form in a ``local_map`` region:
    each rank takes the rows its vocab block holds, zeros elsewhere, and
    one all-reduce over the vocab's mesh dims sums them (one rank's row
    and zeros: exact), so the table is never gathered."""
    if not is_dtensor(table):
        return table[tokens]
    from torch.distributed.tensor import Partial, Replicate, Shard

    rules = active_rules()
    mesh = table.device_mesh
    V = table.shape[0]
    t_pl = rules.placements(rules.divisible_spec(("vocab", None),
                                                 table.shape))
    vocab = {i for i, p in enumerate(t_pl) if isinstance(p, Shard)}
    tokens = distribute(tokens, ("batch",) + (None,) * (tokens.ndim - 1))
    k_pl = tuple(Replicate() if i in vocab or not isinstance(p, Shard)
                 or p.dim != 0 else p
                 for i, p in enumerate(tokens.placements))
    off, n = local_block(mesh, t_pl, 0, V)

    def local(tl, kl):
        at = kl.to(torch.int64) - off
        hit = (at >= 0) & (at < n)
        rows = tl[at.clamp(0, n - 1)]
        return torch.where(hit[..., None], rows, torch.zeros((), dtype=
                                                             rows.dtype))

    out_pl = tuple(Partial() if i in vocab else p for i, p in enumerate(k_pl))
    rows = region(local, mesh, (settle_grad(table), tokens), (t_pl, k_pl),
                  (out_pl,))
    return rows.redistribute(mesh, k_pl)  # one all-reduce of the rows


def embed_tokens(cfg, params, tokens):
    # gather, then cast: the reference's cast-then-gather, without a cast
    # of the whole table
    x = lookup(params["embed"], tokens).to(_adtype(cfg))
    if getattr(cfg, "scale_embed", False):
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def _embed(cfg, params, tokens, extra_embeds):
    """The token embeddings, after ``extra_embeds`` [B, P, D] when given
    (the VLM's patch prefix); returns (x, the prefix length or None)."""
    x = embed_tokens(cfg, params, tokens)
    if extra_embeds is None:
        return x, None
    return (torch.cat([extra_embeds.to(x.dtype), x], dim=1),
            extra_embeds.shape[1])


def unembed(cfg, params, x):
    """x: [B, S, D] -> float32 logits [B, S, V], constrained to the rules'
    ("batch", "seq_out", "vocab") split."""
    logits = x @ _unembed_weight(cfg, params, x.dtype)
    logits = softcap(logits.to(torch.float32), cfg.logit_softcap)
    return logical_constraint(logits, ("batch", "seq_out", "vocab"))


# ---------------------------------------------------------------------------
# One block, full sequence: forward and prefill
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


def _mlp_apply(cfg, lp, h, dense_mlp: bool):
    """The block's MLP: (out, metrics), the MoE's metrics or none."""
    if cfg.n_experts and not dense_mlp:
        return moe_mod.moe_apply(cfg, lp, h)
    return mlp_mod.mlp_apply(cfg.mlp_kind, lp, h), {}


def _hybrid_mix(cfg, lp, a, m):
    """hymba's mix: the attention and Mamba outputs, each normed,
    averaged."""
    a = apply_norm(cfg.norm_kind, a, lp["norm_attn"])
    m = apply_norm(cfg.norm_kind, m, lp["norm_mamba"])
    return 0.5 * (a + m)


def _mix_prefill(cfg, lp, h, positions, window, prefix_len):
    """The block's token mix over the full sequence: (out, this layer's
    cache entries, unpadded: k and v [B, Hkv, S, Hd], MLA's latent [B, S,
    r + rdim], the rwkv state and last input, the Mamba state and conv
    inputs)."""
    causal = cfg.is_causal_lm
    if cfg.block_kind == "rwkv":
        y, state = rwkv_mod.rwkv_apply(cfg, lp, h)
        return y, {"state": state, "x_prev": h[:, -1:]}
    skip = _static_skip_info(cfg, causal, window, prefix_len)
    mask = {"causal": causal, "window": window, "prefix_len": prefix_len,
            "skip_info": skip}
    if cfg.block_kind == "hybrid":
        a, (k, v) = attn_mod.gqa_apply(cfg, lp["attn"], h, positions,
                                       return_kv=True, **mask)
        m, mc = mamba_mod.mamba_apply(cfg, lp["mamba"], h, return_cache=True)
        return _hybrid_mix(cfg, lp, a, m), {
            "k": k, "v": v, "mamba_h": mc["h"], "mamba_conv": mc["conv"]}
    if cfg.attn_kind == "mla":
        y, lat = attn_mod.mla_apply(cfg, lp, h, positions,
                                    return_latent=True, **mask)
        return y, {"latent": lat}
    y, (k, v) = attn_mod.gqa_apply(cfg, lp, h, positions, return_kv=True,
                                   **mask)
    return y, {"k": k, "v": v}


def block_prefill(cfg, lp, x, positions, window, prefix_len=None,
                  dense_mlp=False):
    """One block over the full sequence; returns (x, metrics, this
    layer's cache entries, as ``_mix_prefill`` gives them, with the rwkv
    channel-mix's last input ``cx_prev``)."""
    h = apply_norm(cfg.norm_kind, x, lp["norm1"])
    mix, entry = _mix_prefill(cfg, lp["mix"], h, positions, window,
                              prefix_len)
    x = x + mix
    h2 = apply_norm(cfg.norm_kind, x, lp["norm2"])
    out, metrics = _mlp_apply(cfg, lp["mlp"], h2, dense_mlp)
    if cfg.block_kind == "rwkv":
        entry["cx_prev"] = h2[:, -1:]
    return x + out, metrics, entry


def block_apply(cfg, lp, x, positions, window, prefix_len=None,
                dense_mlp=False):
    """One block over the full sequence (training / forward): (x,
    metrics), the input constrained to the rules' ("batch", "seq")
    split as the reference's is."""
    x = logical_constraint(x, ("batch", "seq", None))
    return block_prefill(cfg, lp, x, positions, window, prefix_len,
                         dense_mlp)[:2]


def _scan_blocks(cfg, blocks, x, positions, prefix_len, dense_mlp: bool):
    """Run one stack of blocks: (x, each metric's mean over the layers).
    When autograd records and ``cfg.remat`` is set, each block is
    checkpointed: backward keeps its input and recomputes the rest."""
    windows = _stack_windows(cfg, dense_mlp)

    def body(carry, lp):
        args = (cfg, lp, carry, positions, next(windows), prefix_len,
                dense_mlp)
        if cfg.remat and records(carry, *tree_leaves(lp)):
            return checkpoint(block_apply, *args, use_reentrant=False,
                              context_fn=recompute_context)
        return block_apply(*args)

    x, per_layer = scan_layers(body, x, blocks)
    return x, {k: torch.stack([m[k] for m in per_layer]).mean()
               for k in per_layer[0]}


def forward_hidden(cfg, params, tokens, *, extra_embeds=None):
    """tokens [B, S] (after ``extra_embeds`` [B, P, D], the patch prefix,
    when given) -> (final-norm hidden states [B, P + S, D], the blocks'
    metrics), ``dense_blocks`` first."""
    x, prefix_len = _embed(cfg, params, tokens, extra_embeds)
    positions = _positions(x)
    metrics = {}
    for name, dense_mlp in STACKS:
        if name in params:
            x, m = _scan_blocks(cfg, params[name], x, positions, prefix_len,
                                dense_mlp)
            metrics.update(m)
    return apply_norm(cfg.norm_kind, x, params["final_norm"]), metrics


def forward(cfg, params, tokens, *, extra_embeds=None):
    """tokens [B, S] (and the patch prefix) -> logits [B, P + S, V] (the
    reference's ``forward`` also returns the metrics, which
    ``forward_hidden`` gives)."""
    return unembed(cfg, params, forward_hidden(
        cfg, params, tokens, extra_embeds=extra_embeds)[0])


def _unembed_weight(cfg, params, dtype):
    """The unembedding as a (D, V) matrix in ``dtype``.  A tied table's
    gradient from here is summed before autograd adds the lookup's
    (``settle_grad``: torch 2.11's DTensor cannot add a partial and a
    split gradient)."""
    if cfg.tie_embeddings:
        return settle_grad(params["embed"]).to(dtype).T
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
        carry = (checkpoint(_nll_block, *args, use_reentrant=False,
                            context_fn=recompute_context)
                 if remat else _nll_block(*args))
    m, s, tgt = carry
    return torch.log(torch.clamp(s, min=1e-30)) + m - tgt


def token_nll(logits, targets):
    """-log softmax(logits)[target]: logits [B, S, V] float32, targets
    [B, S] -> [B, S].  A DTensor's logits split over the vocab (the
    rules' "vocab" -> "model") take the vocab-parallel form in a
    ``local_map`` region: each rank's max, exp-sum and target logit of
    its vocab block, combined by all-reduces over the vocab's mesh dims,
    so the [B, S, V] logits are never gathered."""
    if not is_dtensor(logits):
        logp = torch.log_softmax(logits, dim=-1)
        return -torch.gather(logp, -1,
                             targets.to(torch.int64)[..., None])[..., 0]
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh, pl = logits.device_mesh, tuple(logits.placements)
    V = logits.shape[-1]
    vocab_dims = [i for i, p in enumerate(pl)
                  if isinstance(p, Shard) and p.dim == 2]
    row = tuple(p if isinstance(p, Shard) and p.dim < 2 else Replicate()
                for p in pl)
    off = local_block(mesh, pl, 2, V)[0]

    def local(lg, tg):
        from torch.distributed import _functional_collectives as funcol

        def over_vocab(t, op):
            for i in vocab_dims:
                t = funcol.all_reduce(t, op, (mesh, i))
            return t

        with torch.no_grad():  # a shift for stability: no gradient
            m = over_vocab(lg.amax(-1), "max")
        sumexp = _VocabSum.apply(torch.exp(lg - m[..., None]).sum(-1),
                                 over_vocab)
        loc = tg.to(torch.int64) - off
        hit = (loc >= 0) & (loc < lg.shape[-1])
        t = torch.gather(lg, -1, loc.clamp(0, lg.shape[-1] - 1)[..., None])
        t = _VocabSum.apply(torch.where(hit, t[..., 0], 0.0), over_vocab)
        return torch.log(sumexp) + m - t

    return local_map(local, out_placements=(row,),
                     in_placements=(pl, row), device_mesh=mesh,
                     redistribute_inputs=True)(logits, targets)


class _VocabSum(torch.autograd.Function):
    """A sum over the vocab's mesh dims whose result every rank holds:
    backward hands each rank's block the result's gradient (the same on
    every rank)."""

    @staticmethod
    def forward(ctx, t, over_vocab):
        return over_vocab(t, "sum")

    @staticmethod
    def backward(ctx, g):
        return g, None


def lm_loss(cfg, params, batch):
    """batch ``{tokens, targets, loss_mask, [patch_embeds]}`` -> (loss,
    metrics): the mean NLL over the mask, through ``blockwise_nll`` when
    ``cfg.ce_block`` is set, else full logits, ``log_softmax`` and a
    gather; with a patch prefix, on the text positions only; an MoE adds
    ``0.01 * moe_lb_loss + 1e-3 * moe_z_loss``, and ``nll`` holds that
    sum, as the reference's does."""
    extra = batch.get("patch_embeds")
    targets = batch["targets"]
    x, metrics = forward_hidden(cfg, params, batch["tokens"],
                                extra_embeds=extra)
    if extra is not None:  # hidden over [prefix + text]; train on text
        x = x[:, extra.shape[1]:]
    if cfg.ce_block:
        nll = blockwise_nll(cfg, params, x, targets)
    else:
        nll = token_nll(unembed(cfg, params, x), targets)
    mask = batch["loss_mask"].to(torch.float32)
    # the sums whole before the divide (torch 2.11 cannot divide a split
    # or partial sum's gradient)
    loss = settle((nll * mask).sum()) / torch.clamp(settle(mask.sum()),
                                                   min=1.0)
    if "moe_lb_loss" in metrics:
        loss = (loss + 0.01 * metrics["moe_lb_loss"]
                + 1e-3 * metrics["moe_z_loss"])
    return loss, dict(metrics, nll=loss)


# ---------------------------------------------------------------------------
# Caches, prefill and decode
# ---------------------------------------------------------------------------

def _layer_cache_shapes(cfg, batch: int, max_len: int) -> dict:
    """ONE layer's cache (the stack's dim added by the caller): {name:
    (shape, dtype)}.  The rwkv block's float32 state and its two last
    inputs; the hybrid block's k, v, float32 Mamba state and conv inputs;
    MLA's latent; else k and v."""
    dt, f32 = _adtype(cfg), torch.float32
    D = cfg.d_model
    if cfg.block_kind == "rwkv":
        N = cfg.rwkv_head_dim
        return {"state": ((batch, D // N, N, N), f32),
                "x_prev": ((batch, 1, D), dt),
                "cx_prev": ((batch, 1, D), dt)}
    kv = (batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    if cfg.block_kind == "hybrid":
        d_inner = cfg.ssm_expand * D
        return {"k": (kv, dt), "v": (kv, dt),
                "mamba_h": ((batch, d_inner, cfg.ssm_state), f32),
                "mamba_conv": ((batch, cfg.ssm_conv - 1, d_inner), dt)}
    if cfg.attn_kind == "mla":
        return {"latent": ((batch, max_len, cfg.kv_lora_rank
                            + cfg.qk_rope_dim), dt)}
    return {"k": (kv, dt), "v": (kv, dt)}


def cache_axes(cfg) -> dict:
    """Logical axes of one layer's cache entries (the stack's "layers"
    added by the caller); the kv sequence takes "kv_seq", which the serve
    rules map to "model" (split-KV decode)."""
    if cfg.block_kind == "rwkv":
        return {"state": ("batch", "heads", None, None),
                "x_prev": ("batch", None, "embed_act"),
                "cx_prev": ("batch", None, "embed_act")}
    if cfg.block_kind == "hybrid":
        return {"k": ("batch", None, "kv_seq", None),
                "v": ("batch", None, "kv_seq", None),
                "mamba_h": ("batch", "qkv", None),
                "mamba_conv": ("batch", None, "qkv")}
    if cfg.attn_kind == "mla":
        return {"latent": ("batch", "kv_seq", None)}
    return {"k": ("batch", None, "kv_seq", None),
            "v": ("batch", None, "kv_seq", None)}


def init_cache(cfg, batch: int, max_len: int, device="cuda", rules=None):
    """The stacked caches (``blocks``, and ``dense_blocks`` for deepseek's
    leading dense layers), zeros (each in its dtype), with the shared
    length as an int32 scalar on the device.  With ``rules``, each leaf
    a DTensor placed by ``cache_axes`` (each rank allocates its block)."""
    _check_block(cfg)
    device = resolve_device(device)
    one = _layer_cache_shapes(cfg, batch, max_len)
    axes = cache_axes(cfg)
    n_dense = _n_dense(cfg)

    def stack(n):
        return {k: zeros((n,) + sh, dt, ("layers",) + axes[k], device, rules)
                for k, (sh, dt) in one.items()}

    cache = {"blocks": stack(cfg.n_layers - n_dense),
             "len": zeros((), torch.int32, (), device, rules)}
    if n_dense:
        cache["dense_blocks"] = stack(n_dense)
    return cache


def _write_entry(cache_l, entry: dict) -> None:
    """Write one layer's prefill entries into its cache: k and v at
    positions [0, S), the latent likewise, every other entry whole."""
    for name, t in entry.items():
        if name in ("k", "v", "latent"):
            attn_mod.write_prefix(cache_l[name], 1 if name == "latent" else 2,
                                  t)
        else:
            copy_into(cache_l[name], t)


def prefill(cfg, params, tokens, max_len: int, *, extra_embeds=None):
    """Prompt (after the patch prefix ``extra_embeds`` when given, under
    the prefix-LM mask) -> (logits for the last position [B, V], full
    cache padded to ``max_len``)."""
    x, prefix_len = _embed(cfg, params, tokens, extra_embeds)
    B, S, _ = x.shape
    if S > max_len:
        raise ValueError(f"prefill: prompt of {S} tokens > max_len {max_len}")
    positions = _positions(x)
    cache = init_cache(cfg, B, max_len, x.device,
                       active_rules() if is_dtensor(x) else None)

    for name, dense_mlp in STACKS:
        if name not in params:
            continue
        windows = _stack_windows(cfg, dense_mlp)

        def body(carry, xs, dense_mlp=dense_mlp, windows=windows):
            lp, cache_l = xs
            y, _, entry = block_prefill(cfg, lp, carry, positions,
                                        next(windows), prefix_len, dense_mlp)
            _write_entry(cache_l, entry)
            return y, None

        x, _ = scan_layers(body, x, (params[name], cache[name]))
    cache["len"].fill_(S)
    x = apply_norm(cfg.norm_kind, x, params["final_norm"])
    logits = unembed(cfg, params, x[:, -1:])
    return logits[:, 0], cache


def _mix_decode(cfg, lp, h, cache_l, pos, window):
    """The block's token mix for one token; writes this layer's cache in
    place (k and v or the latent at ``pos``, the rwkv state and last
    input, the Mamba state and conv inputs)."""
    if cfg.block_kind == "rwkv":
        y, st = rwkv_mod.rwkv_decode(cfg, lp, h, cache_l)
        copy_into(cache_l["state"], st["state"])
        copy_into(cache_l["x_prev"], h)
        return y
    if cfg.block_kind == "hybrid":
        a, _ = attn_mod.gqa_decode(cfg, lp["attn"], h,
                                   {"k": cache_l["k"], "v": cache_l["v"],
                                    "len": pos}, window=window)
        m, mc = mamba_mod.mamba_apply(cfg, lp["mamba"], h, cache={
            "h": cache_l["mamba_h"], "conv": cache_l["mamba_conv"]})
        copy_into(cache_l["mamba_h"], mc["h"])
        copy_into(cache_l["mamba_conv"], mc["conv"])
        return _hybrid_mix(cfg, lp, a, m)
    decode = (attn_mod.mla_decode if cfg.attn_kind == "mla"
              else attn_mod.gqa_decode)
    return decode(cfg, lp, h, {**cache_l, "len": pos}, window=window)[0]


def block_decode(cfg, lp, x, cache_l, pos, window, dense_mlp=False):
    """x [B, 1, D]; cache_l: one layer's cache entries (written in
    place); pos: the int32 length on the card."""
    h = apply_norm(cfg.norm_kind, x, lp["norm1"])
    x = x + _mix_decode(cfg, lp["mix"], h, cache_l, pos, window)
    h2 = apply_norm(cfg.norm_kind, x, lp["norm2"])
    if cfg.block_kind == "rwkv":
        out = mlp_mod.mlp_apply("rwkv_cmix", lp["mlp"], h2,
                                x_prev=cache_l["cx_prev"])
        copy_into(cache_l["cx_prev"], h2)
    else:
        out, _ = _mlp_apply(cfg, lp["mlp"], h2, dense_mlp)
    return x + out


def decode_step(cfg, params, tokens, cache):
    """tokens [B, 1] -> (logits [B, 1, V], cache).  Each layer's cache is
    written in place (see ``_mix_decode``); the returned cache holds the
    same buffers and ``len + 1``."""
    x = embed_tokens(cfg, params, tokens)
    pos = cache["len"]
    for name, dense_mlp in STACKS:
        if name not in params:
            continue
        windows = _stack_windows(cfg, dense_mlp)

        def body(carry, xs, dense_mlp=dense_mlp, windows=windows):
            lp, cache_l = xs
            return block_decode(cfg, lp, carry, cache_l, pos, next(windows),
                                dense_mlp), None

        x, _ = scan_layers(body, x, (params[name], cache[name]))
    x = apply_norm(cfg.norm_kind, x, params["final_norm"])
    return unembed(cfg, params, x), {**cache, "len": pos + 1}
