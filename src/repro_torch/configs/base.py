"""Architecture config schema, a copy of ``repro/configs/base.py``.

One frozen dataclass describes every architecture of the reference's
model zoo, and the port reads every field the reference's model path
reads, so a config means the same in both packages.  ``reduced()`` gives
the same tiny variant as the reference's, for the CPU tests.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: int = 0              # 0 -> d_model // n_heads
    block_kind: str = "attn"       # attn | rwkv | hybrid
    attn_kind: str = "gqa"         # gqa | mla
    mlp_kind: str = "swiglu"       # swiglu | gelu | geglu | rwkv_cmix
    norm_kind: str = "rmsnorm"     # rmsnorm | layernorm

    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None    # uniform SWA window
    global_attn_every: int = 0              # hymba: n layers forced global
    global_attn_layers: Tuple[int, ...] = ()

    # --- MLA (deepseek-v2) ---
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # --- MoE (deepseek fine-grained) ---
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0              # per-expert hidden
    first_dense_layers: int = 0    # leading dense-MLP layers
    capacity_factor: float = 1.25
    moe_groups: int = 32           # token groups (= data shards) for
                                   # shard-local dispatch positions
    moe_dispatch: str = "scatter"  # "shard_map": explicit-collective dispatch

    # --- SSM ---
    ssm_state: int = 0             # mamba/rwkv head state size
    rwkv_head_dim: int = 64
    ssm_expand: int = 2            # mamba d_inner = expand * d_model
    ssm_conv: int = 4

    # --- hybrid (hymba) ---
    attn_ratio: float = 0.5        # fraction of d mapped through attention path

    # --- encoder-decoder (whisper) ---
    n_enc_layers: int = 0
    enc_seq: int = 0               # stub frontend frames (whisper: 1500)

    # --- VLM (paligemma) ---
    vis_prefix_len: int = 0        # stub patch embeddings (paligemma: 256)

    # --- training knobs ---
    param_dtype: str = "float32"   # "bfloat16" -> bf16 params + fp32 master
    ce_block: int = 0              # >0: blockwise cross-entropy chunk size
    scale_embed: bool = False      # gemma-style sqrt(d) embedding scale
    tie_embeddings: bool = True
    dtype: str = "bfloat16"        # activation/param compute dtype
    q_block: int = 512             # chunked-attention block sizes
    kv_block: int = 1024
    attn_block_skip: bool = True   # skip fully-masked causal/window blocks
    rwkv_chunk: int = 128
    rwkv_mode: str = "chunked"     # chunked | recurrent
    remat: bool = True
    logit_softcap: float = 0.0
    # analysis-only: python-loop over layers instead of lax.scan, so that
    # XLA cost_analysis (which counts while-bodies ONCE) reports true
    # per-step totals. Production builds keep scan (depth-free HLO).
    unroll_layers: bool = False

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def is_causal_lm(self) -> bool:
        return self.family not in ("audio",)

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic token mixing -> long_500k cell is runnable."""
        return (self.block_kind in ("rwkv", "hybrid")
                or self.sliding_window is not None)

    def reduced(self, **overrides) -> "ArchConfig":
        """Tiny same-family variant for CPU smoke tests."""
        small = dict(
            n_layers=2, d_model=64,
            n_heads=max(2, min(4, self.n_heads)),
            n_kv_heads=1 if self.n_kv_heads == 1 else 2,
            d_ff=128, vocab_size=256, head_dim=16,
        )
        if self.n_experts:
            small.update(n_experts=8, moe_top_k=2, moe_d_ff=32,
                         n_shared_experts=min(self.n_shared_experts, 1))
        if self.kv_lora_rank:
            small.update(kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8,
                         v_head_dim=16)
        if self.n_enc_layers:
            small.update(n_enc_layers=2, enc_seq=16)
        if self.vis_prefix_len:
            small.update(vis_prefix_len=8)
        if self.sliding_window:
            small.update(sliding_window=32)
        if self.block_kind in ("rwkv", "hybrid"):
            small.update(rwkv_head_dim=16, ssm_state=8)
        small.update(q_block=32, kv_block=32, rwkv_chunk=16)
        small.update(overrides)
        return dataclasses.replace(self, **small)
