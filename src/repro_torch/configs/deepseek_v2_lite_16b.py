"""deepseek-v2-lite-16b — MLA (kv_lora=512) + fine-grained MoE.

Pool entry lists both "64e top-6" and "2 shared+160 routed"; the
reference follows the primary field (64 routed, top-6, 2 shared)
[arXiv:2405.04434].

A copy of ``repro/configs/deepseek_v2_lite_16b.py``; as there, the
shard_map dispatch needs a mesh, and one card takes the scatter
dispatch."""
from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="deepseek-v2-lite-16b", family="moe",
        n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=10944, vocab_size=102400,
        attn_kind="mla", kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
        v_head_dim=128, head_dim=192,
        n_experts=64, n_shared_experts=2, moe_top_k=6, moe_d_ff=1408,
        first_dense_layers=1, moe_dispatch="shard_map",
        tie_embeddings=False,
    )
