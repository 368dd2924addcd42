"""deepseek-moe-16b — fine-grained MoE: 2 shared + 64 routed top-6,
first layer dense (d_ff=10944) [arXiv:2401.06066].

A copy of ``repro/configs/deepseek_moe_16b.py``.  ``moe_dispatch`` names
the reference's shard_map dispatch, which it takes only under an active
mesh; one card has none, so both packages take the scatter dispatch."""
from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="deepseek-moe-16b", family="moe",
        n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=10944, vocab_size=102400, head_dim=128,
        n_experts=64, n_shared_experts=2, moe_top_k=6, moe_d_ff=1408,
        first_dense_layers=1, moe_dispatch="shard_map",
        tie_embeddings=False,
    )
