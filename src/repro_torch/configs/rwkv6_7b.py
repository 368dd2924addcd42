"""rwkv6-7b — Finch: attention-free, data-dependent decay [arXiv:2404.05892].

A copy of ``repro/configs/rwkv6_7b.py``."""
from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="rwkv6-7b", family="ssm",
        n_layers=32, d_model=4096, n_heads=64, n_kv_heads=64,
        d_ff=14336, vocab_size=65536,
        block_kind="rwkv", mlp_kind="rwkv_cmix", norm_kind="layernorm",
        rwkv_head_dim=64, ssm_state=64,
        tie_embeddings=False,
    )
