"""hymba-1.5b — parallel attention + mamba heads, SWA with 3 global
layers; meta-tokens omitted (DESIGN.md) [arXiv:2411.13676].

A copy of ``repro/configs/hymba_1_5b.py``."""
from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="hymba-1.5b", family="hybrid",
        n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
        d_ff=5504, vocab_size=32001, head_dim=64,
        block_kind="hybrid", ssm_state=16, ssm_expand=2,
        sliding_window=1024, global_attn_layers=(0, 15, 31),
        tie_embeddings=True,
    )
