"""stablelm-1.6b — MHA (kv=32) [hf:stabilityai/stablelm-2-1_6b].

A copy of ``repro/configs/stablelm_1_6b.py``."""
from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="stablelm-1.6b", family="dense",
        n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
        d_ff=5632, vocab_size=100352, head_dim=64,
        norm_kind="layernorm",
        tie_embeddings=True,
    )
