"""phi3-medium-14b — RoPE + SwiGLU + GQA (kv=10) [arXiv:2404.14219].

A copy of ``repro/configs/phi3_medium_14b.py``."""
from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="phi3-medium-14b", family="dense",
        n_layers=40, d_model=5120, n_heads=40, n_kv_heads=10,
        d_ff=17920, vocab_size=100352, head_dim=128,
        tie_embeddings=False,
    )
