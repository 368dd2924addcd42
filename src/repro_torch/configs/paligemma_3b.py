"""paligemma-3b — gemma backbone + SigLIP patch-embedding stub
(input_specs provides 256 precomputed patch embeddings); prefix-LM mask
[arXiv:2407.07726].

A copy of ``repro/configs/paligemma_3b.py``."""
from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="paligemma-3b", family="vlm",
        n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1,
        d_ff=16384, vocab_size=257216, head_dim=256,
        mlp_kind="geglu", scale_embed=True,
        vis_prefix_len=256,
        tie_embeddings=True,
    )
