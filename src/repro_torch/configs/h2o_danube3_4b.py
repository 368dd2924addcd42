"""h2o-danube-3-4b — llama+mistral mix with sliding-window attention
[arXiv:2401.16818].

A copy of ``repro/configs/h2o_danube3_4b.py``."""
from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="h2o-danube-3-4b", family="dense",
        n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8,
        d_ff=10240, vocab_size=32000, head_dim=120,
        sliding_window=4096,
        tie_embeddings=True,
    )
