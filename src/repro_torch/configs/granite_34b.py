"""granite-34b — llama-arch code model, extreme-depth MQA (kv=1)
[arXiv:2405.04324].

A copy of ``repro/configs/granite_34b.py``."""
from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="granite-34b", family="dense",
        n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1,
        d_ff=24576, vocab_size=49152, head_dim=128,
        tie_embeddings=False,
    )
