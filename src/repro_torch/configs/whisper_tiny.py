"""whisper-tiny — enc-dec backbone; conv/audio frontend is a stub
(input_specs provides precomputed frame embeddings) [arXiv:2212.04356].

A copy of ``repro/configs/whisper_tiny.py``."""
from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="whisper-tiny", family="audio",
        n_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
        d_ff=1536, vocab_size=51865, head_dim=64,
        norm_kind="layernorm", mlp_kind="gelu",
        n_enc_layers=4, enc_seq=1500,
        tie_embeddings=True,
    )
