"""Serving: batched prefill/decode engine over the port's KV caches."""
from repro_torch.serving.engine import Engine, GenerationResult

__all__ = ["Engine", "GenerationResult"]
