"""Dense MLP variants: SwiGLU (llama-style), GELU (whisper), GeGLU (gemma).

Counterpart of ``repro/models/mlp.py``; the RWKV channel-mix waits for
the rwkv slice.  Weights are ``(in, out)``, cast to the activations'
dtype at each product, as the reference does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import ParamSpec


def mlp_specs(kind: str, d: int, f: int, stacked: int | None) -> dict:
    lead = (stacked,) if stacked else ()
    lx = ("layers",) if stacked else ()
    if kind in ("swiglu", "geglu"):
        return {
            "w_gate": ParamSpec(lead + (d, f), lx + ("embed", "mlp")),
            "w_up": ParamSpec(lead + (d, f), lx + ("embed", "mlp")),
            "w_down": ParamSpec(lead + (f, d), lx + ("mlp", "embed")),
        }
    if kind == "gelu":
        return {
            "w_up": ParamSpec(lead + (d, f), lx + ("embed", "mlp")),
            "b_up": ParamSpec(lead + (f,), lx + ("mlp",), init="zeros"),
            "w_down": ParamSpec(lead + (f, d), lx + ("mlp", "embed")),
            "b_down": ParamSpec(lead + (d,), lx + ("embed",), init="zeros"),
        }
    raise NotImplementedError(f"mlp kind {kind!r} is not ported yet")


def mlp_apply(kind: str, p: dict, x: torch.Tensor) -> torch.Tensor:
    """x: [B, S, D] -> [B, S, D]."""
    dt = x.dtype
    if kind == "swiglu":
        return (F.silu(x @ p["w_gate"].to(dt))
                * (x @ p["w_up"].to(dt))) @ p["w_down"].to(dt)
    if kind == "geglu":
        return (F.gelu(x @ p["w_gate"].to(dt), approximate="tanh")
                * (x @ p["w_up"].to(dt))) @ p["w_down"].to(dt)
    if kind == "gelu":
        h = F.gelu(x @ p["w_up"].to(dt) + p["b_up"].to(dt),
                   approximate="tanh")
        return h @ p["w_down"].to(dt) + p["b_down"].to(dt)
    raise NotImplementedError(f"mlp kind {kind!r} is not ported yet")
