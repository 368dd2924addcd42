"""Dense MLP variants: SwiGLU (llama-style), GELU (whisper), GeGLU (gemma),
and the RWKV channel-mix with its token shift.

Counterpart of ``repro/models/mlp.py``.  Weights are ``(in, out)``, cast
to the activations' dtype at each product, as the reference does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import gather_fsdp
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
    if kind == "rwkv_cmix":
        return {
            "mu_k": ParamSpec(lead + (d,), lx + ("embed",), init="ones"),
            "w_k": ParamSpec(lead + (d, f), lx + ("embed", "mlp")),
            "w_v": ParamSpec(lead + (f, d), lx + ("mlp", "embed")),
            "mu_r": ParamSpec(lead + (d,), lx + ("embed",), init="ones"),
            "w_r": ParamSpec(lead + (d, d), lx + ("embed", "embed_out")),
        }
    raise ValueError(kind)


def mlp_apply(kind: str, p: dict, x: torch.Tensor,
              x_prev: torch.Tensor | None = None) -> torch.Tensor:
    """x: [B, S, D] -> [B, S, D].  x_prev: the shifted sequence of the
    rwkv channel-mix (the previous token's input at decode), by default
    ``token_shift(x)``."""
    dt = x.dtype
    if kind == "swiglu":
        return (F.silu(x @ p["w_gate"].to(dt))
                * (x @ p["w_up"].to(dt))) @ p["w_down"].to(dt)
    if kind == "geglu":
        return (F.gelu(x @ p["w_gate"].to(dt), approximate="tanh")
                * (x @ p["w_up"].to(dt))) @ p["w_down"].to(dt)
    if kind == "gelu":
        # the biases whole over the FSDP axes (as the norms' params)
        b_up, b_down = gather_fsdp(p["b_up"]), gather_fsdp(p["b_down"])
        h = F.gelu(x @ p["w_up"].to(dt) + b_up.to(dt), approximate="tanh")
        return h @ p["w_down"].to(dt) + b_down.to(dt)
    if kind == "rwkv_cmix":
        if x_prev is None:
            x_prev = token_shift(x)
        xk = x + (x_prev - x) * p["mu_k"].to(dt)
        xr = x + (x_prev - x) * p["mu_r"].to(dt)
        kk = torch.square(F.relu(xk @ p["w_k"].to(dt)))
        return torch.sigmoid(xr @ p["w_r"].to(dt)) * (kk @ p["w_v"].to(dt))
    raise ValueError(kind)


def token_shift(x: torch.Tensor) -> torch.Tensor:
    """RWKV token shift: x_{t-1} with zero at t = 0.  x: [B, S, D].  A
    DTensor shifts on each rank's block with the sequence whole."""
    from repro_torch.distributed import sharding as shd

    if not shd.is_dtensor(x):
        return F.pad(x, (0, 0, 1, 0))[:, :-1]
    from torch.distributed.tensor import Replicate, Shard

    pl = tuple(Replicate() if isinstance(p, Shard) and p.dim == 1 else p
               for p in x.placements)
    return shd.region(token_shift, x.device_mesh, (x,), (pl,), (pl,))
