"""Shared model machinery: param specs, init, norms, RoPE, sinusoidal
positions.

Counterpart of ``repro/models/common.py``.  Parameters are plain nested
dicts of tensors, declared by :class:`ParamSpec` leaves (shape, logical
axes, init law, dtype) in the reference's layout: weights ``(in, out)``,
per-layer params stacked on a leading "layers" dim.  One card needs no
mesh, so only the dry run reads the logical axes (``launch/dryrun.py``:
each leaf's shard shape under the rules of ``distributed/sharding.py``).
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from repro_torch import resolve_device


class ParamSpec(NamedTuple):
    shape: tuple
    axes: tuple                 # logical axis name (or None) per dim
    init: str = "normal"        # normal | zeros | ones | embed
    scale: float = 1.0          # extra multiplier on the init std
    dtype: torch.dtype = torch.float32


def map_specs(fn, specs: Any) -> Any:
    """Apply ``fn`` to every ParamSpec leaf of a nested dict."""
    if isinstance(specs, dict):
        return {k: map_specs(fn, v) for k, v in specs.items()}
    return fn(specs)


def _init_leaf(gen: torch.Generator, spec: ParamSpec,
               device: torch.device) -> torch.Tensor:
    """The reference's ``_init_leaf`` laws: zeros, ones, ``embed`` (std
    ``scale``) and the fan-in-scaled normal (std ``scale / sqrt(fan_in)``,
    fan-in the last-but-one dim, so stacked layers keep their own).  The
    draw is scaled in place and cast only when the spec's dtype is not
    float32, so a float32 leaf exists once: deepseek-moe-16b's stacked
    expert weights are 19.9 GB each."""
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "embed":
        std = 1.0 * spec.scale
    else:
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        std = spec.scale / math.sqrt(max(fan_in, 1))
    x = torch.randn(spec.shape, generator=gen, device=device,
                    dtype=torch.float32).mul_(std)
    return x if spec.dtype == torch.float32 else x.to(spec.dtype)


def init_params(gen: torch.Generator, specs: Any, device="cuda") -> Any:
    """Materialise a ParamSpec tree on ``device``, leaf by leaf in the
    reference's leaf order (``jax.tree.flatten``'s: dict keys sorted).
    ``gen`` must be a generator on that device.  The draws are torch's,
    so the values differ from the reference's; the laws are the same."""
    device = resolve_device(device)
    gdev = gen.device
    if gdev.type != device.type or (
            gdev.index is not None and device.index is not None
            and gdev.index != device.index):
        raise ValueError(f"init_params: the generator is on {gdev}, the "
                         f"params are asked for on {device}")

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return _init_leaf(gen, node, device)

    return build(specs)


def abstract_params(specs: Any) -> Any:
    """The param tree as empty ``meta`` tensors (shapes and dtypes, no
    memory), keys in ``init_params``'s order: the dry run's params."""
    if isinstance(specs, dict):
        return {k: abstract_params(specs[k]) for k in sorted(specs)}
    return torch.empty(specs.shape, dtype=specs.dtype, device="meta")


def param_axes(specs: Any) -> Any:
    """The logical-axes tree parallel to the param tree."""
    return map_specs(lambda sp: sp.axes, specs)


# ---------------------------------------------------------------------------
# Norms & activations (float32 inside, cast back)
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + weight.to(torch.float32))).to(dt)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * weight.to(torch.float32)
            + bias.to(torch.float32)).to(dt)


def apply_norm(kind: str, x: torch.Tensor, p: dict) -> torch.Tensor:
    if kind == "layernorm":
        return layer_norm(x, p["scale"], p["bias"])
    return rms_norm(x, p["scale"])


def norm_spec(kind: str, d: int, stacked: int | None = None) -> dict:
    lead = (stacked,) if stacked else ()
    lax_ = ("layers",) if stacked else ()
    out = {"scale": ParamSpec(lead + (d,), lax_ + ("embed",),
                              init="zeros" if kind == "rmsnorm" else "ones")}
    if kind == "layernorm":
        out["bias"] = ParamSpec(lead + (d,), lax_ + ("embed",), init="zeros")
    return out


# ---------------------------------------------------------------------------
# Rotary position embeddings (split halves, not interleaved)
# ---------------------------------------------------------------------------

def rope_freqs(dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, D] with D even; positions: broadcastable to [..., S]."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                    # (d/2,)
    angles = positions[..., None].to(torch.float32) * freqs  # (..., S, d/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_embedding(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Whisper-style fixed sinusoidal position embedding: positions [...]
    -> float32 [..., d], sines then cosines."""
    half = d // 2
    freqs = torch.exp(-math.log(10_000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device)
        / max(half - 1, 1))
    args = positions[..., None].to(torch.float32) * freqs
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


def softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return logits
    return torch.tanh(logits / cap) * cap


def scan_layers(body, carry, xs):
    """``lax.scan`` over stacked layers as a Python loop: ``xs`` is a
    nested dict (or tuple) whose tensors lead with the layer dim; ``body``
    gets layer i's slices (views) and returns ``(carry, y)``.  Returns the
    final carry and the list of ys."""
    n = _first_leaf(xs).shape[0]
    ys = []
    for i in range(n):
        carry, y = body(carry, _index(xs, i))
        ys.append(y)
    return carry, ys


def _first_leaf(tree):
    if isinstance(tree, dict):
        return _first_leaf(tree[next(iter(tree))])
    if isinstance(tree, (list, tuple)):
        return _first_leaf(tree[0])
    return tree


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_index(t, i) for t in tree)
    return tree[i]
