"""Q-network heads of the DQN agent family.

Counterpart of ``repro/models/qhead.py``:

* ``"mlp"``     -- the paper's 3-layer MLP (Sec. 4.1.2);
* ``"dueling"`` -- Wang et al.'s ``Q = V + A - mean_a A`` decomposition;
* ``"conv"`` / ``"conv-dueling"`` -- the pixel heads: one 3x3 VALID conv
  to 16 channels, ReLU, flatten, then the dense output structure of the
  two above.  They take ``[B, H, W, C]`` or ``[H, W, C]`` stacks, C the
  frame-stack depth the replay buffer's frame store materializes.

Parameters are plain nested lists and dicts of tensors in the
reference's layout: each dense layer is ``{"w": [in, out], "b": [out]}``
applied as ``x @ w + b``, so weights carry across packages untransposed
(:mod:`repro_torch.interop`); a conv layer keeps the reference's HWIO
kernel ``{"w": [3, 3, C, 16], "b": [16]}``.  Apply functions are plain
functions of ``(params, x)``; gradients come from autograd over
:func:`tree_leaves`.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch import prng, resolve_device

HEAD_KINDS = ("mlp", "dueling", "conv", "conv-dueling")

CONV_CHANNELS = 16
CONV_K = 3


def tree_leaves(tree) -> list[torch.Tensor]:
    """Tensors of a nested list/tuple/dict, in a fixed order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leafwise over trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def mlp_init(key: torch.Tensor, sizes, device="cuda") -> list[dict]:
    """He-initialised dense stack, drawn like the reference's ``mlp_init``
    (weights agree with it to float32 rounding, see ``prng.normal``)."""
    device = resolve_device(device)
    params = []
    for a, b in zip(sizes[:-1], sizes[1:]):
        k1, key = prng.split(key)
        params.append({
            "w": (prng.normal(k1, (a, b)) * (2.0 / a) ** 0.5).to(device),
            "b": torch.zeros(b, device=device),
        })
    return params


def mlp_apply(params: list[dict], x: torch.Tensor) -> torch.Tensor:
    for i, layer in enumerate(params):
        x = x @ layer["w"] + layer["b"]
        if i < len(params) - 1:
            x = torch.relu(x)
    return x


def conv_init(key: torch.Tensor, in_channels: int, device="cuda") -> dict:
    """He-initialised 3x3 VALID conv, ``in_channels -> CONV_CHANNELS``, in
    the reference's HWIO layout and drawn like its ``conv_init``."""
    device = resolve_device(device)
    fan_in = CONV_K * CONV_K * in_channels
    w = prng.normal(key, (CONV_K, CONV_K, in_channels, CONV_CHANNELS))
    return {"w": (w * (2.0 / fan_in) ** 0.5).to(device),
            "b": torch.zeros(CONV_CHANNELS, device=device)}


def conv_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, H-2, W-2, CONV_CHANNELS], ReLU'd (NHWC in and
    out; the conv itself runs in torch's NCHW / OIHW)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), params["w"].permute(3, 2, 0, 1))
    return torch.relu(y.permute(0, 2, 3, 1) + params["b"])


def _conv_features(params: dict, x: torch.Tensor) -> torch.Tensor:
    """The conv trunk flattened in NHWC order, as the reference's
    ``reshape`` orders the dense rows."""
    h = conv_apply(params, x)
    return h.reshape(h.shape[0], -1)


def _flat_conv_dim(obs_shape) -> int:
    h, w, _ = obs_shape
    if h <= CONV_K - 1 or w <= CONV_K - 1:
        raise ValueError(f"obs_shape {tuple(obs_shape)} too small for a "
                         f"{CONV_K}x{CONV_K} VALID conv")
    return (h - CONV_K + 1) * (w - CONV_K + 1) * CONV_CHANNELS


def _batched(apply):
    """Let a batch-only conv apply take a single [H, W, C] stack too."""

    def wrapped(params, x):
        if x.ndim == 3:
            return apply(params, x[None])[0]
        return apply(params, x)

    return wrapped


def _dueling_out(params: dict, h: torch.Tensor) -> torch.Tensor:
    """``V + A - mean_a A`` on trunk features ``h`` (ReLU'd trunk)."""
    for layer in params["trunk"]:
        h = torch.relu(h @ layer["w"] + layer["b"])
    v = mlp_apply(params["value"], h)
    a = mlp_apply(params["adv"], h)
    return v + a - a.mean(-1, keepdim=True)


class QHead(NamedTuple):
    """An init/apply pair mapping observations to Q-values."""

    kind: str
    init: Callable[[torch.Tensor], Any]        # key -> params
    apply: Callable[[Any, torch.Tensor], torch.Tensor]  # (params, obs) -> q


def make_qhead(kind: str, obs_shape, hidden: int = 128, n_actions: int = 2,
               device="cuda") -> QHead:
    """Build a Q-head by kind (see :data:`HEAD_KINDS`): ``obs_shape`` is
    ``(obs_dim,)`` for the vector heads, ``(H, W, C)`` for the conv
    heads; a bare int is read as ``(obs_dim,)``."""
    device = resolve_device(device)
    if isinstance(obs_shape, int):
        obs_shape = (obs_shape,)
    obs_shape = tuple(int(d) for d in obs_shape)
    if kind not in HEAD_KINDS:
        raise ValueError(f"unknown Q-head kind: {kind!r} "
                         f"(available: {list(HEAD_KINDS)})")
    if kind in ("mlp", "dueling"):
        if len(obs_shape) != 1:
            raise ValueError(f"{kind!r} head needs a flat (obs_dim,) shape, "
                             f"got {obs_shape}; use a conv head for pixel "
                             "observations")
        (flat,) = obs_shape
    else:
        if len(obs_shape) != 3:
            raise ValueError(f"{kind!r} head needs an (H, W, C) shape, got "
                             f"{obs_shape}")
        flat = _flat_conv_dim(obs_shape)

    if kind == "mlp":
        def init(key):
            return mlp_init(key, [flat, hidden, hidden, n_actions], device)

        return QHead(kind=kind, init=init, apply=mlp_apply)

    if kind == "dueling":
        def init(key):
            k_trunk, k_v, k_a = prng.split(key, 3)
            return {"trunk": mlp_init(k_trunk, [flat, hidden, hidden], device),
                    "value": mlp_init(k_v, [hidden, 1], device),
                    "adv": mlp_init(k_a, [hidden, n_actions], device)}

        return QHead(kind=kind, init=init, apply=_dueling_out)

    if kind == "conv":
        def init(key):
            k_c, k_d = prng.split(key)
            return {"conv": conv_init(k_c, obs_shape[-1], device),
                    "dense": mlp_init(k_d, [flat, hidden, n_actions], device)}

        def apply(params, x):
            return mlp_apply(params["dense"],
                             _conv_features(params["conv"], x))

        return QHead(kind=kind, init=init, apply=_batched(apply))

    def init(key):
        k_c, k_t, k_v, k_a = prng.split(key, 4)
        return {"conv": conv_init(k_c, obs_shape[-1], device),
                "trunk": mlp_init(k_t, [flat, hidden], device),
                "value": mlp_init(k_v, [hidden, 1], device),
                "adv": mlp_init(k_a, [hidden, n_actions], device)}

    def apply(params, x):
        return _dueling_out(params, _conv_features(params["conv"], x))

    return QHead(kind=kind, init=init, apply=_batched(apply))
