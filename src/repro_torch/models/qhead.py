"""Q-network heads of the DQN agent family.

Counterpart of ``repro/models/qhead.py`` for the vector heads:

* ``"mlp"``     -- the paper's 3-layer MLP (Sec. 4.1.2);
* ``"dueling"`` -- Wang et al.'s ``Q = V + A - mean_a A`` decomposition.

Parameters are plain nested lists and dicts of tensors in the
reference's layout: each dense layer is ``{"w": [in, out], "b": [out]}``
applied as ``x @ w + b``, so weights carry across packages untransposed
(:mod:`repro_torch.interop`).  Apply functions are plain functions of
``(params, x)``; gradients come from autograd over :func:`tree_leaves`.
The conv heads wait for the pixel slice of the port.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch import prng, resolve_device

HEAD_KINDS = ("mlp", "dueling")


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


class QHead(NamedTuple):
    """An init/apply pair mapping observations to Q-values."""

    kind: str
    init: Callable[[torch.Tensor], Any]        # key -> params
    apply: Callable[[Any, torch.Tensor], torch.Tensor]  # (params, obs) -> q


def make_qhead(kind: str, obs_shape, hidden: int = 128, n_actions: int = 2,
               device="cuda") -> QHead:
    """Build a vector Q-head by kind; ``obs_shape`` is ``(obs_dim,)``."""
    device = resolve_device(device)
    if isinstance(obs_shape, int):
        obs_shape = (obs_shape,)
    if kind not in HEAD_KINDS:
        raise ValueError(f"unknown or unported Q-head kind: {kind!r} "
                         f"(available: {list(HEAD_KINDS)})")
    if len(obs_shape) != 1:
        raise ValueError(f"{kind!r} head needs a flat (obs_dim,) shape, "
                         f"got {tuple(obs_shape)}")
    (flat,) = obs_shape

    if kind == "mlp":
        def init(key):
            return mlp_init(key, [flat, hidden, hidden, n_actions], device)

        return QHead(kind=kind, init=init, apply=mlp_apply)

    def init(key):
        k_trunk, k_v, k_a = prng.split(key, 3)
        return {"trunk": mlp_init(k_trunk, [flat, hidden, hidden], device),
                "value": mlp_init(k_v, [hidden, 1], device),
                "adv": mlp_init(k_a, [hidden, n_actions], device)}

    def apply(params, x):
        h = x
        for layer in params["trunk"]:
            h = torch.relu(h @ layer["w"] + layer["b"])
        v = mlp_apply(params["value"], h)
        a = mlp_apply(params["adv"], h)
        return v + a - a.mean(-1, keepdim=True)

    return QHead(kind=kind, init=init, apply=apply)
