"""AdamW + global-norm clipping + LR schedules, and the int8 error-feedback
gradient compressor.

Counterpart of ``repro/train/optimizer.py``.  Param and state trees are
nested dicts of tensors in the model's layout; the update loops over
their leaves with plain PyTorch elementwise ops (no Pallas kernel
computes it).  It writes the new moments and params into the old
tensors in place, the counterpart of the reference's jitted step, which
donates its state; the returned trees hold the same tensors.

Under the sharding rules the leaves are DTensors: each gradient is
redistributed to its param's placements before the update.

The int8 compressor (``quantize_int8``, ``dequantize_int8``,
``ef_compress_tree``) is pure and gives the reference's integers bit for
bit.  The reference's cross-pod gradient sync
(``distributed/collectives.py::psum_int8_mean``) uses ``quantize_int8``
without error feedback, and so does the port's; ``ef_compress_tree``
stands alone in both packages.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.models.qhead import tree_leaves, tree_map
from repro_torch.xla_float import div_const, fma32


class AdamWState(NamedTuple):
    m: Any
    v: Any
    count: torch.Tensor   # int32 scalar on the params' device
    master: Any = None    # fp32 master copies when params are low-precision


class AdamW:
    """AdamW with optional mixed precision.

    ``mixed_precision=True`` expects low-precision (bf16) model params:
    fp32 master weights live in the optimizer state, the update runs in
    fp32 against the master, and the bf16 params are re-derived each
    step.
    """

    def __init__(self, lr: Callable[[torch.Tensor], torch.Tensor] | float,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, clip_norm: float = 1.0,
                 mixed_precision: bool = False):
        self.lr = lr if callable(lr) else (
            lambda step: torch.tensor(lr, dtype=torch.float32,
                                      device=step.device))
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.clip_norm = clip_norm
        self.mixed_precision = mixed_precision

    def init(self, params) -> AdamWState:
        def zeros(t):
            return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                  device=p.device), t)

        master = (tree_map(lambda p: p.detach().to(torch.float32).clone(),
                           params) if self.mixed_precision else None)
        device = tree_leaves(params)[0].device
        return AdamWState(m=zeros(params), v=zeros(params),
                          count=torch.zeros((), dtype=torch.int32,
                                            device=device),
                          master=master)

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params):
        """-> (params, state, {"grad_norm", "lr"}); params and state are
        updated in place."""
        grads = [_placed_like(g.to(torch.float32), p)
                 for g, p in zip(tree_leaves(grads), tree_leaves(params))]
        gnorm = global_norm(grads)
        if self.clip_norm:
            scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-9),
                                max=1.0)
            grads = [g * scale for g in grads]
        count = state.count + 1
        b1, b2 = self.b1, self.b2
        c = count.to(torch.float32)
        mhat_scale = 1.0 / (1 - torch.pow(b1, c))
        vhat_scale = 1.0 / (1 - torch.pow(b2, c))
        lr = self.lr(count)
        ref = state.master if self.mixed_precision else params
        for p, r, mm, vv, g in zip(tree_leaves(params), tree_leaves(ref),
                                   tree_leaves(state.m), tree_leaves(state.v),
                                   grads):
            mm.copy_(b1 * mm + (1 - b1) * g)
            vv.copy_(b2 * vv + (1 - b2) * g * g)
            r32 = r.to(torch.float32)
            u = (mm * mhat_scale) / (torch.sqrt(vv * vhat_scale) + self.eps)
            u = u + self.weight_decay * r32
            new = r32 - lr * u
            if self.mixed_precision:
                r.copy_(new)
            p.copy_(new.to(p.dtype))
        st = state._replace(count=count)
        return params, st, {"grad_norm": gnorm, "lr": lr}


def _placed_like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A DTensor gradient redistributed to its param's placements (a
    partial sum reduced, a gathered block split again); others as they
    are."""
    from torch.distributed.tensor import DTensor

    if isinstance(g, DTensor) and isinstance(p, DTensor) and (
            tuple(g.placements) != tuple(p.placements)):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf, in float32 (the leaves'
    sums added in leaf order, as the reference's Python ``sum``)."""
    total = None
    for x in tree_leaves(tree):
        sq = torch.sum(torch.square(x.to(torch.float32)))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor_frac: float = 0.1) -> Callable:
    """Linear warmup to ``peak_lr`` over ``warmup`` steps, then a cosine
    decay to ``floor_frac * peak_lr`` at ``total``; takes an integer
    step tensor, returns float32."""
    def lr(step):
        step = step.to(torch.float32)
        warm = peak_lr * step / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (floor_frac + (1 - floor_frac) * 0.5
                         * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup, warm, cos)
    return lr


# ---------------------------------------------------------------------------
# int8 error-feedback compression (cross-pod gradient sync)
# ---------------------------------------------------------------------------

def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8.  Returns (q, scale); the scale is
    ``amax * f32(1 / 127)``, the reference's ``amax / 127.0`` as XLA
    compiles it."""
    amax = torch.clamp(torch.max(torch.abs(x)), min=1e-12)
    scale = div_const(amax, 127.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def ef_compress_tree(grads, error):
    """Error-feedback int8 round-trip of a gradient tree.

    Returns (quantized tree with ``(q, scale)`` leaves, new error tree):
    each leaf's ``t = g + e`` is quantized and ``t - dequantize(q)`` (one
    rounding, as XLA fuses it) is carried to the next step, so compression noise does not bias the
    long-run gradient.
    """
    def walk(g, e):
        if isinstance(g, dict):
            out = {k: walk(g[k], e[k]) for k in g}
            return ({k: a for k, (a, _) in out.items()},
                    {k: b for k, (_, b) in out.items()})
        if isinstance(g, (list, tuple)):
            out = [walk(x, y) for x, y in zip(g, e)]
            return type(g)(a for a, _ in out), type(g)(b for _, b in out)
        t = g.to(torch.float32) + e
        q, s = quantize_int8(t)
        # t - q * s, the product fused into the subtraction as XLA does
        return (q, s), fma32(-q.to(torch.float32), s, t)

    return walk(grads, error)
