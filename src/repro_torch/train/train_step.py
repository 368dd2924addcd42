"""Train-step factory: grad accumulation, mixed precision, metrics.

Counterpart of ``repro/train/train_step.py``.  ``make_train_step(model,
optimizer)`` returns ``train_step(state, batch) -> (state, metrics)``:
the loss's gradients by autograd (``Model.loss``, whose attention takes
the differentiable chunked route), accumulated in float32 over
``microbatches`` slices of the batch, then one optimizer update, which
writes the params and moments in place (the reference's jitted step
donates its state).  ``abstract_train_state`` (the state as empty
``meta`` tensors) and ``train_state_axes`` (its logical axes) are what
the dry run traces the step against (``launch/dryrun.py``).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch import resolve_device
from repro_torch.models.qhead import tree_leaves, tree_map
from repro_torch.train.optimizer import AdamWState


class TrainState(NamedTuple):
    step: torch.Tensor   # int32 scalar on the params' device
    params: Any
    opt_state: Any


def init_train_state(model, optimizer, gen: torch.Generator,
                     device="cuda") -> TrainState:
    """Params drawn from ``gen`` (a generator on ``device``), the
    optimizer's state and step 0."""
    device = resolve_device(device)
    params = model.init_params(gen, device)
    return TrainState(step=torch.zeros((), dtype=torch.int32, device=device),
                      params=params, opt_state=optimizer.init(params))


def abstract_train_state(model, optimizer) -> TrainState:
    """The train state as empty ``meta`` tensors: the params, AdamW's
    float32 moments and, under mixed precision, its float32 masters."""
    params = model.abstract_params()

    def f32(tree):
        return tree_map(lambda p: torch.empty(p.shape, dtype=torch.float32,
                                              device="meta"), tree)

    def scalar():
        return torch.empty((), dtype=torch.int32, device="meta")

    master = f32(params) if optimizer.mixed_precision else None
    return TrainState(step=scalar(), params=params,
                      opt_state=AdamWState(m=f32(params), v=f32(params),
                                           count=scalar(), master=master))


def train_state_axes(model, optimizer=None) -> TrainState:
    """Logical-axes tree for the full train state (for shardings)."""
    axes = model.param_axes()
    mixed = bool(optimizer is not None and optimizer.mixed_precision)
    return TrainState(step=(), params=axes,
                      opt_state=AdamWState(m=axes, v=axes, count=(),
                                           master=axes if mixed else None))


def _unflatten_like(tree, leaves):
    """``tree``'s nested dicts and lists with ``leaves`` in the order of
    ``tree_leaves`` (dict keys sorted)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)([build(x) for x in node])
        return next(it)

    return build(tree)


def make_train_step(model, optimizer, *, microbatches: int = 1):
    """Returns train_step(state, batch) -> (state, metrics).

    ``metrics`` holds the loss's metrics (``loss``, ``nll``) averaged over
    the microbatches and the optimizer's (``grad_norm``, ``lr``), each a
    0-d tensor on the params' device.  (The reference's
    ``grad_fn_override`` has no caller and is not ported.)
    """

    def grads_of(params, batch):
        with torch.enable_grad():
            leaves = [p.detach().requires_grad_(True)
                      for p in tree_leaves(params)]
            loss, metrics = model.loss(_unflatten_like(params, leaves), batch)
            grads = torch.autograd.grad(loss, leaves)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return _unflatten_like(params, grads), dict(metrics,
                                                    loss=loss.detach())

    def accumulate(params, batch):
        if microbatches == 1:
            return grads_of(params, batch)
        acc, msum = None, None
        for i in range(microbatches):
            mb = {k: t.reshape((microbatches, t.shape[0] // microbatches)
                               + t.shape[1:])[i] for k, t in batch.items()}
            g, metrics = grads_of(params, mb)
            g = [x.to(torch.float32) for x in tree_leaves(g)]
            if acc is None:
                acc, msum = g, metrics
            else:
                acc = [a + x for a, x in zip(acc, g)]
                msum = {k: msum[k] + metrics[k] for k in msum}
        g = _unflatten_like(params, [a / microbatches for a in acc])
        return g, {k: v / microbatches for k, v in msum.items()}

    def train_step(state: TrainState, batch) -> tuple[TrainState, dict]:
        g, metrics = accumulate(state.params, batch)
        params, opt_state, opt_metrics = optimizer.update(
            g, state.opt_state, state.params)
        return TrainState(step=state.step + 1, params=params,
                          opt_state=opt_state), {**metrics, **opt_metrics}

    return train_step
