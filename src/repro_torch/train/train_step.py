"""Train-step factory: grad accumulation, mixed precision, metrics.

Counterpart of ``repro/train/train_step.py``.  ``make_train_step(model,
optimizer)`` returns ``train_step(state, batch) -> (state, metrics)``:
the loss's gradients by autograd (``Model.loss``, whose attention takes
the differentiable chunked route), accumulated in float32 over
``microbatches`` slices of the batch, then one optimizer update, which
writes the params and moments in place (the reference's jitted step
donates its state).  The reference's sharding helpers
(``train_state_axes``, ``abstract_train_state``) describe a mesh the
port does not have (ROADMAP A14) and are not ported.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch import resolve_device
from repro_torch.models.qhead import tree_leaves


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
