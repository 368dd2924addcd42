"""Asynchronous actor-learner replay runtime, on the card.

Counterpart of ``repro/runtime``: experience generation
(:mod:`~repro_torch.runtime.actor`), slab sampling
(:mod:`~repro_torch.runtime.pipeline`) and learning
(:mod:`~repro_torch.runtime.learner`) as overlapped stages on host
threads and CUDA streams behind the
:class:`~repro_torch.runtime.service.ReplayService` façade, the layer
where AMPER-vs-PER sampling latency becomes learner steps per second.
How the stages share the in-place replay state and the card is in
:mod:`~repro_torch.runtime.streams` and the service's docstring.
"""
from repro_torch.runtime.actor import ActorPool, TransitionBlock, make_rollout
from repro_torch.runtime.learner import Feedback, Learner, make_slab_learner
from repro_torch.runtime.pipeline import (BatchSlab, PrefetchPipeline,
                                          make_slab_sampler)
from repro_torch.runtime.service import ReplayService, RunResult

__all__ = [
    "ActorPool", "BatchSlab", "Feedback", "Learner", "PrefetchPipeline",
    "ReplayService", "RunResult", "TransitionBlock", "make_rollout",
    "make_slab_learner", "make_slab_sampler",
]
