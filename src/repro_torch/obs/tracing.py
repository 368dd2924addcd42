"""Named spans on the profiler timeline.

Counterpart of ``repro/obs/tracing.py::span`` for the call sites the
port has: the replay path's ``csp_rebuild``, ``replay_sample`` and
``sharded_sample``, and the serving engine's ``serve_prefill`` and
``serve_decode``.  A span is a ``torch.profiler.record_function``
range: free when no profiler runs, and a named range on the host and
device timeline when one does.
"""
from __future__ import annotations

import torch


def span(name: str):
    """Context manager marking ``name`` on the profiler timeline."""
    return torch.profiler.record_function(name)
