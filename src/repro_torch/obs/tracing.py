"""Named spans on the profiler timeline.

Counterpart of ``repro/obs/tracing.py::span`` for the three call sites
the replay path has (``csp_rebuild``, ``replay_sample`` and
``sharded_sample``).  A span is a ``torch.profiler.record_function``
range: free when no profiler runs, and a named range on the host and
device timeline when one does.
"""
from __future__ import annotations

import torch


def span(name: str):
    """Context manager marking ``name`` on the profiler timeline."""
    return torch.profiler.record_function(name)
