"""Span-based wall-time tracing over the metrics registry.

Counterpart of ``repro/obs/tracing.py``.  ``span("csp_rebuild")`` wraps
a host-side region and records its wall time into the histogram
``span_csp_rebuild_ms`` of the *current* registry.  The port's call
sites are the replay path's ``replay_sample``, ``csp_rebuild`` and
``sharded_sample``, the checkpoint manager's ``checkpoint_save``, and
the serving engine's ``serve_prefill`` and ``serve_decode``.

* **Disabled is one branch.**  With the current registry disabled (the
  process default) and no profiler running, entering a span resolves to
  a shared no-op object: nothing is allocated or timed.
* **Never in a capture.**  Under CUDA graph capture a region's host time
  is the capture's, not a run's, and under ``torch.compile`` tracing it
  is compile time; spans no-op in both, as the reference's no-op under a
  jax trace.
* **On the profiler timeline.**  While a ``torch.profiler`` runs, or
  with ``profile=True`` (``set_registry(reg, profile=True)``), a span
  also opens a ``torch.profiler.record_function`` range of its name, so
  profiled windows find the region next to the kernels it brackets.

A span reads the host clock only: it never synchronizes the device, so
the time it records is the host's time to issue the region's work.
"""
from __future__ import annotations

import threading
import time
from typing import Optional

import torch

from repro_torch.obs.metrics import TIME_BUCKETS_MS, Registry

# The process-wide current registry.  Disabled by default: every span is
# a cheap no-op until set_registry() installs an enabled one.
_default_registry = Registry(enabled=False)
_state = threading.local()
_global_registry: Registry = _default_registry
_profile = False


def get_registry() -> Registry:
    """The active registry (thread-local override, then process global)."""
    reg = getattr(_state, "registry", None)
    return reg if reg is not None else _global_registry


def set_registry(registry: Optional[Registry], profile: bool = False
                 ) -> Optional[Registry]:
    """Install ``registry`` as the process-wide current registry (None
    restores the disabled default); ``profile`` makes every span open a
    ``record_function`` range.  Returns the previously installed registry
    (None if it was the default) so callers can restore it."""
    global _global_registry, _profile
    prev = _global_registry
    _global_registry = registry if registry is not None else _default_registry
    _profile = profile
    return None if prev is _default_registry else prev


class use_registry:
    """Context manager: route this THREAD's spans/instruments to ``reg``."""

    def __init__(self, reg: Registry):
        self._reg = reg

    def __enter__(self):
        self._prev = getattr(_state, "registry", None)
        _state.registry = self._reg
        return self._reg

    def __exit__(self, *exc):
        _state.registry = self._prev
        return False


class _NullSpan:
    """Shared no-op span (disabled registry, or inside a capture)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_hist", "_range", "_t0")

    def __init__(self, hist, rng):
        self._hist = hist
        self._range = rng

    def __enter__(self):
        if self._range is not None:
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._hist is not None:
            self._hist.observe((time.perf_counter() - self._t0) * 1e3)
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


def _capturing() -> bool:
    """True under torch.compile tracing or while the current CUDA stream
    is being captured into a graph."""
    if torch.compiler.is_compiling():
        return True
    return (torch.cuda.is_initialized()
            and torch.cuda.is_current_stream_capturing())


def span(name: str, registry: Registry | None = None):
    """Wall-time span context manager -> histogram ``span_<name>_ms``,
    and a ``record_function`` range of ``name`` under a profiler.

    A shared null object when the resolved registry is disabled and no
    range is wanted, or inside a capture (see the module docstring).
    """
    reg = registry if registry is not None else get_registry()
    ranged = _profile or torch.autograd._profiler_enabled()
    if not (reg.enabled or ranged) or _capturing():
        return _NULL_SPAN
    hist = (reg.histogram(f"span_{name}_ms", help=f"wall time of {name} (ms)",
                          bounds=TIME_BUCKETS_MS) if reg.enabled else None)
    return _Span(hist, torch.profiler.record_function(name) if ranged
                 else None)
