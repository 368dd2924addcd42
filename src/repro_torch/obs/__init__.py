"""repro_torch.obs — low-overhead telemetry for the replay path.

Counterpart of ``repro/obs``, in four layers, each usable alone:

* :mod:`~repro_torch.obs.metrics` — the registry: counters, gauges and
  histograms with one private cell per writer thread, cumulative
  Prometheus-style semantics, and ``Snapshot.diff`` for per-run views.
* :mod:`~repro_torch.obs.tracing` — ``span("name", **attrs)`` spans
  recording into ``span_<name>_ms`` histograms and the span log of the
  current registry, with device times on a card
  (``span_<name>_device_ms``, ``Registry.spans()``; under a profiler
  only for spans opened with ``device_time=True``); they record while
  the registry is enabled, or on the process default while a
  ``torch.profiler`` runs, open a ``record_function`` range under a
  profiler, and no-op inside a CUDA graph capture or ``torch.compile``
  trace.
* :mod:`~repro_torch.obs.probes` — replay health: the Fig. 7 binning and
  divergences, the windowed :class:`SamplingErrorMonitor`, and the draw
  probe behind :class:`ReplayHealth`.
* :mod:`~repro_torch.obs.exporters` — the JSONL event log, the Prometheus
  text exposition and its loopback endpoint, in the reference's schema;
  ``python -m repro_torch.obs.report`` summarises a JSONL log.

The instrument names are the reference's (its catalog in
``repro/obs/__init__.py``); the port records ``span_replay_sample_ms``,
``span_csp_rebuild_ms``, ``span_sharded_sample_ms``,
``span_checkpoint_save_ms``, ``checkpoint_full_bytes``,
``checkpoint_delta_bytes``, ``checkpoint_chain_len`` and the health
gauges, and spans of its own: ``priority_write`` (attribute ``rows``),
the DQN runner's ``runner_advance`` (``steps``), ``steady_step`` and
``eager_step`` (one of the two a runner step; a captured step's replay
is a ``steady_step``, in which the draw records no ``replay_sample``:
:mod:`repro_torch.rl.dqn`).  A span timed on a card adds
``span_<name>_device_ms``.  Instrumentation adds no kernel launch,
enabled or not.
"""
from typing import NamedTuple, Optional

from repro_torch.obs.exporters import (JsonlExporter, PrometheusServer,
                                       parse_prometheus, prometheus_text,
                                       read_jsonl, write_prometheus)
from repro_torch.obs.metrics import (INT_BUCKETS, TIME_BUCKETS_MS,
                                     US_BUCKETS, Counter, Gauge, Histogram,
                                     Registry, Snapshot, SpanRecord,
                                     hist_stats)
from repro_torch.obs.probes import (BINS, ReplayHealth, SamplingErrorMonitor,
                                    chi_square, kl_nats, make_replay_probe,
                                    priority_bin_counts)
from repro_torch.obs.tracing import (get_registry, set_registry, span,
                                     use_registry)


class Telemetry(NamedTuple):
    """Telemetry spec, as the reference's.

    Attributes:
      registry: use this registry instead of a fresh per-run one.
      metrics_out: JSONL event-log path (appended; see JsonlExporter).
      prometheus_out: write the Prometheus text exposition here when the
        run finishes.
      probe_every: replay-health probe cadence in draws (0 disables it).
      window: SamplingErrorMonitor window, in probed draws.
    """

    registry: Optional[Registry] = None
    metrics_out: Optional[str] = None
    prometheus_out: Optional[str] = None
    probe_every: int = 16
    window: int = 200


__all__ = [
    "BINS", "Counter", "Gauge", "Histogram", "INT_BUCKETS",
    "JsonlExporter", "PrometheusServer", "Registry", "ReplayHealth",
    "SamplingErrorMonitor", "Snapshot", "SpanRecord", "TIME_BUCKETS_MS",
    "Telemetry",
    "US_BUCKETS", "chi_square", "get_registry", "hist_stats", "kl_nats",
    "make_replay_probe", "parse_prometheus", "priority_bin_counts",
    "prometheus_text", "read_jsonl", "set_registry", "span",
    "use_registry", "write_prometheus",
]
