"""The program's own spans, for the per-layer readers that take them.

The readers read ``repro_torch.obs.get_registry().spans()`` after the
window.  In the benchmark's process that is the program's default
registry, which records a span only while a profiler runs, and the
harness runs one only around a traced window: it then holds exactly
that window's spans.  Under the profiler only the replay core's draws
and writes (``device_time=True`` in the program) keep device times; the
others are host-only.  A program without a span log gives none, and so
does a span without device times where they are asked for.
"""
import statistics


def spans(name: str) -> list:
    """The spans ``name`` the program's current registry holds, oldest
    first (empty where the program keeps no span log)."""
    try:
        from repro_torch.obs import get_registry
    except ImportError:
        return []
    read = getattr(get_registry(), "spans", None)
    return [] if read is None else [s for s in read() if s.name == name]


def device_ms(name: str) -> list[float]:
    """The device milliseconds of every span ``name`` timed on a card."""
    return [s.device_ms for s in spans(name) if s.device_ms is not None]


def median(values):
    return statistics.median(values) if values else None
