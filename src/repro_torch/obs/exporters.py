"""Exporters: structured JSONL event log and Prometheus-style text.

Counterpart of ``repro/obs/exporters.py`` with the same schema: a JSONL
line is one self-describing record (``kind``: ``snapshot`` | ``event``,
``schema`` 1; the port's closed spans are events named ``span``), and
the Prometheus text uses the same series names (``repro_`` prefix,
``_total`` counters, cumulative ``_bucket{le=...}`` histograms).  So
either package's ``read_jsonl``, ``parse_prometheus``
and ``report`` read the other's output.  A crashed run keeps every
flushed line; ``read_jsonl`` skips a torn last line.
"""
from __future__ import annotations

import http.server
import json
import math
import os
import threading
import time
from typing import Any

from repro_torch.analysis.locks import make_lock
from repro_torch.obs.metrics import Registry, Snapshot

SCHEMA_VERSION = 1


def _jsonable(x: Any) -> Any:
    if isinstance(x, dict):
        return {str(k): _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, float):
        return None if math.isnan(x) or math.isinf(x) else x
    if isinstance(x, (str, int, bool)) or x is None:
        return x
    if hasattr(x, "item"):  # numpy scalars, 0-d tensors
        return _jsonable(x.item())
    return str(x)


class JsonlExporter:
    """Append-only JSONL metrics log (thread-safe, line-buffered)."""

    def __init__(self, path: str):
        self.path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._lock = make_lock("obs.jsonl_exporter")
        self._f = open(path, "a", buffering=1)
        self.lines_written = 0

    def _write(self, payload: dict) -> None:
        line = json.dumps(_jsonable(payload), separators=(",", ":"))
        with self._lock:
            self._f.write(line + "\n")
            self.lines_written += 1

    def write_snapshot(self, snapshot: Snapshot,
                       extra: dict | None = None) -> None:
        """One ``kind=snapshot`` line: every instrument's summary view
        (histograms as count/mean/min/max/p50/p95/p99 stats)."""
        payload = {"kind": "snapshot", "schema": SCHEMA_VERSION,
                   "ts": snapshot.ts, "metrics": snapshot.summary()}
        if extra:
            payload.update(extra)
        self._write(payload)

    def write_event(self, name: str, **fields) -> None:
        """One ``kind=event`` line for discrete occurrences (checkpoint
        written, preemption, run start/end)."""
        self._write({"kind": "event", "schema": SCHEMA_VERSION,
                     "ts": time.time(), "event": name, **fields})

    def write_spans(self, spans) -> None:
        """One ``event=span`` line for each closed span of ``spans``
        (records of :meth:`Registry.spans`, device times resolved)."""
        for s in spans:
            self._write({"kind": "event", "schema": SCHEMA_VERSION,
                         "ts": time.time(), "event": "span", **s._asdict()})

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.close()


def read_jsonl(path: str) -> list[dict]:
    """Parse a JSONL metrics log (skipping torn trailing lines)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                continue  # torn final line of a killed run
    return out


def _prom_name(name: str) -> str:
    return "".join(c if c.isalnum() or c == "_" else "_" for c in name)


def _fmt(v: float) -> str:
    if isinstance(v, float) and (math.isnan(v) or math.isinf(v)):
        return "NaN" if math.isnan(v) else ("+Inf" if v > 0 else "-Inf")
    return repr(float(v))


def prometheus_text(registry: Registry, prefix: str = "repro_") -> str:
    """Render the registry in the Prometheus text exposition format.

    Histograms emit cumulative ``_bucket{le=...}`` series plus ``_sum``
    and ``_count``, counters emit ``_total`` — the standard shapes, so
    any Prometheus-compatible scraper/parser consumes this directly.
    """
    lines: list[str] = []
    for name, inst in sorted(registry.instruments().items()):
        pname = prefix + _prom_name(name)
        data = inst.read()
        if inst.kind == "counter":
            lines.append(f"# HELP {pname}_total {inst.help or name}")
            lines.append(f"# TYPE {pname}_total counter")
            lines.append(f"{pname}_total {_fmt(data['value'])}")
        elif inst.kind == "gauge":
            lines.append(f"# HELP {pname} {inst.help or name}")
            lines.append(f"# TYPE {pname} gauge")
            lines.append(f"{pname} {_fmt(data['value'])}")
        else:  # histogram
            lines.append(f"# HELP {pname} {inst.help or name}")
            lines.append(f"# TYPE {pname} histogram")
            cum = 0
            for bound, c in zip(inst.bounds, data["buckets"]):
                cum += c
                lines.append(f'{pname}_bucket{{le="{_fmt(bound)}"}} {cum}')
            cum += data["buckets"][-1]
            lines.append(f'{pname}_bucket{{le="+Inf"}} {cum}')
            lines.append(f"{pname}_sum {_fmt(data['sum'])}")
            lines.append(f"{pname}_count {data['count']}")
    return "\n".join(lines) + "\n"


def write_prometheus(registry: Registry, path: str,
                     prefix: str = "repro_") -> str:
    """Atomic write of the current scrape text to ``path``."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(prometheus_text(registry, prefix=prefix))
    os.replace(tmp, path)
    return path


def parse_prometheus(text: str) -> dict[str, float]:
    """Minimal parser of the exposition format (series name -> value);
    the round-trip half of the export schema tests."""
    out: dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        name, _, value = line.rpartition(" ")
        try:
            out[name] = float(value)
        except ValueError:
            continue
    return out


class PrometheusServer:
    """Zero-dependency scrape endpoint (stdlib http.server, daemon
    thread).  ``GET /metrics`` serves the live registry."""

    def __init__(self, registry: Registry, port: int = 0,
                 host: str = "127.0.0.1", prefix: str = "repro_"):
        reg = registry

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (stdlib API name)
                if self.path.rstrip("/") not in ("", "/metrics"):
                    self.send_error(404)
                    return
                body = prometheus_text(reg, prefix=prefix).encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # silence per-request stderr spam
                pass

        self._server = http.server.ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="obs-prometheus",
            daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5.0)
