"""The readers of the program's spans against a registry with planted
spans: each gives its value where its spans were recorded, and None
where none were (an older program, a CPU run for the device times)."""
import pytest
from perfbench_testkit import catalog  # noqa: F401

from perfbench.harness.window import Observation
from repro_torch import obs
from repro_torch.obs.metrics import _SpanEntry

READERS = ("sharded_sample_device_ms.replay",
           "priority_write_device_ms.replay", "steady_step_issue_us.train",
           "runner_self_us.train")


def _plant(reg, name, host_ms, device_ms=None, self_ms=None, sid=0,
           parent=0, **attrs):
    e = _SpanEntry()
    e.id, e.parent, e.root, e.name, e.attrs = sid, parent, sid, name, attrs
    e.t0, e.t1 = 1_000_000, 1_000_000 + round(host_ms * 1e6)
    e.self_ns = round((host_ms if self_ms is None else self_ms) * 1e6)
    e.events = None
    e.device_ns = (None if device_ms is None else
                   (2_000_000, 2_000_000 + round(device_ms * 1e6)))
    reg.span_log.append(e)


def _read(catalog, name, reg, **kw):
    o = Observation(config={}, cell={}, catalog=catalog, **kw)
    with obs.use_registry(reg):
        return catalog.reader(name).read(o)


def test_replay_readers(catalog):
    reg = obs.Registry()
    for ms in (28.0, 29.0, 40.0):
        _plant(reg, "sharded_sample", 1.5, ms)
    for ms in (700.0, 12.0, 710.0, 11.0, 705.0, 13.0):  # 3 requests
        _plant(reg, "priority_write", 0.1, ms, rows=65_536)
    _plant(reg, "csp_rebuild", 1.0, 999.0)
    lat = [741.0, 740.0, 760.0]
    assert _read(catalog, READERS[0], reg, latencies_ms=lat) == 29.0
    assert _read(catalog, READERS[1], reg,
                 latencies_ms=lat) == pytest.approx(2151.0 / 3)
    assert _read(catalog, READERS[1], reg, latencies_ms=[]) is None


def test_trainer_readers(catalog):
    reg = obs.Registry()
    _plant(reg, "runner_advance", 60.0, self_ms=4.0, sid=1, steps=100)
    _plant(reg, "runner_advance", 55.0, self_ms=6.0, sid=2, steps=100)
    for i, host in enumerate([0.3, 0.25, 0.5]):
        _plant(reg, "steady_step", host, sid=10 + i, parent=1)
    units = {"iterations": 200}
    assert _read(catalog, READERS[2], reg, units=units) == pytest.approx(300)
    assert _read(catalog, READERS[3], reg, units=units) == pytest.approx(50)
    assert _read(catalog, READERS[3], reg, units={}) is None


def test_no_spans_no_value(catalog):
    """An empty log, spans without device times, or a program whose
    registry has no span log: every reader gives None."""
    host_only = obs.Registry()
    for name in ("sharded_sample", "priority_write", "steady_step"):
        _plant(host_only, name, 1.0)
    kw = dict(latencies_ms=[1.0], units={"iterations": 10})
    for reg in (obs.Registry(), obs.Registry(enabled=False)):
        for name in READERS:
            assert _read(catalog, name, reg, **kw) is None, name
    for name in READERS[:2]:
        assert _read(catalog, name, host_only, **kw) is None, name

    class Older:  # a registry from before the span log
        enabled = False

    for name in READERS:
        assert _read(catalog, name, Older(), **kw) is None, name
