"""Spans timed on the card (``repro_torch.obs.tracing``).

Marked ``cuda`` and skipped without a card.  The file imports no JAX, so
it runs where the card is and JAX is not:
``PYTHONPATH=src python -m pytest -q tests/test_torch_spans_cuda.py``.
"""
import pytest
import torch

from repro_torch import obs, prng
from repro_torch.obs.metrics import Registry


@pytest.mark.cuda
def test_device_spans_sit_on_the_host_clock():
    """Every span of a captured run has device times that start no
    earlier than its host start (50 us for the anchor), the steady steps'
    device intervals follow one another without overlap, and nothing
    records inside the capture."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: device timing records CUDA events")
    from repro_torch.rl import dqn as td

    cfg = td.DQNConfig(env="cartpole", sampler="amper-fr", num_envs=16,
                       replay_size=100_000, batch=64, hidden=128,
                       learn_start=100, target_sync=100,
                       amper_fr_mode="fused")
    dqn = td.make_dqn(cfg, device="cuda")
    key, n = prng.key(5), 400
    r = dqn.runner(dqn.init(key), key, n)
    reg = Registry()
    with obs.use_registry(reg):
        r.advance(200)
        r.advance(n)
    spans = reg.spans()
    assert r.info["captured"] and reg.span_log.dropped == 0
    for s in spans:
        assert s.device_start_ns >= s.host_start_ns - 50_000, s
        assert s.device_end_ns >= s.device_start_ns
    names = [s.name for s in spans]
    assert names.count("runner_advance") == 2
    assert names.count("steady_step") + names.count("eager_step") == n
    assert names.count("steady_step") == r.info["graph_replays"] + 1
    # the warm-up and the eager learn steps draw through replay_sample,
    # a replay does not: nothing records inside the capture
    learn = sum(1 for t in range(n) if t >= cfg.learn_start)
    assert names.count("replay_sample") == learn - r.info["graph_replays"]
    steady = [s for s in spans if s.name == "steady_step"]
    # an interval's start is placed through a float32 of ms from the
    # anchor: 1 us covers its rounding over this run
    for a, b in zip(steady, steady[1:]):
        assert b.device_start_ns >= a.device_end_ns - 1_000
    assert reg.instruments()["span_steady_step_device_ms"].read()[
        "count"] == len(steady)


@pytest.mark.cuda
def test_off_span_makes_no_event_on_the_card(monkeypatch):
    """With a card, no enabled registry and no profiler: the null span,
    and no CUDA event made."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.obs import tracing

    torch.zeros(1, device="cuda")  # CUDA initialised
    made = []
    real = torch.cuda.Event
    monkeypatch.setattr(torch.cuda, "Event",
                        lambda *a, **k: made.append(1) or real(*a, **k))
    prev = obs.set_registry(None)
    try:
        assert obs.span("priority_write", rows=8) is tracing._NULL_SPAN
        assert not made
        reg = Registry()
        with obs.span("priority_write", registry=reg, rows=8):
            torch.ones(8, device="cuda").sum()
    finally:
        obs.set_registry(prev)
    assert made  # the enabled registry's span did time on the card
    (s,) = reg.spans()
    assert s.device_ms is not None and s.attrs == {"rows": 8}


@pytest.mark.cuda
def test_profiled_spans_keep_device_time_only_where_asked():
    """Under a profiler the default registry logs the window's spans; the
    replay core's draws and writes keep their device pair, the runner's
    spans are host-only (the trace lays their ranges on the device
    timeline)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: device timing records CUDA events")
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.rl import dqn as td

    cfg = td.DQNConfig(env="cartpole", sampler="amper-fr", num_envs=16,
                       replay_size=100_000, batch=64, hidden=128,
                       learn_start=100, target_sync=100,
                       amper_fr_mode="fused")
    dqn = td.make_dqn(cfg, device="cuda")
    key = prng.key(7)
    r = dqn.runner(dqn.init(key), key, 400)
    r.advance(200)  # captured outside the window
    prev = obs.set_registry(None)
    try:
        log = obs.get_registry().span_log
        n0 = len(log)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            r.advance(400)
        spans = obs.get_registry().spans()[n0:]
    finally:
        obs.set_registry(prev)
    by = {}
    for s in spans:
        by.setdefault(s.name, []).append(s)
    assert len(by["runner_advance"]) == 1 and len(by["eager_step"]) == 2
    assert len(by["steady_step"]) == 198
    for name in ("runner_advance", "steady_step", "eager_step"):
        assert all(s.device_ms is None for s in by[name]), name
    for name in ("replay_sample", "priority_write"):
        assert by[name] and all(s.device_ms is not None for s in by[name])
