"""The port's telemetry (``repro_torch.obs``) against the reference's.

Counterpart of ``tests/test_obs.py``'s registry, span, exporter and
Fig. 7 monitor tests, plus the cross-package pins: a JSONL log and a
Prometheus text written by either package are read by the other's
``read_jsonl`` / ``parse_prometheus``, equal observations give equal
histogram reads and percentiles in both, and the replay probe
re-derives a production draw (AMPER-fr in every ``fr_mode``, and the
reduced probe of a PER sampler) exactly as the reference's probe does
on the same table and key.  Inputs come from numpy with fixed seeds.
"""
import json
import math
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.core.amper import AmperConfig as JConfig, AmperSampler as JAmper
from repro.core.per import CumsumPER as JCumsum
from repro_torch import obs, prng
from repro_torch.core.amper import AmperConfig, AmperSampler
from repro_torch.core.per import CumsumPER
from repro_torch.core.replay_buffer import ReplayBuffer
from repro_torch.obs.metrics import INT_BUCKETS, Registry, _hist_percentile
from repro_torch.obs.probes import (BINS, SamplingErrorMonitor, kl_nats,
                                    priority_bin_counts)

N = 2048
BATCH = 64


@pytest.fixture(autouse=True)
def partitionable():
    with jax.threefry_partitionable(True):
        yield


# --- registry: lock-free writers, exact merge --------------------------------

def test_counter_race_exact_counts():
    """4 writer threads x 10k adds each merge to EXACT totals."""
    reg = Registry()
    c = reg.counter("hits")
    h = reg.histogram("vals", bounds=INT_BUCKETS)
    n, t = 10_000, 4

    def work(tid):
        for _ in range(n):
            c.add()
            h.observe(tid)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(t)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
        assert not th.is_alive()
    assert c.value == n * t and c.read()["events"] == n * t
    data = h.read()
    assert data["count"] == n * t
    assert data["min"] == 0 and data["max"] == t - 1
    for tid in range(t):
        assert data["buckets"][tid] == n


def test_gauge_freshest_write_wins_across_threads():
    reg = Registry()
    g = reg.gauge("depth")
    assert math.isnan(g.value)
    g.set(1.0)
    th = threading.Thread(target=lambda: g.set(7.0))
    th.start()
    th.join(timeout=10)
    assert g.value == 7.0


def test_histogram_percentiles_exact_on_int_bounds():
    reg = Registry()
    h = reg.histogram("staleness_steps", bounds=INT_BUCKETS)
    for v in range(1, 61):
        h.observe(v)
    h.observe_n(3, 0)  # no-op
    assert h.percentile(0.50) == 30
    assert h.percentile(0.95) == 57
    assert h.percentile(1.0) == 60
    assert _hist_percentile(h.read(), h.bounds, 0.01) == 1
    h.observe(100)
    assert h.percentile(1.0) == 100


def test_observe_n_matches_n_observes():
    reg = Registry()
    a = reg.histogram("a", bounds=INT_BUCKETS)
    b = reg.histogram("b", bounds=INT_BUCKETS)
    for _ in range(7):
        a.observe(5)
    b.observe_n(5, 7)
    assert a.read() == b.read()


def test_snapshot_diff_gives_per_run_view():
    reg = Registry()
    c = reg.counter("frames_total")
    h = reg.histogram("lat", bounds=INT_BUCKETS)
    c.add(10)
    h.observe(3)
    base = reg.snapshot()
    c.add(5)
    h.observe(4)
    diff = reg.snapshot().diff(base)
    assert diff.data["frames_total"]["value"] == 5
    assert diff.data["lat"]["count"] == 1
    assert sum(diff.data["lat"]["buckets"]) == 1
    assert diff.summary()["lat"]["p50"] == 4


def test_disabled_registry_records_nothing():
    reg = Registry(enabled=False)
    c, g, h = reg.counter("c"), reg.gauge("g"), reg.histogram("h")
    c.add()
    g.set(1.0)
    h.observe(1.0)
    assert c.value == 0 and math.isnan(g.value) and h.read()["count"] == 0


@pytest.mark.parametrize("bounds", ["TIME_BUCKETS_MS", "US_BUCKETS",
                                    "INT_BUCKETS"])
def test_histograms_agree_with_the_reference(bounds):
    """Same bounds, same observations: the same read, summary and
    percentiles in both packages."""
    assert getattr(obs, bounds) == getattr(jobs, bounds)
    values = np.random.default_rng(0).exponential(3.0, 500)
    regs = [obs.Registry(), jobs.Registry()]
    for reg in regs:
        h = reg.histogram("x", bounds=getattr(obs, bounds))
        for v in values:
            h.observe(float(v))
    a, b = (r.instruments()["x"] for r in regs)
    assert a.read() == b.read()
    for q in (0.5, 0.95, 0.99, 1.0):
        assert a.percentile(q) == b.percentile(q)
    assert regs[0].snapshot().summary() == regs[1].snapshot().summary()


# --- spans -------------------------------------------------------------------

def test_span_disabled_by_default_and_records_when_enabled():
    from repro_torch.obs.tracing import _NULL_SPAN

    assert obs.span("anything") is _NULL_SPAN
    reg = Registry()
    with obs.span("unit", registry=reg):
        pass
    data = reg.instruments()["span_unit_ms"].read()
    assert data["count"] == 1 and data["sum"] >= 0.0


def test_span_is_noop_while_compiling(monkeypatch):
    """Compile (or graph-capture) time never lands in the histograms."""
    from repro_torch.obs.tracing import _NULL_SPAN

    reg = Registry()
    monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    assert obs.span("traced_region", registry=reg) is _NULL_SPAN
    monkeypatch.undo()
    with obs.span("traced_region", registry=reg):
        pass
    assert reg.instruments()["span_traced_region_ms"].read()["count"] == 1


@pytest.mark.parametrize("enabled", [False, True])
def test_span_opens_a_profiler_range(enabled):
    """Under a running torch profiler a span is a named range, whether
    the registry records or not (the profiled windows find the names)."""
    from torch.profiler import ProfilerActivity, profile

    reg = Registry(enabled=enabled)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.span("replay_sample", registry=reg):
            torch.ones(4).sum()
    assert "replay_sample" in {e.key for e in prof.key_averages()}
    assert ("span_replay_sample_ms" in reg.instruments()) == enabled


def test_span_log_parent_ids_and_self_time():
    """Nested spans name their parent and root; a span's self time is its
    host time less its direct children's."""
    reg = Registry()
    with obs.span("outer", registry=reg, steps=3):
        with obs.span("inner", registry=reg):
            with obs.span("leaf", registry=reg, rows=7):
                torch.ones(8).sum()
        with obs.span("inner", registry=reg):
            pass
    with obs.span("alone", registry=reg):
        pass
    spans = reg.spans()
    # closed in exit order: leaf, inner, inner, outer, alone
    assert [s.name for s in spans] == ["leaf", "inner", "inner", "outer",
                                       "alone"]
    assert [s.seq for s in spans] == sorted(s.seq for s in spans)
    leaf, in1, in2, outer, alone = spans
    assert outer.parent == 0 and outer.root == outer.id
    assert in1.parent == in2.parent == outer.id and leaf.parent == in1.id
    assert {s.root for s in (leaf, in1, in2)} == {outer.id}
    assert alone.parent == 0 and alone.root == alone.id != outer.id
    assert outer.attrs == {"steps": 3} and leaf.attrs == {"rows": 7}
    for s in spans:
        assert s.host_end_ns >= s.host_start_ns
        assert s.device_start_ns is None and s.device_ms is None  # no card
    took = lambda s: s.host_end_ns - s.host_start_ns  # noqa: E731
    assert outer.self_ns == took(outer) - took(in1) - took(in2)
    assert in1.self_ns == took(in1) - took(leaf)
    assert leaf.self_ns == took(leaf)
    assert in1.host_start_ns <= leaf.host_start_ns <= leaf.host_end_ns \
        <= in1.host_end_ns
    assert reg.instruments()["span_inner_ms"].read()["count"] == 2


def test_span_log_bound_and_dropped_count():
    reg = Registry()
    assert reg.span_log.limit == 65_536
    reg.span_log.limit = 4
    for i in range(10):
        with obs.span(f"s{i}", registry=reg):
            pass
    spans = reg.spans()
    assert [s.name for s in spans] == ["s6", "s7", "s8", "s9"]
    assert len(reg.span_log) == 4 and reg.span_log.dropped == 6
    # the histograms keep every span
    assert sum(reg.instruments()[f"span_s{i}_ms"].read()["count"]
               for i in range(10)) == 10


def test_span_log_resolves_pairs_oldest_first():
    """Event pairs (stood in for) become device times on the host clock
    through the anchor: a read without waiting stops at the first pair
    still pending, ``spans()`` waits for the rest, and a dropped record's
    pair goes back to the pool unread."""
    from repro_torch.obs.metrics import _SpanEntry

    class Ev:  # a CUDA timing event at ``ms`` on the card's clock
        def __init__(self, ms, done=True):
            self.ms, self.done, self.waited = ms, done, False

        def query(self):
            return self.done

        def synchronize(self):
            self.done = self.waited = True

        def elapsed_time(self, later):
            return later.ms - self.ms

    reg = Registry()
    log = reg.span_log
    log.limit = 4
    log.anchors[0] = (Ev(10.0), 5_000_000)  # card 10 ms = host 5 ms
    log.pools[0] = []

    def plant(name, t0, t1, done=True):
        e = _SpanEntry()
        e.id, e.parent, e.root, e.name, e.attrs = 1, 0, 1, name, {}
        e.t0 = e.t1 = e.self_ns = 0
        e.device_ns = None
        e.events = (0, Ev(t0), Ev(t1, done))
        log.append(e)
        return e

    first = plant("a", 11.0, 11.5)
    plant("a", 12.0, 12.25, done=False)
    plant("b", 13.0, 14.0)
    reg.snapshot()
    assert first.device_ns == (6_000_000, 6_500_000)
    assert [r.device_ms for r in log.records()] == [0.5, None, None]
    assert reg.instruments()["span_a_device_ms"].read()["count"] == 1
    plant("c", 15.0, 15.5)
    late = plant("c", 16.0, 16.5, done=False)  # drops the first record
    assert log.dropped == 1 and len(log.pools[0]) == 2  # pooled at its read
    spans = reg.spans()
    assert [s.device_ms for s in spans] == [0.25, 1.0, 0.5, 0.5]
    assert spans[0].device_start_ns == 7_000_000
    assert late.events is None and late.device_ns == (11_000_000,
                                                      11_500_000)
    assert len(log.pools[0]) == 2 * 5 and not log._pending
    assert reg.instruments()["span_a_device_ms"].read()["count"] == 2
    assert reg.instruments()["span_c_device_ms"].read()["count"] == 2
    # a pending pair pushed out by the bound is waited for and pooled
    pend = plant("d", 17.0, 17.5, done=False)
    for t in range(4):
        plant("e", 18.0 + t, 18.5 + t)
    assert pend.events is None and pend.device_ns is None
    assert log.dropped == 6 and len(log.pools[0]) == 2 * 6
    assert "span_d_device_ms" not in reg.instruments()


def test_default_registry_records_only_under_a_profiler():
    """The process default (disabled) logs spans while a profiler runs,
    and no histogram; a disabled registry installed or passed explicitly
    stays silent, though the range still opens."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs.tracing import _NULL_SPAN, _default_registry

    prev = obs.set_registry(None)
    try:
        default = obs.get_registry()
        assert default is _default_registry and not default.enabled
        n0 = len(default.span_log)
        assert obs.span("off_window") is _NULL_SPAN
        silent = Registry(enabled=False)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with obs.span("in_window", rows=5):
                with obs.span("passed_disabled", registry=silent):
                    torch.ones(4).sum()
            obs.set_registry(silent)
            with obs.span("installed_disabled"):
                pass
            obs.set_registry(None)
        new = default.span_log.records()[n0:]
        assert [(s.name, s.attrs) for s in new] == [("in_window",
                                                     {"rows": 5})]
        assert len(silent.span_log) == 0 and not silent.instruments()
        assert "span_in_window_ms" not in default.instruments()
        assert {"in_window", "passed_disabled", "installed_disabled"} <= {
            e.key for e in prof.key_averages()}
        assert obs.span("after_window") is _NULL_SPAN
        assert len(default.span_log) == n0 + 1
    finally:
        obs.set_registry(prev)


def test_off_span_is_the_null_span_and_allocates_nothing(monkeypatch):
    """No enabled registry and no profiler: one branch, no timing event,
    no clock read, and nothing left allocated."""
    import sys

    from repro_torch.obs import tracing

    def no_event(*a, **k):
        raise AssertionError("a timing event was made")

    monkeypatch.setattr(torch.cuda, "Event", no_event)
    monkeypatch.setattr(tracing, "time", None)  # any clock read raises
    prev = obs.set_registry(None)
    try:
        for _ in range(100):  # warm every cache first
            obs.span("priority_write", rows=64)
        before = sys.getallocatedblocks()
        for _ in range(10_000):
            sp = obs.span("priority_write", rows=64)
            with sp:
                pass
        after = sys.getallocatedblocks()
        assert sp is tracing._NULL_SPAN
        assert after - before <= 8  # not one a call
        assert len(obs.get_registry().span_log) == len(
            tracing._default_registry.span_log)
    finally:
        obs.set_registry(prev)


def test_spans_reach_the_jsonl_exporter(tmp_path):
    reg = Registry()
    with obs.span("runner_advance", registry=reg, steps=100):
        with obs.span("priority_write", registry=reg, rows=65_536):
            pass
    path = str(tmp_path / "spans.jsonl")
    exp = obs.JsonlExporter(path)
    exp.write_spans(reg.spans())
    exp.close()
    recs = [r for r in obs.read_jsonl(path) if r["event"] == "span"]
    assert [r["name"] for r in recs] == ["priority_write", "runner_advance"]
    write, adv = recs
    assert write["attrs"] == {"rows": 65_536} and adv["attrs"] == {
        "steps": 100}
    assert write["parent"] == adv["id"] and adv["parent"] == 0
    assert write["kind"] == "event" and write["device_start_ns"] is None
    assert write["host_end_ns"] >= write["host_start_ns"]
    assert exp.lines_written == 2


@pytest.mark.parametrize("profiled", [False, True],
                         ids=["no_profiler", "profiler"])
@pytest.mark.parametrize("device_time", [False, True],
                         ids=["plain", "device_time"])
def test_device_pair_taken_where_wanted(monkeypatch, profiled, device_time):
    """On a card (stood in for: the span is made, never entered) a span
    of an enabled registry takes a device pair; under a profiler, whose
    trace lays the span's range on the device timeline, only one opened
    with ``device_time=True`` does, on the default registry too."""
    import contextlib

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs.tracing import _NULL_SPAN

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    want = 0 if device_time or not profiled else None
    prev = obs.set_registry(None)
    try:
        with (profile(activities=[ProfilerActivity.CPU]) if profiled
              else contextlib.nullcontext()):
            sp = obs.span("priority_write", registry=Registry(),
                          device_time=device_time, rows=8)
            assert sp._dev == want
            default = obs.span("steady_step", device_time=device_time)
            if profiled:
                assert default._dev == want
            else:
                assert default is _NULL_SPAN
    finally:
        obs.set_registry(prev)


def test_use_registry_thread_local_override():
    reg = Registry()
    with obs.use_registry(reg):
        assert obs.get_registry() is reg
        with obs.span("scoped"):
            pass
    assert obs.get_registry() is not reg
    assert reg.instruments()["span_scoped_ms"].read()["count"] == 1


def test_replay_sample_span_counts_each_draw():
    """The replay path's span records one observation per draw and does
    not change the draw."""
    rb = ReplayBuffer(N, _sampler("fused"))
    st = _filled_buffer(rb)
    key = prng.key(7)
    idx0, _, w0 = rb.sample(st, key, BATCH)
    reg = Registry()
    prev = obs.set_registry(reg)
    try:
        for _ in range(3):
            idx, _, w = rb.sample(st, key, BATCH)
    finally:
        obs.set_registry(prev)
    assert torch.equal(idx, idx0) and torch.equal(w, w0)
    assert reg.instruments()["span_replay_sample_ms"].read()["count"] == 3
    assert not obs.get_registry().enabled


# --- exporters: schema round-trips, both packages ----------------------------

def _registry(pkg):
    reg = pkg.Registry()
    reg.counter("frames_total", help="frames").add(42)
    reg.histogram("lat", bounds=pkg.INT_BUCKETS).observe(2)
    reg.gauge("unset_gauge")  # NaN -> null in JSON
    reg.gauge("csp_occupancy").set(0.25)
    h = reg.histogram("span_x_ms", bounds=(1.0, 10.0))
    for v in (0.5, 5.0, 99.0):
        h.observe(v)
    return reg


def test_jsonl_roundtrip(tmp_path):
    path = str(tmp_path / "m.jsonl")
    exp = obs.JsonlExporter(path)
    exp.write_event("run_start", mode="sync")
    exp.write_snapshot(_registry(obs).snapshot(), extra={"step": 7})
    exp.close()
    records = obs.read_jsonl(path)
    assert [r["kind"] for r in records] == ["event", "snapshot"]
    ev, snap = records
    assert ev["event"] == "run_start" and ev["mode"] == "sync"
    assert ev["schema"] == snap["schema"] == 1
    assert snap["step"] == 7
    m = snap["metrics"]
    assert m["frames_total"]["value"] == 42
    assert m["lat"]["count"] == 1 and m["lat"]["p50"] == 2
    assert m["unset_gauge"]["value"] is None
    with open(path) as f:
        for line in f:
            json.loads(line)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_jsonl_reads_across_packages(tmp_path, writer):
    """A log written by either package reads the same in both, torn
    tail included."""
    pkg = obs if writer == "port" else jobs
    path = str(tmp_path / "m.jsonl")
    exp = pkg.JsonlExporter(path)
    exp.write_event("checkpoint", step=10, delta=False)
    exp.write_snapshot(_registry(pkg).snapshot(), extra={"step": 10})
    exp.close()
    with open(path, "a") as f:
        f.write('{"kind": "event", "trunc')  # killed mid-write
    mine, theirs = obs.read_jsonl(path), jobs.read_jsonl(path)
    assert mine == theirs and len(mine) == 2
    for r in mine:
        r.pop("ts")
    other = str(tmp_path / "other.jsonl")
    exp = (jobs if writer == "port" else obs).JsonlExporter(other)
    exp.write_event("checkpoint", step=10, delta=False)
    exp.write_snapshot(_registry(jobs if writer == "port" else obs)
                       .snapshot(), extra={"step": 10})
    exp.close()
    other_records = jobs.read_jsonl(other)
    for r in other_records:
        r.pop("ts")
    assert mine == other_records  # the same schema and values


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_prometheus_text_across_packages(tmp_path, writer):
    mine = obs.prometheus_text(_registry(obs))
    theirs = jobs.prometheus_text(_registry(jobs))
    assert mine == theirs
    text = mine if writer == "port" else theirs
    series = obs.parse_prometheus(text)
    np.testing.assert_equal(series, jobs.parse_prometheus(text))  # NaN too
    assert series["repro_frames_total_total"] == 42.0
    assert series["repro_csp_occupancy"] == 0.25
    assert series['repro_span_x_ms_bucket{le="1.0"}'] == 1.0
    assert series['repro_span_x_ms_bucket{le="10.0"}'] == 2.0
    assert series['repro_span_x_ms_bucket{le="+Inf"}'] == 3.0
    assert series["repro_span_x_ms_count"] == 3.0
    assert series["repro_span_x_ms_sum"] == pytest.approx(104.5)
    path = obs.write_prometheus(_registry(obs), str(tmp_path / "m.prom"))
    with open(path) as f:
        np.testing.assert_equal(jobs.parse_prometheus(f.read()), series)


def test_prometheus_http_endpoint():
    reg = Registry()
    reg.counter("hits").add(3)
    srv = obs.PrometheusServer(reg)
    try:
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/metrics", timeout=5).read().decode()
        assert obs.parse_prometheus(body)["repro_hits_total"] == 3.0
    finally:
        srv.close()


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_report_cli_reads_either_log(tmp_path, capsys, writer):
    from repro.obs import report as jreport
    from repro_torch.obs import report

    pkg = obs if writer == "port" else jobs
    reg = pkg.Registry()
    reg.counter("frames_total").add(5)
    path = str(tmp_path / "m.jsonl")
    exp = pkg.JsonlExporter(path)
    exp.write_event("checkpoint", step=10)
    exp.write_snapshot(reg.snapshot())
    exp.close()
    assert report.main([path, "--events"]) == 0
    out = capsys.readouterr().out
    assert "frames_total" in out and "checkpoint" in out
    jreport.main([path, "--events"])
    assert capsys.readouterr().out == out


# --- the Fig. 7 monitor ------------------------------------------------------

def test_online_kl_gauge_matches_fig7_twin_on_same_draws():
    """The live monitor and the port's offline Fig. 7 twin are the same
    computation: fed the twin's draws it gives its counts and KL."""
    from benchmarks import torch_fig7_sampling_error as fig7

    key = prng.key(0)
    prio = prng.uniform(prng.fold_in(key, 99), (N,), device="cpu")
    prio_np = prio.numpy()
    per = CumsumPER(N, device="cpu")
    state = per.update(per.init(), torch.arange(N), prio)
    q_ref = fig7.sample_counts(per, state, prng.fold_in(key, 1), prio_np)
    reg = Registry()
    mon = SamplingErrorMonitor(reg, window=fig7.RUNS)
    mon.set_reference_counts(q_ref)
    counts = np.zeros(BINS)
    k2 = prng.fold_in(key, 2)
    for r in range(fig7.RUNS):
        vals = prio_np[per.sample(state, prng.fold_in(k2, r),
                                  fig7.BATCH).numpy()]
        counts += priority_bin_counts(vals)
        mon.observe(vals)
    np.testing.assert_array_equal(mon.counts, counts)
    assert mon.kl() == kl_nats(counts, q_ref)
    assert mon.kl() == pytest.approx(
        reg.instruments()["sampling_kl_nats"].value)
    uni = np.random.default_rng(0).integers(0, N, fig7.BATCH * fig7.RUNS)
    assert kl_nats(priority_bin_counts(prio_np[uni]).astype(float),
                   q_ref) > 5 * mon.kl()


def test_monitor_window_evicts_old_draws():
    mon = SamplingErrorMonitor(window=2)
    a, b = np.full(10, 0.1), np.full(10, 0.9)
    mon.observe(a)
    mon.observe(a)
    mon.observe(b)
    np.testing.assert_array_equal(
        mon.counts, (priority_bin_counts(a) + priority_bin_counts(b))
        .astype(float))


def test_monitor_agrees_with_the_reference():
    rng = np.random.default_rng(1)
    prio = rng.uniform(0, 1, 500)
    mons = [obs.SamplingErrorMonitor(window=3),
            jobs.SamplingErrorMonitor(window=3)]
    for m in mons:
        m.set_reference_priorities(prio)
    for _ in range(5):
        draw = rng.choice(prio, 64)
        for m in mons:
            m.observe(draw)
    np.testing.assert_array_equal(mons[0].counts, mons[1].counts)
    assert mons[0].kl() == mons[1].kl()
    assert mons[0].chi_square() == mons[1].chi_square()


# --- the replay probe, against the reference's -------------------------------

CFG = dict(capacity=N, m=8, lam_fr=2.0, v_max=8.0, csp_capacity=300)


def _table(seed=0):
    rng = np.random.default_rng(seed)
    p = rng.exponential(1.0, N).astype(np.float32)
    p[rng.random(N) < 0.2] = 0.0  # dead rows
    return p


def _sampler(fr_mode):
    return AmperSampler(AmperConfig(**CFG, fr_mode=fr_mode), "fr",
                        device="cpu")


def _filled_buffer(rb):
    st = rb.init({"obs": torch.zeros(2), "reward": torch.tensor(0.0)})
    st = rb.add_batch(st, {"obs": torch.ones(N, 2), "reward": torch.ones(N)})
    ss = rb.sampler.update(st.sampler_state, torch.arange(N),
                           torch.from_numpy(_table()))
    return st._replace(sampler_state=ss)


@pytest.mark.parametrize("fr_mode", ["broadcast", "kernel", "fused"])
def test_replay_probe_matches_reference_and_the_draw(fr_mode):
    """The probe re-derives the production draw (the fused kernel's
    included) and reads what the reference's probe reads."""
    p = _table()
    ts = _sampler(fr_mode)
    tstate = ts.update(ts.init(), torch.arange(N), torch.from_numpy(p))
    js = JAmper(JConfig(**CFG), "fr")
    jstate = js.update(js.init(), jnp.arange(N), jnp.asarray(p))
    np.testing.assert_array_equal(np.asarray(jstate.pq), tstate.pq.numpy())
    for seed in range(3):
        got = obs.make_replay_probe(ts, BATCH)(tstate, prng.key(seed))
        want = jobs.make_replay_probe(js, BATCH)(jstate,
                                                 jax.random.key(seed))
        for g, w in zip(got[:5], want[:5]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        # bin masses sum in another order (atol from float32 sums)
        np.testing.assert_allclose(got[5].numpy(), np.asarray(want[5]),
                                   rtol=1e-5, atol=1e-4)
        drawn = ts.sample(tstate, prng.key(seed), BATCH).long()
        np.testing.assert_array_equal(
            got[4].numpy(), (ts.priorities(tstate)[drawn] / 8.0).numpy())


def test_reduced_probe_for_per_matches_reference():
    p = _table(3) / 8.0
    ts, js = CumsumPER(N, device="cpu"), JCumsum(N)
    tstate = ts.update(ts.init(), torch.arange(N), torch.from_numpy(p))
    jstate = js.update(js.init(), jnp.arange(N), jnp.asarray(p))
    got = obs.make_replay_probe(ts, BATCH)(tstate, prng.key(4))
    want = jobs.make_replay_probe(js, BATCH)(jstate, jax.random.key(4))
    for g, w in zip(got[:5], want[:5]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_replay_health_gauges():
    ts = _sampler("kernel")
    tstate = ts.update(ts.init(), torch.arange(N),
                       torch.from_numpy(_table()))
    reg = Registry()
    health = obs.ReplayHealth(reg, ts, BATCH, window=10)
    out = [health.update(tstate, prng.key(s)) for s in range(4)]
    live = int((torch.from_numpy(_table()) > 0).sum())
    assert all(o["live"] == live for o in out)
    ins = reg.instruments()
    assert ins["probe_draws"].value == 4
    assert ins["replay_live"].value == live
    assert ins["csp_count"].value == out[-1]["csp_count"]
    assert 0.0 < ins["csp_occupancy"].value <= 1.0
    assert math.isfinite(ins["sampling_kl_nats"].value)
    assert ins["sampling_window_samples"].value == 4 * BATCH
