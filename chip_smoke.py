#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels from ``src/repro_torch/kernels/csrc``, holds
each kernel against its plain PyTorch version at the main path's shapes
(n = 1,000,000 replay rows), trains the DQN + AMPER-fr agent on CartPole
through the fused draw kernel and through the match kernel with the
standard 1M-transition replay memory, and checks that those runs
launched the kernels.  Steps per second are timed over steady learn
steps after each run (set-up and warm-up are reported apart), with the
host time spent in the PRNG beside them.  Each phase prints one JSON line; the line before
the last lists the kernels with their timings and bounds, and the last
line is ``{"ok": true, "device": {...}}``.  Any failed phase exits
non-zero without that line.  There is no fallback to the CPU: without a
CUDA device the script exits with code 2.

``--phases`` picks a subset (device,match,sample,fused,kernel) for
debugging; every phase runs by default.  ``--profile`` adds a
torch.profiler window after each training phase (device busy and idle
share per step, top kernels; the chrome trace goes to ``--trace-dir``,
``profile_out/`` by default).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
N_ROWS = 1_000_000           # DQN's standard replay memory (Mnih et al. 2015)
HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory rate (data sheet)
SEED = 0
PHASES = ("device", "match", "sample", "fused", "kernel")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(phase: str, msg: str) -> None:
    emit({"phase": phase, "ok": False, "error": msg})
    raise SystemExit(1)


def device_time_ms(fn, calls: int = 50, reps: int = 5) -> float:
    """Device time of one ``fn()`` call: ``calls`` calls queued behind a
    GPU spin (so host launch gaps do not count), timed with CUDA events;
    the median over ``reps`` such batches."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)  # ~25 ms spin while the host enqueues
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        per_call.append(start.elapsed_time(end) / calls)
    return float(np.median(per_call))


def wall_ms(fn, calls: int = 20) -> float:
    """Host wall time of one synchronized ``fn()`` call (mean of ``calls``)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e3


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail("device", f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def table(n: int, tail_invalid: int, device):
    """Quantized priorities of n rows from a numpy seed, all valid except
    the last ``tail_invalid`` rows."""
    from repro_torch.core import quantize as qz

    rng = np.random.default_rng(SEED)
    p = torch.from_numpy(rng.exponential(1.0, n).astype(np.float32))
    pq = qz.quantize(p, 8.0).to(device)
    valid = torch.ones(n, dtype=torch.bool)
    valid[n - tail_invalid:] = False
    return pq, valid.to(device)


def ranges(device, seed: int = SEED):
    """The m = 20 AMPER-fr ranges of the DQN config (lam_fr = 2.0)."""
    from repro_torch import prng
    from repro_torch.core import amper

    cfg = amper.AmperConfig(capacity=N_ROWS, m=20, lam_fr=2.0, v_max=8.0)
    lo, hi = amper.fr_intervals(
        amper.group_representatives(prng.key(seed), cfg), cfg)
    return lo.to(device), hi.to(device)


def phase_device(state: dict) -> None:
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    reports = build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in text.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, text in reports.items()}
    emit({"phase": "device", "ok": True,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "nvidia_smi": state["smi"], "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": round(build_s, 3),
          "ptxas": ptxas})


def phase_match(state: dict) -> None:
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import multi_query_match_ref

    dev = torch.device("cuda")
    pq, valid = table(N_ROWS, 1000, dev)
    lo, hi = ranges(dev)
    sel, counts = ops.multi_query_match(pq, valid, lo, hi)
    sel_p, counts_p = multi_query_match_ref(pq, valid, lo, hi)
    torch.cuda.synchronize()
    if not torch.equal(sel, sel_p) or not torch.equal(counts, counts_p):
        fail("match", f"kernel != plain: sel diff "
             f"{int((sel != sel_p).sum())}, counts {counts.tolist()} vs "
             f"{counts_p.tolist()}")
    # odd length: the ragged tail past the last whole group of 4 rows
    pq_o, valid_o = pq[1:].clone(), valid[1:].clone()
    sel_o, counts_o = ops.multi_query_match(pq_o, valid_o, lo, hi)
    sel_op, counts_op = multi_query_match_ref(pq_o, valid_o, lo, hi)
    if not torch.equal(sel_o, sel_op) or not torch.equal(counts_o, counts_op):
        fail("match", "kernel != plain on the odd-length table")
    # an offset view would break the kernels' 4-row vector loads
    try:
        ops.multi_query_match(pq[1:], valid[1:], lo, hi)
    except ValueError:
        pass
    else:
        fail("match", "the wrapper took a misaligned offset view")
    err = max(int((sel.int() - sel_p.int()).abs().max()),
              int((counts - counts_p).abs().max()))
    ms = device_time_ms(lambda: ops.multi_query_match(pq, valid, lo, hi))
    plain_ms = device_time_ms(
        lambda: multi_query_match_ref(pq, valid, lo, hi), calls=10, reps=3)
    # each input read once, each output written once
    bound_ms = nbytes(pq, valid, lo, hi, sel, counts) / HBM_BYTES_PER_S * 1e3
    row = {"name": "multi_query_match", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/multi_query_match.cu",
           "replaces": "src/repro/kernels/tcam_match.py:73",
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None}
    state["kernels"]["multi_query_match"] = row
    emit({"phase": "match", "ok": True, "n": N_ROWS, "m": 20,
          "members": int(sel.sum()), "counts_sum": int(counts.sum()),
          "kernel_ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms})


def phase_sample(state: dict) -> None:
    from repro_torch import prng
    from repro_torch.kernels import ops
    from repro_torch.kernels.amper_sample import amper_sample_ref

    dev = torch.device("cuda")
    pq, valid = table(N_ROWS, 1000, dev)
    lo, hi = ranges(dev)
    none_valid = torch.zeros_like(valid)
    cases = [("csp150k_b64", valid, 150_000, 64),
             ("csp150k_b300", valid, 150_000, 300),
             ("truncated_csp64", valid, 64, 64),
             ("empty_table", none_valid, 150_000, 64)]
    err = 0
    results = []
    for i, (name, v, cap, batch) in enumerate(cases):
        shift = 12_345 + 99_991 * i
        k = prng.key(100 + i)
        idx, stats = ops.amper_sample(pq, v, lo, hi, shift, k, batch=batch,
                                      csp_capacity=cap)
        idx_p, stats_p = amper_sample_ref(pq, v, lo, hi, shift, k,
                                          batch=batch, csp_capacity=cap)
        torch.cuda.synchronize()
        if not torch.equal(idx, idx_p) or not torch.equal(stats, stats_p):
            fail("sample", f"{name}: kernel != plain: stats "
                 f"{stats.tolist()} vs {stats_p.tolist()}, idx diff "
                 f"{int((idx != idx_p).sum())}/{batch}")
        err = max(err, int((idx - idx_p).abs().max()),
                  int((stats - stats_p).abs().max()))
        results.append({"case": name, "stats": stats.tolist()})
    k = prng.key(7)
    ms = device_time_ms(lambda: ops.amper_sample(
        pq, valid, lo, hi, 4242, k, batch=64, csp_capacity=150_000))
    plain_ms = device_time_ms(lambda: amper_sample_ref(
        pq, valid, lo, hi, 4242, k, batch=64, csp_capacity=150_000),
        calls=5, reps=3)
    idx, stats = ops.amper_sample(pq, valid, lo, hi, 4242, k, batch=64,
                                  csp_capacity=150_000)
    # each input read once (shift and key: 16 B), each output written once
    bound_ms = (nbytes(pq, valid, lo, hi, idx, stats) + 16) \
        / HBM_BYTES_PER_S * 1e3
    state["kernels"]["amper_sample"] = {
        "name": "amper_sample", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/amper_sample.cu",
        "replaces": "src/repro/kernels/amper_sample.py:103",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None}
    emit({"phase": "sample", "ok": True, "n": N_ROWS, "cases": results,
          "kernel_ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms})


def profile_window(dqn, st, out_dir: str, steps: int = 20) -> dict:
    """Trace ``steps`` more agent steps with torch.profiler: device busy
    time per step (sum of kernel times, one stream), the idle share, the
    top kernels and the host time of the replay draw span."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import prng

    keys = prng.split(prng.key(SEED + 2), steps)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for k in keys:
            st, _ = dqn.agent_step(st, k)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, "fused_steps_trace.json"))
    span_names = ("replay_sample", "csp_rebuild")
    events = prof.key_averages()
    # Span ranges also show up on the device timeline; they are not kernels.
    kernels = [(e.key, e.self_device_time_total, e.count) for e in events
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0 and e.key not in span_names]
    busy_us = sum(t for _, t, _ in kernels)
    spans = {e.key: e.cpu_time_total / steps / 1e3 for e in events
             if e.key in span_names and e.device_type == DeviceType.CPU}
    top = sorted(kernels, key=lambda x: -x[1])[:8]
    return {"window_steps": steps, "wall_ms_per_step": wall_us / steps / 1e3,
            "device_busy_ms_per_step": busy_us / steps / 1e3,
            "device_idle_share": 1 - busy_us / wall_us,
            "kernel_launches_per_step": sum(c for _, _, c in kernels) / steps,
            "span_host_ms_per_step": spans,
            "top_kernels": [{"name": n[:80], "ms_per_step": t / steps / 1e3,
                             "calls_per_step": c / steps}
                            for n, t, c in top]}


def prng_window(dqn, st, steps: int = 50):
    """Host time spent in the port's PRNG over ``steps`` agent steps: the
    public draws of ``repro_torch.prng`` (outermost calls only) are timed
    with perf_counter.  A draw that lands on the card includes its copy
    there, which waits for the work queued before it."""
    from repro_torch import prng

    names = ("split", "fold_in", "bits", "uniform", "normal", "randint")
    saved = {n: getattr(prng, n) for n in names}
    acc = {"s": 0.0, "calls": 0, "depth": 0}

    def timed(fn):
        def wrapper(*args, **kwargs):
            if acc["depth"]:
                return fn(*args, **kwargs)
            acc["depth"] = 1
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                acc["s"] += time.perf_counter() - t0
                acc["calls"] += 1
                acc["depth"] = 0
        return wrapper

    keys = prng.split(prng.key(SEED + 3), steps)
    for n in names:
        setattr(prng, n, timed(saved[n]))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for k in keys:
            st, _ = dqn.agent_step(st, k)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for n, fn in saved.items():
            setattr(prng, n, fn)
    prng_ms = acc["s"] / steps * 1e3
    return st, {"prng_window_steps": steps,
                "prng_host_ms_per_step": prng_ms,
                "prng_calls_per_step": acc["calls"] / steps,
                "prng_share": prng_ms / (wall / steps * 1e3)}


def train_phase(state: dict, phase: str, fr_mode: str, steps: int,
                kernel: str, trace_dir: str | None = None,
                steady_steps: int = 200) -> None:
    from repro_torch import prng
    from repro_torch.core import amper
    from repro_torch.kernels import ops
    from repro_torch.models.qhead import tree_leaves
    from repro_torch.rl.dqn import DQNConfig, make_dqn

    cfg = DQNConfig(env="cartpole", sampler="amper-fr", amper_fr_mode=fr_mode,
                    num_envs=16, replay_size=N_ROWS, batch=64, hidden=128,
                    v_max=8.0, learn_start=100)
    dqn = make_dqn(cfg, device="cuda")
    key = prng.key(SEED)
    # Set-up alone: the 1M-row replay and sampler state, params, env reset.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dqn.init(key)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    # The main path, through the trainer's entry point.
    ops.reset_launches()
    t0 = time.perf_counter()
    st, metrics = dqn.train(key, steps)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = dict(ops.launches)
    learn_steps = sum(1 for t in range(steps)
                      if t >= cfg.learn_start and t % cfg.train_every == 0)
    if launches[kernel] < learn_steps:
        fail(phase, f"{kernel} launched {launches[kernel]} times in "
             f"{learn_steps} learn steps")
    flat = tree_leaves(st.params)
    if not all(bool(torch.isfinite(t).all()) for t in flat):
        fail(phase, "non-finite params")
    losses = torch.stack(metrics["loss"])[cfg.learn_start:]
    if not bool(torch.isfinite(losses).all()):
        fail(phase, "non-finite loss")
    # Steady state: learn steps past learn_start and warm-up, timed alone.
    keys = prng.split(prng.key(SEED + 4), steady_steps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in keys:
        st, _ = dqn.agent_step(st, k)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / steady_steps * 1e3
    st, prng_stats = prng_window(dqn, st)
    # The draw on the trained buffer, timed alone, and held against the
    # plain broadcast draw on the same state and key.
    k = prng.key(SEED + 1)
    buf = st.buffer
    draw_ms = wall_ms(lambda: dqn.replay.sample(buf, k, cfg.batch))
    idx = dqn.replay.sampler.sample(buf.sampler_state, k, cfg.batch)
    plain = amper.AmperSampler(
        dqn.replay.sampler.cfg._replace(fr_mode="broadcast"), device="cuda")
    idx_p = plain.sample(buf.sampler_state, k, cfg.batch)
    if not torch.equal(idx, idx_p):
        fail(phase, f"{fr_mode} draw != broadcast draw on the trained buffer")
    state["launches"][kernel] = launches[kernel]
    if trace_dir is not None:
        emit({"phase": f"{phase}_profile", "ok": True,
              **profile_window(dqn, st, trace_dir)})
    emit({"phase": phase, "ok": True, "fr_mode": fr_mode, "steps": steps,
          "learn_steps": learn_steps, "launches": launches,
          "init_s": init_s, "train_s": train_s,
          "steady_steps": steady_steps, "steps_per_s": 1e3 / step_ms,
          "step_ms": step_ms, "draw_ms": draw_ms,
          "draw_share": draw_ms / step_ms, **prng_stats,
          "loss_last": float(losses[-1]), "replay_rows": int(buf.size)})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--profile", action="store_true",
                    help="after each training phase, trace 20 more steps "
                         "with torch.profiler")
    ap.add_argument("--trace-dir", default=os.path.join(ROOT, "profile_out"),
                    help="where --profile writes its chrome trace")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable ({e}); run from the "
              "repository root", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    state = {"smi": nvidia_smi_line(), "kernels": {}, "launches": {}}
    for name, fn in (("device", phase_device), ("match", phase_match),
                     ("sample", phase_sample)):
        if name in phases:
            fn(state)
    if "fused" in phases:
        train_phase(state, "fused", "fused", 500, "amper_sample",
                    args.trace_dir if args.profile else None)
    if "kernel" in phases:
        train_phase(state, "kernel", "kernel", 150, "multi_query_match",
                    args.trace_dir if args.profile else None)
    rows = []
    for name, row in state["kernels"].items():
        rows.append({**row, "launches": state["launches"].get(name, 0)})
    emit({"kernels": rows})
    print(state["smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
