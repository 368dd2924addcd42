#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels from ``src/repro_torch/kernels/csrc``, holds
each kernel against its plain PyTorch version at the main path's shapes
(n = 1,000,000 replay rows, or one 250,000-row shard of them), captures
the two draw kernels in one CUDA graph and holds its replays, and the
eager calls after them, against the plain versions, holds the PRNG
kernel (jax.random's threefry on keys on the card) against its plain
version bit for bit, trains
the DQN + AMPER-fr agent on CartPole through the fused draw kernel
with its step keys and schedules on the card and its steady step
captured in a CUDA graph (held bit for bit against the eager run on host
keys, and timed beside it),
through the match kernel, and through the sharded draw (4 shards on the
card: the match and rank-select kernels on every shard) with the
standard 1M-transition replay memory, measures Fig. 9 on the card (the
port's sum-tree and cumsum PER per batch at 5k-1M rows beside the AM
latency model's modeled numbers), counts the kernel launches of a
fused draw and of a captured step against the committed launch budget
(``python -m repro_torch.analysis --launch-budget``), runs the port's
analysis gate on the card (the AST lint and the trace rules against
``analysis-baseline-torch.json``, the trainer's step captured exactly
once) and the examples' twins (``examples/torch_*.py``: quickstart, the
cart-pole sampler table, LM training and serving, each timed, the
quickstart's means on the card held against the CPU's), trains the
paper's learning path
(AMPER-k on Acrobot and AMPER-fr through the draw kernel on MountainCar,
two seeds in lockstep through ``train_many``, each held bit for bit
against ``train`` of one seed) and holds AMPER-k's three kNN modes on
the card against the CPU at 1M rows, trains the pixel path (Breakout and
Freeway: the conv Q-heads on uint8 frame stacks, a 1M-transition uint8
frame store materializing the stacked batches at sample time) through
all three replay kernels, through ``train`` and ``train_many``, holding
the card's materialized batches against the CPU's bit for bit and the
conv heads' Q-values within a stated tolerance, checkpoints and
resumes training on the card (``train_ckpt`` killed at its first save
and resumed equal to the uninterrupted run and to ``train`` bit for bit,
on CartPole and on the pixel path; a 4-shard table restored onto 2 and
1 shards and learning on 2; full and delta saves timed and restored
exactly; the same run with telemetry on, and the replay-health probe
equal to the production draw), runs the async replay runtime (actors,
prefetch, learner and replay thread on threads and CUDA streams at 1M
rows: sync equal to ``train``, every slab draw held against the plain
draw under the replay-state lock, kill and resume, the probe, the frame
store), runs the m group
queries of a draw as single TCAM searches, holds the two attention
kernels against their
plain versions at the serving path's shapes and the reference's sweep
(the decode kernel timed with the cache out of L2, as a decode step
finds it, and in L2 beside it),
serves stablelm-1.6b at full width (batch 4, 1024-token prompts, 64
greedy tokens) through the engine, and checks that those runs launched
the kernels and that decode agrees with prefill; then trains
stablelm-1.6b at full width for 30 steps through the LM launcher
(``launch.train.main``: AMPER-fr sequence replay over 2,048 sequences,
batch 8 x 128 tokens, the per-sequence loss through the flash kernel,
24 launches a step), holds its first step and its per-sequence losses
against the plain versions, kills and resumes a reduced run bit for
bit, and trains and serves granite-34b and phi3-medium-14b at full
width and two layers; then serves h2o-danube-3-4b at full width and
depth past its 4,096-key window (its float32 generate held against a
plain float32 forward), deepseek-moe-16b and deepseek-v2-lite-16b at
full width and depth (MoE, MLA with its latent cache), trains the three
at two layers, and holds the flash and decode kernels at their shapes
(the window, D 192 / Dv 128) against the plain versions; then serves
rwkv6-7b (its chunked WKV at the config's chunk of 128), hymba-1.5b
(past its window), whisper-tiny (1,500 frames) and paligemma-3b (its
256-patch prefix) at full width and depth, each float32 generate held
against a float32 forward, trains them (whisper at full depth, the
others at two layers), and holds the flash kernel's prefix and
cross-attention lengths and both kernels at the four families' shapes
against the plain versions; then the dry run (``launch/dryrun.py``):
the paper's own cell, the sharded AMPER-fr draw over 2^28 priorities
with a batch of 65,536, on both production meshes (16 shards of 2^24
rows, 32 of 2^23) in the ``broadcast``, ``kernel`` and ``fused`` modes,
bit for bit alike, with ``multi_query_match`` and ``rank_select`` held
and timed at a shard's shape, and the LM sweep (every arch x shape
cell traced on ``meta``) in processes of their own beside the kernel
phases; and the process mesh (phase ``mesh``): the sharded DQN on 2
``torch.distributed`` ranks and the 2^28-row cell on 4, each bit for bit
against one process, the cell's draws at NCCL world size 1, a
full-width deepseek-moe-16b layer through the explicit-collective
dispatch on a 2 x 2 mesh of 4 ranks, and the int8 and float32 pod
gradient sync of stablelm-1.6b over 2 ranks.  Steps per second are timed over steady
learn steps after each run (set-up and warm-up are reported apart), with
the host time spent in the PRNG beside them.  Each phase prints one JSON
line; the line before the last lists the kernels with their timings and
bounds, and the last line is ``{"ok": true, "device": {...}}``.  Any
failed phase exits non-zero without that line.  There is no fallback to
the CPU: without a CUDA device the script exits with code 2.

``--phases`` picks a subset (device,match,sample,rank,graph,prng,tcam,
flash,decode,fused,kernel,sharded,mesh,fig9,launch_budget,analysis,
examples,table1,pixel,resume,runtime,serve,lm_train,lm_zoo,lm_families,
dryrun) for debugging; every phase runs by default.  Each training phase's line says whether its steps were captured
(``"captured"``).  ``runtime_split`` (named in
``--phases`` only) splits the runtime's time: each stage alone, then the
service in five settings.
``--profile`` adds a torch.profiler window after each training phase and
over decode steps of the serve phase (device busy and idle share per
step, launches per step, top kernels; the chrome trace goes to
``--trace-dir``, ``profile_out/`` by default).
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import time

import numpy as np

# cuBLAS reads its workspace layout once, at its first call; the LM
# trainer (phase lm_train) runs deterministic algorithms, which need
# this fixed layout, so it is set before torch touches the card.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
N_ROWS = 1_000_000           # DQN's standard replay memory (Mnih et al. 2015)
HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory rate (data sheet)
BF16_FLOPS = 989e12          # H100 SXM dense bf16 tensor-core rate
F32_FLOPS = 67e12            # H100 SXM float32 rate outside the tensor cores
SEED = 0
SHARDS = 4                   # logical shards of the sharded phase, on one card
PHASES = ("device", "match", "sample", "rank", "graph", "prng", "tcam",
          "flash", "decode", "fused", "kernel", "sharded", "mesh", "spmd",
          "fig9",
          "launch_budget", "analysis", "examples", "table1", "pixel",
          "resume", "runtime", "serve",
          "lm_train", "lm_zoo", "lm_families", "dryrun")
ARCH = "stablelm-1.6b"       # launch/serve.py's default arch
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 1024, 64
# The reference's kernel sweep (tests/test_kernels.py) and GQA group 4 at
# D 128, beside the serving path's own shapes: (b, hq, hkv, s, d, causal,
# window) and (b, hkv, group, s, d, cur_len).  Flash adds the zoo's head
# dims 120 (h2o-danube-3-4b, GQA 32/8) and 192, one long prefill, and a
# window that hides whole kv tiles from some rows of a q tile;
# decode adds granite-34b's MQA (48 q heads on one kv head, D 128), a
# cur_len on a split boundary (the serving shape's 224-key chunks) and
# cur_len 0 (no live key: uniform weights).
FLASH_SWEEP = [(2, 4, 2, 256, 64, True, None), (1, 8, 1, 256, 128, True, None),
               (2, 4, 4, 256, 128, True, 64), (1, 2, 2, 256, 256, False, None),
               (1, 4, 2, 300, 64, True, None), (2, 8, 2, 512, 128, True, None),
               (1, 32, 8, 512, 120, True, None),
               (1, 16, 16, 256, 192, True, None),
               (1, 32, 32, 4096, 64, True, None),
               (2, 4, 4, 700, 64, True, 100)]
DECODE_SWEEP = [(2, 2, 4, 1024, 64, 700), (1, 1, 8, 512, 128, 512),
                (2, 4, 1, 300, 96, 37), (1, 1, 48, 4096, 128, 4000),
                (4, 32, 1, 1089, 64, 224), (4, 32, 1, 1089, 64, 0)]
COLD_SETS = 5  # distinct caches a cold-L2 timing rotates over (> 50 MB L2)
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}  # as the JAX tests
DECODE_TOL = {torch.float32: 3e-5, torch.bfloat16: 2e-2}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(phase: str, msg: str) -> None:
    """Print the phase's failure, on standard output as its JSON line and
    on standard error (whose end is what a caller may be shown), and
    exit 1."""
    emit({"phase": phase, "ok": False, "error": msg})
    print(f"chip_smoke: phase {phase} failed: {msg}", file=sys.stderr,
          flush=True)
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


def max_abs_diff(a: torch.Tensor, b: torch.Tensor) -> int:
    """max |a - b| of two integer or bool tensors (0 when empty)."""
    d = (a.long() - b.long()).abs()
    return int(d.max()) if d.numel() else 0


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


def flash_hgmma():
    """True when the flash library's SASS holds HGMMA (wgmma)
    instructions, by ``cuobjdump -sass`` (the phase fails when it holds
    none); None where the toolkit has no cuobjdump."""
    from repro_torch.kernels import build

    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    lib = build._target(build.CSRC / "flash_attention.cu")
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, timeout=120)
    if out.returncode != 0:
        fail("device", f"cuobjdump failed: {out.stderr.strip()[:300]}")
    if "HGMMA" not in out.stdout:
        fail("device", "no HGMMA in the flash library's SASS")
    return True


def phase_device(state: dict) -> None:
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    reports = build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in text.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, text in reports.items()}
    if any("setmaxnreg ignored" in text for text in reports.values()):
        fail("device", "ptxas ignored setmaxnreg in the flash kernel")
    for name in ("flash_attention", "decode_attention", "rank_select",
                 "multi_query_match", "amper_sample"):
        spills = re.findall(r"(\d+) bytes spill stores", reports.get(name, ""))
        if any(int(n) for n in spills):
            fail("device", f"ptxas spills registers in {name}")
    emit({"phase": "device", "ok": True, "flash_sass_hgmma": flash_hgmma(),
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "nvidia_smi": state["smi"], "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": round(build_s, 3),
          "ptxas": ptxas})


# A profiler session now and then records no device event at all (seen
# once in a whole run, on a call that launches one kernel each time), or
# loses some of a session's kernel events, so a reading that the caller
# does not accept is taken again, up to this many sessions in all.  A
# fault of the code (a fill or a second kernel beside the kernel, a call
# that launches twice) shows in every session and still fails.
PROFILER_SESSIONS = 5
# the readings taken again: (what was read, the reading), reported by
# the "profiler" line before the kernels line
PROFILER_RETAKES: list = []


def device_ops(fn, calls: int = 20, accept=bool) -> dict:
    """The device operations of one ``fn()`` call, by torch.profiler after
    a warm call: {kernel name: [operations per call, device us per
    call]}.  A reading that ``accept`` refuses (by default an empty one)
    is taken again, up to PROFILER_SESSIONS sessions; the last reading is
    returned if none was accepted."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for session in range(PROFILER_SESSIONS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        got = {e.key[:100]: [e.count / calls,
                             e.self_device_time_total / calls]
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.count}
        if accept(got):
            return got
        PROFILER_RETAKES.append({"session": session, "reading": got})
    return got


# torch.profiler now and then loses a kernel event (0.95 or 0.98 launches
# a call over 20 calls, in runs where every call launched), so counts of
# device launches are held to [PROFILER_KEEPS x calls, calls]: a second
# kernel or a fill a call still fails.
PROFILER_KEEPS = 0.9


def one_kernel(phase: str, fn, kernel: str) -> dict:
    """``device_ops`` of ``fn``, failing the phase unless a call is one
    launch of ``kernel`` (no fill or other operation beside it)."""
    def one_launch(ops_):
        return (len(ops_) == 1 and kernel in next(iter(ops_))
                and PROFILER_KEEPS <= next(iter(ops_.values()))[0] <= 1.0)

    retaken = len(PROFILER_RETAKES)
    ops_ = device_ops(fn, accept=one_launch)
    if not one_launch(ops_):
        fail(phase, f"one call is not one {kernel} launch in any of "
             f"{PROFILER_SESSIONS} profiler sessions: "
             f"{[r['reading'] for r in PROFILER_RETAKES[retaken:]]}")
    return ops_


def custom_ranges(kind: str, device):
    """Range sets beside the DQN's: m = 1 and m = 64 AMPER-fr ranges,
    ranges no 2^24 window holds (the kernels' integer test) and empty
    ranges only."""
    from repro_torch import prng
    from repro_torch.core import amper

    if kind in ("m1", "m64"):
        m = int(kind[1:])
        cfg = amper.AmperConfig(capacity=N_ROWS, m=m, lam_fr=2.0, v_max=8.0)
        lo, hi = amper.fr_intervals(
            amper.group_representatives(prng.key(m), cfg), cfg)
    elif kind == "wide":
        lo = torch.tensor([-2 ** 30, 5, 3 << 22], dtype=torch.int32)
        hi = torch.tensor([100, 2 ** 30, 2 ** 31 - 1], dtype=torch.int32)
    else:  # "empty"
        lo = torch.tensor([9, 7, 2 ** 31 - 1], dtype=torch.int32)
        hi = torch.tensor([3, 6, -2 ** 31], dtype=torch.int32)
    return lo.to(device), hi.to(device)


BACK_TO_BACK = 1000  # calls queued with no sync, each checked
SLAB_ROWS = 256      # the runtime's slab draw: batch 64 x slab 4


def phase_match(state: dict) -> None:
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import multi_query_match_ref

    dev = torch.device("cuda")
    pq, valid = table(N_ROWS, 1000, dev)
    shard_pq, shard_valid = table(N_ROWS // SHARDS, 0, dev)
    lo, hi = ranges(dev)
    err = 0

    def check(case, p, v, rlo, rhi):
        nonlocal err
        sel, counts = ops.multi_query_match(p, v, rlo, rhi)
        sel_p, counts_p = multi_query_match_ref(p, v, rlo, rhi)
        torch.cuda.synchronize()
        if not torch.equal(sel, sel_p) or not torch.equal(counts, counts_p):
            fail("match", f"{case}: kernel != plain: sel diff "
                 f"{int((sel != sel_p).sum())}, counts {counts.tolist()} vs "
                 f"{counts_p.tolist()}")
        err = max(err, max_abs_diff(sel, sel_p), max_abs_diff(counts, counts_p))
        return sel, counts

    sel, counts = check("n1e6", pq, valid, lo, hi)
    check("shard_250k", shard_pq, shard_valid, lo, hi)
    # the ragged tail past the last whole group of 4 rows and tile
    check("odd_999999", pq[1:].clone(), valid[1:].clone(), lo, hi)
    for n in (0, 1, 700, 250_001):
        check(f"n{n}", shard_pq[:n].clone(), shard_valid[:n].clone(), lo, hi)
    for kind in ("m1", "m64", "wide", "empty"):
        check(kind, shard_pq, shard_valid, *custom_ranges(kind, dev))
    # back to back on one stream: a stale ticket or partial would show
    sets = [ranges(dev, seed) for seed in range(3)]
    want = [multi_query_match_ref(shard_pq, shard_valid, *r) for r in sets]
    outs = [ops.multi_query_match(shard_pq, shard_valid, *sets[i % 3])
            for i in range(BACK_TO_BACK)]
    torch.cuda.synchronize()
    for i, (s_, c_) in enumerate(outs):
        if not (torch.equal(s_, want[i % 3][0])
                and torch.equal(c_, want[i % 3][1])):
            fail("match", f"back-to-back call {i} != plain")
    del outs
    # an offset view would break the kernels' 4-row vector loads
    try:
        ops.multi_query_match(pq[1:], valid[1:], lo, hi)
    except ValueError:
        pass
    else:
        fail("match", "the wrapper took a misaligned offset view")
    split = {"n1e6": one_kernel("match", lambda: ops.multi_query_match(
        pq, valid, lo, hi), "multi_query_match"),
        "shard_250k": one_kernel("match", lambda: ops.multi_query_match(
            shard_pq, shard_valid, lo, hi), "multi_query_match")}
    ms = device_time_ms(lambda: ops.multi_query_match(pq, valid, lo, hi))
    ms_shard = device_time_ms(lambda: ops.multi_query_match(
        shard_pq, shard_valid, lo, hi))
    plain_ms = device_time_ms(
        lambda: multi_query_match_ref(pq, valid, lo, hi), calls=10, reps=3)
    # each input read once, each output written once
    bound_ms = nbytes(pq, valid, lo, hi, sel, counts) / HBM_BYTES_PER_S * 1e3
    bound_shard = (nbytes(shard_pq, shard_valid, lo, hi, counts)
                   + shard_pq.shape[0]) / HBM_BYTES_PER_S * 1e3
    row = {"name": "multi_query_match", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/multi_query_match.cu",
           "replaces": "src/repro/kernels/tcam_match.py:73",
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None}
    state["kernels"]["multi_query_match"] = row
    emit({"phase": "match", "ok": True, "n": N_ROWS, "m": 20,
          "members": int(sel.sum()), "counts_sum": int(counts.sum()),
          "back_to_back": BACK_TO_BACK, "kernel_ms": ms,
          "plain_ms": plain_ms, "bound_ms": bound_ms,
          "kernel_ms_shard_250k": ms_shard, "bound_ms_shard_250k": bound_shard,
          "ops_per_call_and_us": split})


def scratch_words(kernel: str, device) -> torch.Tensor:
    """The scratch that ``kernel`` keeps for the current stream of
    ``device`` (keyed by the tensors' device, which has an index)."""
    from repro_torch.kernels import build

    device = torch.device("cuda", torch.cuda.current_device()) \
        if device.index is None else device
    return build._scratch[(kernel, device, build.stream_key(device))]


# a scratch's epoch word (int32 index): the last finished call's epoch
EPOCH_WORD = {"amper_sample": 0, "rank_select": 2}
MAX_EPOCH = (1 << 30) - 1


def check_epoch_wrap(phase: str, kernel: str, device, call, check) -> None:
    """Set ``kernel``'s epoch word on this stream to 2^30 - 4, then run
    ``call`` 5 times (epochs 2^30 - 3 .. 2^30 - 1, then 1), each result
    held by ``check``, across the epoch that wraps: the kernel must zero
    its status words and go on at epoch 1 (the word then reads 1)."""
    words = scratch_words(kernel, device)
    words[EPOCH_WORD[kernel]] = MAX_EPOCH - 4
    for i in range(5):
        check(f"epoch wrap, call {i}", call())
    torch.cuda.synchronize()
    got = int(words[EPOCH_WORD[kernel]])
    if got != 1:
        fail(phase, f"{kernel}: epoch word {got} after the wrap, not 1")


def sample_cases(pq, valid, shard_pq, shard_valid, lo, hi, device):
    """(name, pq, valid, lo, hi, shift, batch, csp_capacity) of the
    draw's cases at n = 1e6 and one 250k shard (CSP ratio 0.15)."""
    n, ns = pq.shape[0], shard_pq.shape[0]
    full = (pq, valid, lo, hi)
    shard = (shard_pq, shard_valid, lo, hi)
    every = (torch.tensor([-2 ** 31], dtype=torch.int32, device=device),
             torch.tensor([2 ** 31 - 1], dtype=torch.int32, device=device))
    cases = [("n1e6_b64", *full, 4242, 64, 150_000),
             ("shard_250k_b64", *shard, 4242, 64, 37_500),
             # the runtime's slab draw: batch 64 x slab 4 rows at once
             ("n1e6_b256", *full, 4242, SLAB_ROWS, 150_000),
             ("shard_250k_b256", *shard, 4242, SLAB_ROWS, 37_500),
             ("shift_0", *full, 0, 64, 150_000),
             ("shift_last_b300", *full, n - 1, 300, 150_000),
             ("shift_tile_boundary", *full, 1024 * 500, 64, 150_000),
             ("shard_shift_0_b1", *shard, 0, 1, 37_500),
             ("shard_shift_last", *shard, ns - 1, 64, 37_500),
             ("shard_shift_tile_boundary_b300", *shard, 1024 * 100, 300,
              37_500),
             ("b1", *full, 777, 1, 150_000),
             ("truncated_csp64", *full, 12_345, 64, 64),
             ("shard_truncated_csp64", *shard, 12_345, 300, 64),
             ("empty_csp_live_rows", pq, valid,
              *custom_ranges("empty", device), 999, 64, 150_000),
             ("shard_empty_csp", shard_pq, shard_valid,
              *custom_ranges("empty", device), 999, 300, 37_500),
             ("no_live_rows", pq, torch.zeros_like(valid), lo, hi, 5, 64,
              150_000),
             ("every_row_a_member", pq, torch.ones_like(valid), *every,
              333_333, 64, 150_000),
             ("shard_every_row_a_member", shard_pq, shard_valid, *every,
              ns // 2, 300, 37_500),
             ("odd_999999", pq[1:].clone(), valid[1:].clone(), lo, hi,
              500_000, 64, 150_000),
             ("n1", pq[:1].clone(), valid[:1].clone(), lo, hi, 0, 64, 1)]
    cases += [(f"{kind}", *shard[:2], *custom_ranges(kind, device), 31_337,
               64, 37_500) for kind in ("m1", "m64", "wide")]
    cases += [(f"{kind}_n1e6", *full[:2], *custom_ranges(kind, device),
               31_337, 64, 150_000) for kind in ("m1", "m64")]
    return cases


def phase_sample(state: dict) -> None:
    from repro_torch import prng
    from repro_torch.kernels import amper_sample as am
    from repro_torch.kernels import ops
    from repro_torch.kernels.amper_sample import amper_sample_ref

    dev = torch.device("cuda")
    pq, valid = table(N_ROWS, 1000, dev)
    shard_pq, shard_valid = table(N_ROWS // SHARDS, 0, dev)
    lo, hi = ranges(dev)
    err = 0
    results = []

    def check(case, got, want):
        nonlocal err
        torch.cuda.synchronize()
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            fail("sample", f"{case}: kernel != plain: stats "
                 f"{got[1].tolist()} vs {want[1].tolist()}, idx diff "
                 f"{int((got[0] != want[0]).sum())}/{want[0].shape[0]}")
        err = max(err, max_abs_diff(got[0], want[0]),
                  max_abs_diff(got[1], want[1]))

    for i, (name, p, v, rlo, rhi, shift, batch, cap) in enumerate(
            sample_cases(pq, valid, shard_pq, shard_valid, lo, hi, dev)):
        k = prng.key(100 + i)
        want = amper_sample_ref(p, v, rlo, rhi, shift, k, batch=batch,
                                csp_capacity=cap)
        check(name, ops.amper_sample(p, v, rlo, rhi, shift, k, batch=batch,
                                     csp_capacity=cap), want)
        # the same draw with shift and key read on the card
        check(f"{name} (device form)", ops.amper_sample(
            p, v, rlo, rhi, torch.tensor(shift, dtype=torch.int32,
                                         device=dev),
            k.to(dev), batch=batch, csp_capacity=cap), want)
        results.append({"case": name, "n": p.shape[0], "shift": shift,
                        "batch": batch, "cap": cap,
                        "stats": want[1].tolist()})
    # back to back on one stream: stale look-back words would show; the
    # calls take turns over three shifts and keys, at a shard and 1e6
    for name, p, v, cap in (("shard_250k", shard_pq, shard_valid, 37_500),
                            ("n1e6", pq, valid, 150_000)):
        draws = [(7 + 99_991 * j % p.shape[0], prng.key(200 + j))
                 for j in range(3)]
        want = [amper_sample_ref(p, v, lo, hi, sh, k, batch=64,
                                 csp_capacity=cap) for sh, k in draws]
        outs = [ops.amper_sample(p, v, lo, hi, *draws[i % 3], batch=64,
                                 csp_capacity=cap)
                for i in range(BACK_TO_BACK)]
        for i, got in enumerate(outs):
            check(f"{name} back-to-back call {i}", got, want[i % 3])
        del outs
    k = prng.key(7)
    want = amper_sample_ref(shard_pq, shard_valid, lo, hi, 4242, k, batch=64,
                            csp_capacity=37_500)
    check_epoch_wrap("sample", "amper_sample", dev, lambda: ops.amper_sample(
        shard_pq, shard_valid, lo, hi, 4242, k, batch=64,
        csp_capacity=37_500), lambda case, got: check(case, got, want))
    # timed at the fused draw's shape: n = 1e6, batch 64, CSP 150,000
    split = {"n1e6": one_kernel("sample", lambda: ops.amper_sample(
        pq, valid, lo, hi, 4242, k, batch=64, csp_capacity=150_000),
        "amper_sample"),
        "shard_250k": one_kernel("sample", lambda: ops.amper_sample(
            shard_pq, shard_valid, lo, hi, 4242, k, batch=64,
            csp_capacity=37_500), "amper_sample")}
    ms = device_time_ms(lambda: ops.amper_sample(
        pq, valid, lo, hi, 4242, k, batch=64, csp_capacity=150_000))
    ms_shard = device_time_ms(lambda: ops.amper_sample(
        shard_pq, shard_valid, lo, hi, 4242, k, batch=64,
        csp_capacity=37_500))
    # and at the runtime's slab shape (256 rows a draw)
    ms_slab = device_time_ms(lambda: ops.amper_sample(
        pq, valid, lo, hi, 4242, k, batch=SLAB_ROWS, csp_capacity=150_000))
    ms_shard_slab = device_time_ms(lambda: ops.amper_sample(
        shard_pq, shard_valid, lo, hi, 4242, k, batch=SLAB_ROWS,
        csp_capacity=37_500))
    plain_slab_ms = device_time_ms(lambda: amper_sample_ref(
        pq, valid, lo, hi, 4242, k, batch=SLAB_ROWS, csp_capacity=150_000),
        calls=5, reps=3)
    plain_ms = device_time_ms(lambda: amper_sample_ref(
        pq, valid, lo, hi, 4242, k, batch=64, csp_capacity=150_000),
        calls=5, reps=3)
    idx, stats = ops.amper_sample(pq, valid, lo, hi, 4242, k, batch=64,
                                  csp_capacity=150_000)
    # each input read once (shift and key: 16 B), each output written once
    bound_ms = (nbytes(pq, valid, lo, hi, idx, stats) + 16) \
        / HBM_BYTES_PER_S * 1e3
    bound_shard = (nbytes(shard_pq, shard_valid, lo, hi, idx, stats) + 16) \
        / HBM_BYTES_PER_S * 1e3
    idx_slab = torch.empty(SLAB_ROWS, dtype=torch.int32, device=dev)
    bound_slab = (nbytes(pq, valid, lo, hi, idx_slab, stats) + 16) \
        / HBM_BYTES_PER_S * 1e3
    bound_shard_slab = (nbytes(shard_pq, shard_valid, lo, hi, idx_slab,
                               stats) + 16) / HBM_BYTES_PER_S * 1e3
    state["kernels"]["amper_sample"] = {
        "name": "amper_sample", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/amper_sample.cu",
        "replaces": "src/repro/kernels/amper_sample.py:103",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None}
    emit({"phase": "sample", "ok": True, "n": N_ROWS, "cases": results,
          "back_to_back": BACK_TO_BACK, "epoch_wrap": True,
          "max_rows": am.max_rows(dev), "kernel_ms": ms,
          "plain_ms": plain_ms, "bound_ms": bound_ms,
          "kernel_ms_shard_250k": ms_shard, "bound_ms_shard_250k": bound_shard,
          "slab_rows": SLAB_ROWS, "kernel_ms_b256": ms_slab,
          "plain_ms_b256": plain_slab_ms, "bound_ms_b256": bound_slab,
          "kernel_ms_shard_250k_b256": ms_shard_slab,
          "bound_ms_shard_250k_b256": bound_shard_slab,
          "ops_per_call_and_us": split})


def rank_cases(count: int, batch: int, seed: int) -> torch.Tensor:
    """``batch`` ranks in [-5, count + 10), led by 0, count - 1, count,
    count + 5 and two negative ranks."""
    rng = np.random.default_rng(seed)
    r = rng.integers(-5, count + 10, batch)
    r[:6] = [0, count - 1, count, count + 5, -1, -3][:batch]
    return torch.from_numpy(r.astype(np.int32)).cuda()


def member_table(n: int, members, device):
    """pq 7 on the ``members`` rows and 3 elsewhere, all valid: with the
    range [7, 7] the members are exactly those rows."""
    pq = torch.full((n,), 3, dtype=torch.int32)
    pq[torch.as_tensor(list(members), dtype=torch.int64)] = 7
    return pq.to(device), torch.ones(n, dtype=torch.bool, device=device)


def rank_edge_cases(shard_pq, shard_valid, lo, hi, device):
    """(name, pq, valid, lo, hi) of the rank select's edge cases, for its
    1024-row tiles."""
    one = torch.tensor([7], dtype=torch.int32, device=device)
    n = shard_pq.shape[0]
    cases = [
        ("tile_boundaries", *member_table(
            4101, [0, 1023, 1024, 2047, 2048, 3071, 4095, 4096, 4100],
            device), one, one),
        ("last_tile_only", *member_table(n, range(n - 140, n, 7), device),
         one, one),
        ("single_member", *member_table(n, [123_457], device), one, one),
        ("empty_tiles_between", *member_table(n, [5, 6, 200_000, n - 1],
                                              device), one, one),
        ("n1", shard_pq[:1].clone(), shard_valid[:1].clone(), lo, hi),
        ("below_one_tile", shard_pq[:700].clone(), shard_valid[:700].clone(),
         lo, hi),
        ("odd_250001", *table(250_001, 1, device), lo, hi)]
    cases += [(kind, shard_pq, shard_valid, *custom_ranges(kind, device))
              for kind in ("m1", "m64", "wide", "empty")]
    return cases


def phase_rank(state: dict) -> None:
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import rank_select_ref

    dev = torch.device("cuda")
    pq, valid = table(N_ROWS, 1000, dev)
    shard_pq, shard_valid = table(N_ROWS // SHARDS, 0, dev)
    lo, hi = ranges(dev)
    tables = [("n1e6", pq, valid, lo, hi),
              ("shard_250k", shard_pq, shard_valid, lo, hi),
              ("odd_999999", pq[1:].clone(), valid[1:].clone(), lo, hi),
              ("all_invalid", pq, torch.zeros_like(valid), lo, hi)]
    tables += rank_edge_cases(shard_pq, shard_valid, lo, hi, dev)
    err = 0
    results = []
    for i, (name, p, v, rlo, rhi) in enumerate(tables):
        count = int(rank_select_ref(p, v, rlo, rhi, torch.zeros(
            1, dtype=torch.int32, device=dev))[1])
        # every member's rank where there are few, and the batch 0 call
        every = torch.arange(count, dtype=torch.int32, device=dev)
        for batch in (0, 64, 300):
            rank = rank_cases(count, batch, seed=10 * i + batch)
            if batch == 300 and count <= 4096:
                rank = torch.cat([rank, every])
            idx, cnt = ops.rank_select(p, v, rlo, rhi, rank)
            idx_p, cnt_p = rank_select_ref(p, v, rlo, rhi, rank)
            torch.cuda.synchronize()
            if not torch.equal(idx, idx_p) or not torch.equal(cnt, cnt_p):
                fail("rank", f"{name} b{rank.shape[0]}: kernel != plain: "
                     f"count {int(cnt)} vs {int(cnt_p)}, idx diff "
                     f"{int((idx != idx_p).sum())}/{rank.shape[0]}")
            err = max(err, max_abs_diff(idx, idx_p), max_abs_diff(cnt, cnt_p))
        results.append({"case": name, "n": p.shape[0], "members": count})
    # back to back on one stream: stale look-back words or tickets would
    # show; the calls take turns over three range sets and rank sets
    sets = [(*ranges(dev, seed), rank_cases(88_000 + 100 * seed, 64, seed))
            for seed in range(3)]
    want = [rank_select_ref(shard_pq, shard_valid, *s_) for s_ in sets]
    outs = [ops.rank_select(shard_pq, shard_valid, *sets[i % 3])
            for i in range(BACK_TO_BACK)]
    torch.cuda.synchronize()
    for i, (idx, cnt) in enumerate(outs):
        if not (torch.equal(idx, want[i % 3][0])
                and torch.equal(cnt, want[i % 3][1])):
            fail("rank", f"back-to-back call {i} != plain")

    def check_wrap(case, got):
        if not (torch.equal(got[0], want[0][0])
                and torch.equal(got[1], want[0][1])):
            fail("rank", f"{case} != plain")

    check_epoch_wrap("rank", "rank_select", dev, lambda: ops.rank_select(
        shard_pq, shard_valid, *sets[0]), check_wrap)
    # timed at the main path's shape: one shard, the train batch of ranks
    rank = rank_cases(results[1]["members"], 64, seed=3)
    split = {"shard_250k": one_kernel("rank", lambda: ops.rank_select(
        shard_pq, shard_valid, lo, hi, rank), "rank_select")}
    ms = device_time_ms(lambda: ops.rank_select(shard_pq, shard_valid, lo, hi,
                                                rank))
    plain_ms = device_time_ms(lambda: rank_select_ref(
        shard_pq, shard_valid, lo, hi, rank), calls=10, reps=3)
    idx, cnt = ops.rank_select(shard_pq, shard_valid, lo, hi, rank)
    bound_ms = nbytes(shard_pq, shard_valid, lo, hi, rank, idx, cnt) \
        / HBM_BYTES_PER_S * 1e3
    rank_full = rank_cases(results[0]["members"], 64, seed=4)
    split["n1e6"] = one_kernel("rank", lambda: ops.rank_select(
        pq, valid, lo, hi, rank_full), "rank_select")
    ms_full = device_time_ms(lambda: ops.rank_select(pq, valid, lo, hi,
                                                     rank_full))
    bound_full = nbytes(pq, valid, lo, hi, rank_full, idx, cnt) \
        / HBM_BYTES_PER_S * 1e3
    # the runtime's slab draw on a shard: 256 ranks, held and timed
    slab = {}
    for name, p, v, members in (("shard_250k", shard_pq, shard_valid,
                                 results[1]["members"]),
                                ("n1e6", pq, valid, results[0]["members"])):
        rank = rank_cases(members, SLAB_ROWS, seed=5)
        got = ops.rank_select(p, v, lo, hi, rank)
        want = rank_select_ref(p, v, lo, hi, rank)
        torch.cuda.synchronize()
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                             want[1])):
            fail("rank", f"{name} b{SLAB_ROWS}: kernel != plain")
        err = max(err, max_abs_diff(got[0], want[0]))
        slab[f"kernel_ms_{name}_b256"] = device_time_ms(
            lambda: ops.rank_select(p, v, lo, hi, rank))
        slab[f"bound_ms_{name}_b256"] = nbytes(
            p, v, lo, hi, rank, got[0], got[1]) / HBM_BYTES_PER_S * 1e3
    slab["plain_ms_shard_250k_b256"] = device_time_ms(
        lambda: rank_select_ref(shard_pq, shard_valid, lo, hi, rank_cases(
            results[1]["members"], SLAB_ROWS, seed=5)), calls=10, reps=3)
    state["kernels"]["rank_select"] = {
        "name": "rank_select", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rank_select.cu",
        "replaces": "src/repro/kernels/amper_sample.py:276",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None}
    emit({"phase": "rank", "ok": True, "cases": results,
          "back_to_back": BACK_TO_BACK, "epoch_wrap": True,
          "timed": {"n": shard_pq.shape[0], "batch": 64},
          "kernel_ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
          "kernel_ms_n1e6": ms_full, "bound_ms_n1e6": bound_full,
          "slab_rows": SLAB_ROWS, **slab, "ops_per_call_and_us": split})
    write_last_check(state)


# The replay cell's table (perfbench/configs/amper-fr-2e28.json): 16
# shards of 2^24 rows; a request writes its 65,536 drawn rows (int32, as
# ShardedAmperSampler.sample returns them) and 8,192 ring rows (int64).
WRITE_SHARDS, WRITE_SHARD_ROWS = 16, 1 << 24
WRITE_DRAWN, WRITE_INSERTS = 65_536, 8_192


def write_last_check(state: dict) -> None:
    """``ops.write_last`` at both of the replay cell's calls against the
    plain version on the card, over the cell's table: the drawn rows
    (half as many distinct rows as positions, so most rows repeat) and
    a ring arc that wraps past the last row.  Every shard's code and
    live flag equal after each call, twice over the same slots; then
    each call timed."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import write_last_ref

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    shards = list(range(WRITE_SHARDS))
    n = WRITE_SHARDS * WRITE_SHARD_ROWS

    def drawn():
        pool = torch.randint(0, n, (WRITE_DRAWN // 2,), generator=g,
                             device=dev, dtype=torch.int32)
        at = torch.randint(0, pool.numel(), (WRITE_DRAWN,), generator=g,
                           device=dev)
        return pool[at]

    def ring():
        pos = n - WRITE_INSERTS // 2 - int(torch.randint(
            0, 64, (1,), generator=g, device=dev))
        return (pos + torch.arange(WRITE_INSERTS, device=dev)) % n

    def values(b):
        return [torch.randint(0, 1 << 24, (b,), generator=g, device=dev,
                              dtype=torch.int32),
                torch.rand(b, generator=g, device=dev) < 0.7]

    tables = [[torch.randint(0, 1 << 24, (WRITE_SHARD_ROWS,), generator=g,
                             device=dev, dtype=torch.int32)
               for _ in shards],
              [torch.zeros(WRITE_SHARD_ROWS, dtype=torch.bool, device=dev)
               for _ in shards]]
    want = [[t.clone() for t in f] for f in tables]
    calls = {}
    for call, rows in enumerate((drawn, ring) * 2):
        idx = rows()
        vals = values(idx.numel())
        before = ops.launches["write_last"]
        ops.write_last(idx, vals, tables, shards, WRITE_SHARD_ROWS)
        write_last_ref(idx, vals, want, shards, WRITE_SHARD_ROWS)
        torch.cuda.synchronize()
        if ops.launches["write_last"] != before + 1:
            fail("rank", "write_last: not one launch a call")
        if not all(torch.equal(x, y) for f, h in zip(tables, want)
                   for x, y in zip(f, h)):
            fail("rank", f"write_last call {call} ({rows.__name__}, "
                 f"{idx.dtype}): kernel != plain")
        calls[rows.__name__] = (idx, vals)
    def timed(idx, vals) -> dict:
        distinct = int(torch.unique(idx).numel())
        return {
            "rows": idx.numel(), "dtype": str(idx.dtype).split(".")[-1],
            "distinct_rows": distinct,
            "kernel_ms": device_time_ms(lambda: ops.write_last(
                idx, vals, tables, shards, WRITE_SHARD_ROWS)),
            "plain_ms": device_time_ms(lambda: write_last_ref(
                idx, vals, want, shards, WRITE_SHARD_ROWS), calls=10,
                reps=3),
            "bound_ms": (nbytes(idx, *vals) + 5 * distinct)
            / HBM_BYTES_PER_S * 1e3}

    out = {name: timed(*args) for name, args in calls.items()}
    d = out["drawn"]
    state["kernels"]["write_last"] = {
        "name": "write_last", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/write_last.cu",
        "replaces": "none: the reference's sharded update is XLA's scatter",
        "max_abs_err": 0, "ms": d["kernel_ms"], "plain_ms": d["plain_ms"],
        "bound_ms": d["bound_ms"], "bound_by": "bytes", "library_ms": None,
        "ms_inserts": out["ring"]["kernel_ms"]}
    emit({"phase": "write_last", "ok": True, "shards": WRITE_SHARDS,
          "shard_rows": WRITE_SHARD_ROWS, **out})


GRAPH_REPLAYS = 20


def phase_graph(state: dict) -> None:
    """``ops.amper_sample`` (shift and key on the card) and
    ``ops.rank_select`` captured in one CUDA graph after a warm-up on a
    side stream; every replay, with fresh shifts, keys and ranks copied
    into the graph's inputs, and the eager calls on that stream after the
    replays, held against the plain versions: the card's epochs go on
    across replays and eager calls.  A host shift under capture, and
    ``decode_attention`` under capture, must raise."""
    from repro_torch import prng
    from repro_torch.kernels import ops
    from repro_torch.kernels.amper_sample import amper_sample_ref
    from repro_torch.kernels.ref import rank_select_ref

    dev = torch.device("cuda")
    pq, valid = table(N_ROWS, 1000, dev)
    shard_pq, shard_valid = table(N_ROWS // SHARDS, 0, dev)
    lo, hi = ranges(dev)
    count = int(rank_select_ref(shard_pq, shard_valid, lo, hi, torch.zeros(
        1, dtype=torch.int32, device=dev))[1])
    draws = [(int(prng.randint(prng.key(300 + i), (), 0, N_ROWS)),
              prng.key(400 + i), rank_cases(count, 64, seed=500 + i))
             for i in range(GRAPH_REPLAYS + 5)]
    want = [(amper_sample_ref(pq, valid, lo, hi, sh, k, batch=64,
                              csp_capacity=150_000),
             rank_select_ref(shard_pq, shard_valid, lo, hi, r))
            for sh, k, r in draws]
    shift = torch.zeros((), dtype=torch.int32, device=dev)
    key = torch.zeros(2, dtype=torch.int64, device=dev)
    rank = torch.zeros(64, dtype=torch.int32, device=dev)

    def calls():
        return (ops.amper_sample(pq, valid, lo, hi, shift, key, batch=64,
                                 csp_capacity=150_000),
                ops.rank_select(shard_pq, shard_valid, lo, hi, rank))

    def set_inputs(i):
        sh, k, r = draws[i]
        shift.copy_(torch.tensor(sh, dtype=torch.int32))
        key.copy_(k)
        rank.copy_(r)

    def check(case, got, i):
        for name, g, w in (("amper_sample", got[0], want[i][0]),
                           ("rank_select", got[1], want[i][1])):
            if not (torch.equal(g[0], w[0]) and torch.equal(g[1], w[1])):
                fail("graph", f"{case}: {name} != plain")

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # the warm-up makes the scratch
        set_inputs(0)
        got = calls()
        side.synchronize()
        check("warm-up", got, 0)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = calls()
    with torch.cuda.stream(side):
        replays = []
        for i in range(GRAPH_REPLAYS):
            set_inputs(i)
            graph.replay()
            replays.append(tuple(tuple(t.clone() for t in o) for o in out))
        eager = []
        for i in range(GRAPH_REPLAYS, GRAPH_REPLAYS + 5):
            set_inputs(i)
            eager.append(tuple(tuple(t.clone() for t in o)
                               for o in calls()))
        side.synchronize()
        epochs = {k: int(scratch_words(k, dev)[EPOCH_WORD[k]])
                  for k in EPOCH_WORD}
    for i, got in enumerate(replays):
        check(f"replay {i}", got, i)
    for i, got in enumerate(eager):
        check(f"eager call {i} after the replays", got, GRAPH_REPLAYS + i)
    # the warm-up, the replays and the eager calls, each one epoch
    if set(epochs.values()) != {1 + GRAPH_REPLAYS + 5}:
        fail("graph", f"epoch words {epochs} after "
             f"{1 + GRAPH_REPLAYS + 5} calls")
    torch.cuda.synchronize()
    replay_ms = device_time_ms(graph.replay)
    eager_ms = device_time_ms(calls)
    refused = {}
    q, k, v = attention_inputs([(1, 2, 1, 64), (1, 2, 128, 64),
                                (1, 2, 128, 64)], torch.bfloat16, 0)
    cur_len = torch.tensor(100, dtype=torch.int32, device=dev)
    for name, fn in (
            ("amper_sample_host_shift", lambda: ops.amper_sample(
                pq, valid, lo, hi, 4242, prng.key(0), batch=64,
                csp_capacity=150_000)),
            ("decode_attention", lambda: ops.decode_attention(
                q, k, v, cur_len))):
        try:
            with torch.cuda.graph(torch.cuda.CUDAGraph(), stream=side):
                fn()
        except RuntimeError as e:
            refused[name] = str(e)[:80]
        else:
            fail("graph", f"{name} was captured; it must be refused")
    torch.cuda.synchronize()
    emit({"phase": "graph", "ok": True, "replays": GRAPH_REPLAYS,
          "eager_after": 5, "epoch_words": epochs,
          "replay_ms": replay_ms, "eager_ms": eager_ms, "refused": refused})


# The prng phase's cases: key seeds (words (0, 0), (0, 1), (2^32 - 1,
# 2^32 - 1), (0, 2^32 - 1)), split counts, draw shapes, fold_in data and
# randint bounds (spans 1, 2, 10, 2^31, 2^32 - 1, and an empty range).
PRNG_SEEDS = (0, 1, 2 ** 64 - 1, 2 ** 32 - 1)
PRNG_SPLITS = (2, 3, 4, 500, 1_000_000)
PRNG_SHAPES = ((), (16,), (64,), (1_000_000,))
PRNG_FOLDS = (0, 1, 12345, 2 ** 32 - 1)
PRNG_BOUNDS = ((0, 1), (0, 2), (0, 10), (-2 ** 31, 0),
               (-2 ** 31, 2 ** 31 - 1), (7, 7))
PRNG_ENVS = 16  # the training step's env split: its call shape


def phase_prng(state: dict) -> None:
    """The ``prng`` kernel (``csrc/prng.cu``: jax.random's threefry on
    keys on the card) held bit for bit against its plain int64 version
    on the same keys on the card: split at n = 2 .. 1e6, fold_in,
    bits, uniform (two ranges) and randint at shapes () to (1e6,), with
    host bounds and with int32 / int64 bounds on the card, batched keys
    (a contiguous and a strided batch) and edge keys; the small shapes
    also against the host's numpy path.  One call is one launch; one call
    at the training step's shape is timed beside the plain version."""
    from repro_torch import prng
    from repro_torch.kernels import ops
    from repro_torch.kernels import prng as kp

    dev = torch.device("cuda")
    cases = []

    def check(case, got, want, host=None):
        got_w = got.view(torch.int32) if got.dtype == torch.float32 else got
        for name, w in (("plain", want), ("host", host)):
            if w is None:
                continue
            w = w.to(dev)
            w = w.view(torch.int32) if w.dtype == torch.float32 else w
            if got.shape != w.shape or not torch.equal(got_w, w):
                fail("prng", f"{case}: kernel != {name} version")
        cases.append(case)

    for seed in PRNG_SEEDS:
        kh = prng.key(seed)
        k = kh.to(dev)
        for n in PRNG_SPLITS:
            check(f"split {seed} {n}", ops.prng_split(k, (n,)),
                  kp.split_ref(k, (n,)), prng.split(kh, n) if n <= 500  # repro: noqa[PRNG-REUSE] one key, each version
                  else None)
        for d in PRNG_FOLDS:
            check(f"fold_in {seed} {d}", ops.prng_fold_in(k, d),
                  kp.fold_in_ref(k, d), prng.fold_in(kh, d))
        for shape in PRNG_SHAPES:
            small = len(shape) == 0 or shape[0] <= 64
            check(f"bits {seed} {shape}", ops.prng_bits(k, shape),
                  kp.bits_ref(k, shape), prng.bits(kh, shape) if small  # repro: noqa[PRNG-REUSE] one key, each version
                  else None)
            for lo, hi in ((0.0, 1.0), (-0.05, 0.05)):
                check(f"uniform {seed} {shape} {lo} {hi}",
                      ops.prng_uniform(k, shape, lo, hi),
                      kp.uniform_ref(k, shape, lo, hi),
                      prng.uniform(kh, shape, lo, hi) if small else None)  # repro: noqa[PRNG-REUSE] one key, each version
            for lo, hi in PRNG_BOUNDS:
                want = kp.randint_ref(k, shape, lo, hi)
                host = prng.randint(kh, shape, lo, hi) if small else None  # repro: noqa[PRNG-REUSE] one key, each version
                check(f"randint {seed} {shape} [{lo}, {hi})",
                      ops.prng_randint(k, shape, lo, hi), want, host)
                check(f"randint card bounds {seed} {shape} [{lo}, {hi})",
                      ops.prng_randint(
                          k, shape, torch.tensor(lo, device=dev),
                          torch.tensor(hi, dtype=torch.int32, device=dev)),
                      want, host)
    batch = prng.split(prng.key(7), PRNG_ENVS).to(dev)   # contiguous
    strided = prng.split(batch)[:, 1]                   # stride 4
    for name, kb in (("batch", batch), ("strided batch", strided)):
        kb_h = kb.cpu()
        check(f"{name} split", ops.prng_split(kb, (3,)),
              kp.split_ref(kb, (3,)), prng.split(kb_h, 3))
        check(f"{name} fold_in", ops.prng_fold_in(kb, 9),
              kp.fold_in_ref(kb, 9), prng.fold_in(kb_h, 9))
        check(f"{name} uniform", ops.prng_uniform(kb, (4,), -0.05, 0.05),
              kp.uniform_ref(kb, (4,), -0.05, 0.05),
              prng.uniform(kb_h, (4,), -0.05, 0.05))  # repro: noqa[PRNG-REUSE] one key, each version
        check(f"{name} randint", ops.prng_randint(kb, (), 0, 10),
              kp.randint_ref(kb, (), 0, 10), prng.randint(kb_h, (), 0, 10))  # repro: noqa[PRNG-REUSE] one key, each version
        check(f"{name} bits", ops.prng_bits(kb, (64,)),
              kp.bits_ref(kb, (64,)), prng.bits(kb_h, (64,)))  # repro: noqa[PRNG-REUSE] one key, each version
    # the module's dispatch: a key on the card goes to the kernel
    before = ops.launches["prng"]
    k = prng.key(11).to(dev)
    check("prng.split on a card key", prng.split(k, PRNG_ENVS),
          kp.split_ref(k, (PRNG_ENVS,)))
    if ops.launches["prng"] != before + 1:
        fail("prng", "repro_torch.prng.split on a card key did not launch")
    one = one_kernel("prng", lambda: ops.prng_split(k, (PRNG_ENVS,)),
                     "prng_kernel")
    out = ops.prng_split(k, (PRNG_ENVS,))
    ms = device_time_ms(lambda: ops.prng_split(k, (PRNG_ENVS,)))
    plain_ms = device_time_ms(lambda: kp.split_ref(k, (PRNG_ENVS,)))
    bound_ms = nbytes(k, out) / HBM_BYTES_PER_S * 1e3
    big = ops.prng_bits(k, (1_000_000,))
    ms_1e6 = device_time_ms(lambda: ops.prng_bits(k, (1_000_000,)))
    plain_1e6 = device_time_ms(lambda: kp.bits_ref(k, (1_000_000,)),
                               calls=5, reps=3)
    bound_1e6 = nbytes(k, big) / HBM_BYTES_PER_S * 1e3
    state["kernels"]["prng"] = {
        "name": "prng", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/prng.cu",
        "replaces": "none: jax.random's threefry2x32, which XLA runs "
                    "(no pallas_call)",
        "max_abs_err": 0, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None}
    emit({"phase": "prng", "ok": True, "cases": len(cases),
          "launches_per_call": one, "call": f"split(key, {PRNG_ENVS})",
          "kernel_ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
          "kernel_ms_bits_1e6": ms_1e6, "plain_ms_bits_1e6": plain_1e6,
          "bound_ms_bits_1e6": bound_1e6})


def tcam_path(pq: torch.Tensor, valid: torch.Tensor, seed: int = SEED):
    """The paper's per-group TCAM search: the m prefix queries of one
    AMPER-fr draw, one ternary query per launch, ORed and ANDed with
    ``valid``.  Returns the membership, the queries and their masks."""
    from repro_torch import prng
    from repro_torch.core import amper
    from repro_torch.kernels import ops

    cfg = amper.AmperConfig(capacity=N_ROWS, m=20, lam_fr=2.0, v_max=8.0)
    vq, mask = amper.fr_queries(
        amper.group_representatives(prng.key(seed), cfg), cfg)
    vq, mask = vq.to(pq.device), mask.to(pq.device)
    sel = torch.zeros_like(valid)
    for i in range(cfg.m):
        sel |= ops.tcam_match(pq, vq[i], mask[i])
    return sel & valid, vq, mask


def phase_tcam(state: dict) -> None:
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import multi_query_match_ref, tcam_match_ref

    dev = torch.device("cuda")
    pq, valid = table(N_ROWS, 1000, dev)
    lo, hi = ranges(dev)
    err = 0
    for name, p in (("n1e6", pq), ("odd_999999", pq[1:].clone())):
        for width in (0, 7, 15, 20):
            q = torch.tensor(int(p[12_345]), dtype=torch.int32, device=dev)
            mask = torch.tensor((1 << width) - 1, dtype=torch.int32,
                                device=dev)
            out = ops.tcam_match(p, q, mask)
            out_p = tcam_match_ref(p, q, mask)
            torch.cuda.synchronize()
            if not torch.equal(out, out_p):
                fail("tcam", f"{name} mask width {width}: kernel != plain "
                     f"at {int((out != out_p).sum())} rows")
            err = max(err, int((out.int() - out_p.int()).abs().max()))
    # The path: a draw's m group queries as single TCAM searches, which
    # must give the m-range match's membership.
    ops.reset_launches()
    sel, vq, mask = tcam_path(pq, valid)
    torch.cuda.synchronize()
    launches = ops.launches["tcam_match"]
    if launches != 20:
        fail("tcam", f"tcam_match launched {launches} times for 20 queries")
    if not torch.equal(sel, multi_query_match_ref(pq, valid, lo, hi)[0]):
        fail("tcam", "OR of the single TCAM queries != the m-range match")
    state["launches"]["tcam_match"] = launches
    q, m = vq[10], mask[10]
    ms = device_time_ms(lambda: ops.tcam_match(pq, q, m))
    plain_ms = device_time_ms(lambda: tcam_match_ref(pq, q, m), calls=10,
                              reps=3)
    out = ops.tcam_match(pq, q, m)
    bound_ms = nbytes(pq, q, m, out) / HBM_BYTES_PER_S * 1e3
    state["kernels"]["tcam_match"] = {
        "name": "tcam_match", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/tcam_match.cu",
        "replaces": "src/repro/kernels/tcam_match.py:38",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None}
    emit({"phase": "tcam", "ok": True, "n": N_ROWS,
          "path_launches": launches, "members": int(sel.sum()),
          "kernel_ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms})


def attention_inputs(shapes, dtype, seed: int):
    """Standard-normal tensors of the given shapes on the card, from a
    seeded generator there."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(sh, generator=gen, device="cuda").to(dtype)
            for sh in shapes]


def attention_bound(nbytes_moved: int, flops: float) -> tuple[float, str]:
    """The least time (ms) for the bytes at the memory rate and the
    flops at the bf16 tensor-core rate, and which of the two bounds it."""
    by_bytes = nbytes_moved / HBM_BYTES_PER_S * 1e3
    by_ops = flops / BF16_FLOPS * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def check_close(phase: str, case: str, got, want, tol: float) -> float:
    """max |got - want|, failing the phase outside atol = rtol = tol."""
    got, want = got.float(), want.float()
    if not bool(torch.isfinite(got).all()):
        fail(phase, f"{case}: non-finite kernel output")
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, atol=tol, rtol=tol):
        fail(phase, f"{case}: kernel != plain, max |err| {err} > tol {tol}")
    return err


def cold_time_ms(fn, sets) -> float:
    """``device_time_ms`` of ``fn(*inputs)`` with the calls rotating over
    ``sets`` of distinct inputs, so that each call finds its inputs out of
    L2 (as a layer does that follows 23 others)."""
    turn = [0]

    def call():
        turn[0] = (turn[0] + 1) % len(sets)
        fn(*sets[turn[0]])

    return device_time_ms(call)


def phase_flash(state: dict) -> None:
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import attention_ref

    B, H, S, D = SERVE_BATCH, 32, SERVE_PROMPT, 64
    main = (B, H, H, S, D, True, None)
    err = 0.0
    results = []
    for i, (b, hq, hkv, s, d, causal, window) in enumerate(
            [main] + FLASH_SWEEP):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = attention_inputs(
                [(b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d)], dtype, i)
            got = ops.flash_attention(q, k, v, causal=causal, window=window)
            want = attention_ref(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            case = (f"b{b} hq{hq} hkv{hkv} s{s} d{d} causal={causal} "
                    f"window={window} {str(dtype)[6:]}")
            e = check_close("flash", case, got, want, ATTN_TOL[dtype])
            err = max(err, e)
            # flash_attention_launch runs bf16 on the tensor cores
            kernel = "wgmma" if dtype == torch.bfloat16 else "simt"
            results.append({"case": case, "kernel": kernel,
                            "max_abs_err": e})
    # timed at the serving path's prefill shape
    q, k, v = attention_inputs([(B, H, S, D)] * 3, torch.bfloat16, 0)
    ms = device_time_ms(lambda: ops.flash_attention(q, k, v, causal=True))
    plain_ms = device_time_ms(lambda: attention_ref(q, k, v, causal=True),
                              calls=5, reps=3)
    library_ms = device_time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True))
    out = ops.flash_attention(q, k, v, causal=True)
    flops = 2 * 2 * S * S * D * B * H / 2  # q k^T and p v, causal half
    bound_ms, bound_by = attention_bound(nbytes(q, k, v, out), flops)
    state["kernels"]["flash_attention"] = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:30",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}
    emit({"phase": "flash", "ok": True, "cases": results,
          "timed": {"b": B, "h": H, "s": S, "d": D, "dtype": "bfloat16",
                    "causal": True},
          "kernel_ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
          "bound_ms": bound_ms, "bound_by": bound_by,
          "bytes": nbytes(q, k, v, out), "flops": flops,
          "kernel_tflops": flops / ms / 1e9})


def phase_decode(state: dict) -> None:
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels.ref import decode_attention_ref

    B, H, D = SERVE_BATCH, 32, 64
    s_max = SERVE_PROMPT + SERVE_GEN + 1
    main = [(B, H, 1, s_max, D, s_max - 1), (B, H, 1, s_max, D, 37)]
    err = 0.0
    results = []
    for i, (b, hkv, g, s, d, cur) in enumerate(main + DECODE_SWEEP):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = attention_inputs(
                [(b, hkv, g, d), (b, hkv, s, d), (b, hkv, s, d)], dtype,
                100 + i)
            cur_len = torch.tensor(cur, dtype=torch.int32, device="cuda")
            got = ops.decode_attention(q, k, v, cur_len)
            want = decode_attention_ref(q, k, v, cur_len)
            torch.cuda.synchronize()
            case = f"b{b} hkv{hkv} group{g} s{s} d{d} cur{cur} {str(dtype)[6:]}"
            e = check_close("decode", case, got, want, DECODE_TOL[dtype])
            err = max(err, e)
            cut = da.plan(b, hkv, g, s, dtype, build.sm_count(q.device))
            results.append({"case": case, "splits": cut.n_split,
                            "chunk": cut.chunk, "group_tiles": cut.n_gt,
                            "blocks": cut.blocks(b, hkv), "max_abs_err": e})
    # Timed at the last decode step of the serving path's generate, with
    # the cache out of L2 (rotating over COLD_SETS caches, 178 MB) as a
    # decode step finds it, and hot (one cache, 36 MB, stays in L2).
    cur = s_max - 1
    sets = [attention_inputs([(B, H, 1, D), (B, H, s_max, D),
                              (B, H, s_max, D)], torch.bfloat16, 7 + i)
            for i in range(COLD_SETS)]
    q, k, v = sets[0]
    cur_len = torch.tensor(cur, dtype=torch.int32, device="cuda")

    def sdpa(q, k, v):
        return torch.nn.functional.scaled_dot_product_attention(
            q, k[:, :, :cur], v[:, :, :cur], is_causal=False,
            enable_gqa=True)

    ms = cold_time_ms(lambda q, k, v: ops.decode_attention(q, k, v, cur_len),
                      sets)
    library_ms = cold_time_ms(sdpa, sets)
    ms_hot = device_time_ms(lambda: ops.decode_attention(q, k, v, cur_len))
    library_ms_hot = device_time_ms(lambda: sdpa(q, k, v))
    plain_ms = device_time_ms(lambda: decode_attention_ref(q, k, v, cur_len),
                              calls=10, reps=3)
    k_live = k[:, :, :cur]
    out = ops.decode_attention(q, k, v, cur_len)
    # the live rows of the cache, q, cur_len and the output, each once
    moved = nbytes(q, out, cur_len) + 2 * k_live.numel() * k.element_size()
    bound_ms, bound_by = attention_bound(moved, 2 * 2 * cur * D * B * H)
    state["kernels"]["decode_attention"] = {
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:28",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}
    emit({"phase": "decode", "ok": True, "cases": results,
          "timed": {"b": B, "hkv": H, "group": 1, "s": s_max, "d": D,
                    "cur_len": cur, "dtype": "bfloat16", "l2": "cold"},
          "kernel_ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
          "kernel_ms_hot_l2": ms_hot, "library_ms_hot_l2": library_ms_hot,
          "bound_ms": bound_ms, "bound_by": bound_by, "bytes": moved,
          "kernel_gb_per_s": moved / ms / 1e6})


def profile_steps(step, steps: int, out_dir: str, name: str,
                  span_names: tuple) -> dict:
    """Trace ``steps`` calls of ``step()`` with torch.profiler: device busy
    time per step (sum of kernel times, one stream), the idle share,
    kernel launches per step, the top kernels and the host time of the
    named spans.  The chrome trace goes to ``out_dir``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, f"{name}_trace.json"))
    events = prof.key_averages()
    # Span ranges also show up on the device timeline; they are not kernels.
    kernels = [(e.key, e.self_device_time_total, e.count) for e in events
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0 and e.key not in span_names]
    busy_us = sum(t for _, t, _ in kernels)
    sequence = [e.name for e in sorted(
        (e for e in prof.events() if e.device_type == DeviceType.CUDA
         and e.name not in span_names), key=lambda e: e.time_range.start)]
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
                            for n, t, c in top],
            "kernel_sequence": sequence}


# the replay kernels' device names, by wrapper
DRAW_KERNELS = {"amper_sample": "amper_sample_kernel",
                "multi_query_match": "multi_query_match_kernel",
                "rank_select": "rank_select_kernel"}


def check_draw_kernels(phase: str, sequence, calls: dict) -> dict:
    """Fail the phase unless each call of a replay kernel in the profiled
    window was one device launch, with no fill or memset kernel right
    before an ``amper_sample`` or ``multi_query_match`` launch (the device
    operations in launch order, ``calls`` the wrappers' counts over the
    window)."""
    out, before = {}, set()
    for name, kernel in DRAW_KERNELS.items():
        at = [i for i, k in enumerate(sequence) if kernel in k]
        want = calls[name]
        if not PROFILER_KEEPS * want <= len(at) <= want:
            fail(phase, f"{len(at)} device launches of {kernel} for {want} "
                 f"{name} calls")
        out[name] = {"calls": want, "device_launches": len(at)}
        if name != "rank_select":
            before |= {sequence[i - 1][:60] for i in at if i}
    if any("fill" in k.lower() or "memset" in k.lower() for k in before):
        fail(phase, f"a fill runs before a draw kernel: {before}")
    out["kernels_right_before_a_draw_or_match"] = sorted(before)
    return out


def profile_window(dqn, st, out_dir: str, phase: str,
                   steps: int = 20) -> dict:
    """Trace ``steps`` more agent steps (see ``profile_steps``)."""
    from repro_torch import prng

    keys = iter(prng.split(prng.key(SEED + 2), steps))
    box = [st]

    def step():
        box[0], _ = dqn.agent_step(box[0], next(keys))

    return profile_steps(step, steps, out_dir, f"{phase}_steps",
                         ("replay_sample", "csp_rebuild", "sharded_sample"))


def prng_window(dqn, st, steps: int = 50, advance=None):
    """Host time spent in the port's PRNG over ``steps`` agent steps: the
    public draws of ``repro_torch.prng`` (outermost calls only) are timed
    with perf_counter.  A draw that lands on the card includes its copy
    there, which waits for the work queued before it.  The steps are
    ``agent_step``s on host keys, or ``advance(steps)`` (a runner's next
    steps, whose state it returns) where given."""
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
        if advance is not None:
            st = advance(steps)
        else:
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


def plain_twin(sampler, fr_mode: str = "broadcast"):
    """The same sampler with a plain match, the ``broadcast`` one unless
    ``fr_mode`` names another (no kernel)."""
    from repro_torch.core import amper, sharded

    cfg = sampler.cfg._replace(fr_mode=fr_mode)
    if isinstance(sampler, sharded.ShardedAmperSampler):
        return sharded.ShardedAmperSampler(
            cfg, sampler.mesh, axis_names=sampler.axis_names,
            local_csp_capacity=sampler.local_csp_capacity)
    return amper.AmperSampler(cfg, device=sampler.device)


def steady_learn_steps(cfg, a: int, b: int) -> int:
    """Learn steps in [a, b) that do not sync the target: the steps a
    captured run replays (all but its first, the warm-up)."""
    return sum(1 for t in range(a, b) if t >= cfg.learn_start
               and t % cfg.train_every == 0 and t % cfg.target_sync)


def runner_steps(runner, steps: int) -> float:
    """Wall seconds of the runner's next ``steps`` steps, synchronized."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner.advance(runner.state.step + steps)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def train_phase(state: dict, phase: str, steps: int, kernels: dict,
                trace_dir: str | None = None, steady_steps: int = 200,
                mesh=None, **cfg_kw) -> None:
    """Train DQN on CartPole with a 1M replay through the trainer's runner
    (``train`` is ``runner(init(key), key, n).advance(n)``: step keys and
    schedules on the card, the steady step captured where it can be) and
    check that the run launched each kernel ``kernels[name]`` times per
    learn step (a graph replay counts the launches it holds), the PRNG
    kernel and ``write_last`` as ``sharded_writes`` derives; then time
    steady learn steps, the host PRNG and the draw, and hold the draw on
    the trained buffer (indices and IS weights) against the same
    sampler's plain broadcast match.  The ``fused``
    phase adds the captured run's parity and report (``fused_capture``)."""
    from repro_torch import prng
    from repro_torch.core.replay_buffer import ReplayBuffer
    from repro_torch.kernels import ops
    from repro_torch.models.qhead import tree_leaves
    from repro_torch.rl.dqn import DQNConfig, make_dqn

    cfg = DQNConfig(env="cartpole", num_envs=16, replay_size=N_ROWS,
                    batch=64, hidden=128, v_max=8.0, learn_start=100,
                    **cfg_kw)
    dqn = make_dqn(cfg, device="cuda", mesh=mesh)
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
    runner = dqn.runner(dqn.init(key), key, steps)
    st = runner.advance(steps)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches, info = dict(ops.launches), runner.info
    captured = info["captured"]
    learn_steps = sum(1 for t in range(steps)
                      if t >= cfg.learn_start and t % cfg.train_every == 0)
    if captured and info["graph_replays"] != steady_learn_steps(
            cfg, 0, steps) - 1:
        fail(phase, f"{info['graph_replays']} graph replays, not every "
             f"steady learn step but the warm-up")
    for kernel, per_step in kernels.items():
        if launches[kernel] != per_step * learn_steps:
            fail(phase, f"{kernel} launched {launches[kernel]} times in "
                 f"{learn_steps} learn steps ({info['graph_replays']} "
                 f"replayed), not {per_step} a learn step")
        state["launches"][kernel] = (state["launches"].get(kernel, 0)
                                     + launches[kernel])
    writes = sharded_writes(cfg, 0, steps)["write_last"]
    if launches["write_last"] != writes:
        fail(phase, f"write_last launched {launches['write_last']} times in "
             f"{steps} steps and {learn_steps} learn steps, not {writes}")
    if launches["prng"] < 1:
        fail(phase, "the run's step keys never reached the prng kernel")
    for kernel in ("write_last", "prng"):
        state["launches"][kernel] = (state["launches"].get(kernel, 0)
                                     + launches[kernel])
    flat = tree_leaves(st.params)
    if not all(bool(torch.isfinite(t).all()) for t in flat):
        fail(phase, "non-finite params")
    losses = torch.stack(runner.metrics["loss"])[cfg.learn_start:]
    if not bool(torch.isfinite(losses).all()):
        fail(phase, "non-finite loss")
    # Steady state: learn steps past learn_start and warm-up, timed alone
    # (agent_step on host keys, the eager path of every phase).
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
    idx, _, w = dqn.replay.sample(buf, k, cfg.batch)
    plain = ReplayBuffer(cfg.replay_size, plain_twin(dqn.replay.sampler),
                         alpha=cfg.alpha, beta=cfg.beta)
    idx_p, _, w_p = plain.sample(buf, k, cfg.batch)
    if not torch.equal(idx, idx_p) or not torch.equal(w, w_p):
        fail(phase, f"{phase} draw != broadcast draw on the trained buffer")
    if trace_dir is not None:
        ops.reset_launches()
        prof = profile_window(dqn, st, trace_dir, phase)
        sequence = prof.pop("kernel_sequence")
        prof["draw_kernels"] = check_draw_kernels(phase, sequence,
                                                  dict(ops.launches))
        emit({"phase": f"{phase}_profile", "ok": True, **prof})
    capture = (fused_capture(state, dqn, st, steps, steady_steps, trace_dir)
               if captured else {})
    emit({"phase": phase, "ok": True, "sampler": cfg.sampler,
          "fr_mode": cfg.amper_fr_mode, "captured": captured,
          "shards": getattr(dqn.replay.sampler, "n_shards", 1),
          "steps": steps, "learn_steps": learn_steps, "launches": launches,
          "graph_replays": info["graph_replays"],
          "eager_steps": info["eager_steps"], "capture_s": info["capture_s"],
          "replay_launches": info["replay_launches"],
          "init_s": init_s, "train_s": train_s,
          "steady_steps": steady_steps, "steps_per_s": 1e3 / step_ms,
          "step_ms": step_ms, "draw_ms": draw_ms,
          "draw_share": draw_ms / step_ms, **prng_stats,
          "loss_last": float(losses[-1]), "replay_rows": int(buf.size),
          **capture})


PARITY_STEADY = 200   # steady steps of the captured-vs-eager parity run
PARITY_FLOAT_TOL = 0.0  # params and Adam moments: bit for bit


def fused_parity(dqn) -> dict:
    """The captured run against the eager one on host keys, from one
    seed, over ``learn_start + PARITY_STEADY`` steps: every step's
    sampled rows, and the whole final state (ring, priorities, stamps,
    counters, env state, returns ring, params, target, Adam moments)
    bit for bit."""
    from repro_torch import prng
    from repro_torch.models.qhead import tree_leaves

    cfg = dqn.cfg
    n = cfg.learn_start + PARITY_STEADY
    key = prng.key(SEED + 6)
    runner = dqn.runner(dqn.init(key), key, n, record_idx=True)
    a = runner.advance(n)
    if not runner.info["captured"]:
        fail("fused", "the parity run was not captured")
    b, idx_b = dqn.init(key), []
    for k in prng.split(prng.fold_in(key, 1), n):
        b, m = dqn.agent_step(b, k)
        idx_b.append(m["idx"])
    torch.cuda.synchronize()
    for t, (x, y) in enumerate(zip(runner.idx, idx_b)):
        if (x is None) != (y is None) or (x is not None
                                          and not torch.equal(x, y)):
            fail("fused", f"step {t}: the captured draw != the eager one")
    ints = [(a.buffer.storage[f], b.buffer.storage[f])
            for f in a.buffer.storage]
    ints += list(zip(a.buffer.sampler_state, b.buffer.sampler_state))
    ints += [(a.buffer.write_stamp, b.buffer.write_stamp),
             (a.buffer.write_gen, b.buffer.write_gen),
             (a.buffer.max_priority, b.buffer.max_priority),
             (a.env_state.x, b.env_state.x), (a.env_state.t, b.env_state.t),
             (a.obs, b.obs), (a.episode_return, b.episode_return),
             (a.last_returns, b.last_returns),
             (a.n_episodes, b.n_episodes)]
    if not all(same_bits(x, y) for x, y in ints):
        fail("fused", "captured ring, priorities, env or returns != eager")
    counters = ("pos", "size", "total_adds", "add_gen")
    if any(getattr(a.buffer, c) != getattr(b.buffer, c) for c in counters):
        fail("fused", "captured ring counters != eager")
    floats = [(x, y) for f in ("params", "target_params", "opt_m", "opt_v")
              for x, y in zip(tree_leaves(getattr(a, f)),
                              tree_leaves(getattr(b, f)))]
    diff = max(float((x - y).abs().max()) for x, y in floats)
    if diff > PARITY_FLOAT_TOL:
        fail("fused", f"captured params / Adam moments != eager: max |diff| "
             f"{diff}")
    return {"parity_steps": n, "parity_steady_steps": PARITY_STEADY,
            "parity_graph_replays": runner.info["graph_replays"],
            "parity_idx_steps": sum(x is not None for x in idx_b),
            "parity_int_state_bit_equal": True,
            "parity_float_bit_equal": all(same_bits(x, y)
                                          for x, y in floats),
            "parity_float_tolerance": PARITY_FLOAT_TOL,
            "parity_float_max_abs_diff": diff}


def fused_capture(state: dict, dqn, st, steps: int, steady_steps: int,
                  trace_dir: str | None) -> dict:
    """The ``fused`` phase's capture report: parity (``fused_parity``),
    then steady steps/s, host PRNG ms a step, device operations a step
    and the idle share, captured (the trainer's runner continued past
    the main run) and eager (the same runner with ``capture=False``: keys
    on the card; and ``agent_step`` on host keys), each profiled over a
    20-step window whose draw launches are checked."""
    from repro_torch import prng
    from repro_torch.analysis.launches import graph_nodes
    from repro_torch.kernels import ops

    out = fused_parity(dqn)
    cfg = dqn.cfg
    span_names = ("replay_sample", "csp_rebuild", "sharded_sample")
    base = st.step
    n = base + 10 + steady_steps + 50 + 20
    cap = dqn.runner(st, prng.key(SEED + 4), n)
    cap.advance(base + 10)  # warm-up and capture
    cap_s = runner_steps(cap, steady_steps)
    _, cap_prng = prng_window(dqn, None, 50, lambda k: cap.advance(
        cap.state.step + k))
    t_end = cap.state.step + 20
    window_learn = sum(1 for t in range(cap.state.step, t_end)
                       if t >= cfg.learn_start)
    ops.reset_launches()
    cap_prof = profile_steps(lambda: cap.advance(cap.state.step + 1), 20,
                             trace_dir or os.path.join(ROOT, "profile_out"),
                             "fused_captured_steps", span_names)
    got = dict(ops.launches)  # a replay counts the launches it holds
    if got["amper_sample"] != window_learn:
        fail("fused", f"{got['amper_sample']} amper_sample launches in a "
             f"window of {window_learn} learn steps")
    cap_prof["draw_kernels"] = check_draw_kernels(
        "fused", cap_prof.pop("kernel_sequence"), got)
    base = cap.state.step
    eag = dqn.runner(cap.state, prng.key(SEED + 5),
                     base + 10 + steady_steps + 50, capture=False)
    eag.advance(base + 10)
    eag_s = runner_steps(eag, steady_steps)
    st, eag_prng = prng_window(dqn, None, 50, lambda k: eag.advance(
        eag.state.step + k))
    ops.reset_launches()
    host_prof = profile_window(dqn, st, trace_dir or os.path.join(
        ROOT, "profile_out"), "fused_host_keys")
    host_prof["draw_kernels"] = check_draw_kernels(
        "fused", host_prof.pop("kernel_sequence"), dict(ops.launches))
    if trace_dir is None:
        shutil.rmtree(os.path.join(ROOT, "profile_out"), ignore_errors=True)
    keep = ("wall_ms_per_step", "device_busy_ms_per_step",
            "device_idle_share", "kernel_launches_per_step")
    return {**out, "capture_steps_per_s": steady_steps / cap_s,
            "capture_step_ms": cap_s / steady_steps * 1e3,
            "capture_prng_host_ms_per_step": cap_prng["prng_host_ms_per_step"],
            "capture_prng_calls_per_step": cap_prng["prng_calls_per_step"],
            "capture_profile": {k: cap_prof[k] for k in keep},
            "capture_graph_nodes": graph_nodes(cap.graph),
            "capture_replay_launches": cap.info["replay_launches"],
            "eager_card_keys_steps_per_s": steady_steps / eag_s,
            "eager_card_keys_prng_host_ms_per_step":
                eag_prng["prng_host_ms_per_step"],
            "eager_host_keys_profile": {k: host_prof[k] for k in keep}}


def per_sharded_run(mesh, steps: int = 100) -> None:
    """A short DQN run with the sharded PER baseline on the same mesh:
    finite returns, losses and params."""
    from repro_torch import prng
    from repro_torch.models.qhead import tree_leaves
    from repro_torch.rl.dqn import DQNConfig, make_dqn

    cfg = DQNConfig(env="cartpole", sampler="per-sharded", num_envs=16,
                    replay_size=N_ROWS, batch=64, hidden=128,
                    learn_start=50)
    dqn = make_dqn(cfg, device="cuda", mesh=mesh)
    t0 = time.perf_counter()
    st, metrics = dqn.train(prng.key(SEED), steps)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    returns = torch.stack(metrics["return_mean"])
    losses = torch.stack(metrics["loss"])[cfg.learn_start:]
    if not (bool(torch.isfinite(returns).all())
            and bool(torch.isfinite(losses).all())
            and all(bool(torch.isfinite(t).all())
                    for t in tree_leaves(st.params))):
        fail("sharded", "per-sharded run: non-finite returns, loss or params")
    emit({"phase": "sharded_per", "ok": True, "captured": False,
          "sampler": cfg.sampler,
          "shards": dqn.replay.sampler.n_shards, "steps": steps,
          "train_s": train_s, "return_mean_last": float(returns[-1]),
          "loss_last": float(losses[-1])})


# Fig. 9: the paper's replay sizes (benchmarks/fig9_hw_latency.py) and
# DQN's, at the paper's m, CSP ratio and batch.
FIG9_SIZES = (5_000, 10_000, 20_000, 1_000_000)
FIG9_M, FIG9_CSP_RATIO, FIG9_BATCH = 20, 0.15, 64
FIG9_CALLS = 50
FIG9_FILL = 8192  # rows a priority write while filling a table
# the paper's headline bands against a GPU PER (x), Sec. 5.3
FIG9_BANDS = {"k": (55, 170), "fr": (118, 270)}
MODELED = ("the paper's 45 nm TCAM circuit model (Table 2 latencies, "
           "repro_torch.core.hwmodel), not a measurement")


def batch_times(fn, calls: int = FIG9_CALLS) -> tuple[float, float]:
    """(host wall ms, device ms by CUDA events) of one synchronized
    ``fn()`` call, each the median of ``calls``."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    wall, dev = [], []
    for _ in range(calls):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        dev.append(start.elapsed_time(end))
    return float(np.median(wall)), float(np.median(dev))


def phase_fig9(state: dict) -> None:
    """Fig. 9 against PER on this card: the per-batch time (a 64-row
    ``sample`` and a 64-row priority ``update``, keys on the card) of the
    port's ``per-sumtree`` and ``per-cumsum`` and of its AMPER-fr
    ``fused`` draw, at 5k, 10k, 20k and 1M rows, host wall and CUDA
    events, medians of ``FIG9_CALLS``; beside them the modeled AMPER-fr
    and AMPER-k latencies and their speedups over the measured sum tree,
    with the paper's bands.  The model is the paper's circuit model, not
    a measurement, and every line says so."""
    from repro_torch import prng
    from repro_torch.core import hwmodel as hw
    from repro_torch.core.samplers import make_sampler

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    for n in FIG9_SIZES:
        row = {"phase": "fig9", "ok": True, "rows": n, "m": FIG9_M,
               "csp_ratio": FIG9_CSP_RATIO, "batch": FIG9_BATCH,
               "card": state["smi"], "calls": FIG9_CALLS}
        fill = prng.uniform(prng.key(SEED).to(dev), (n,)) + 0.01
        new_p = prng.uniform(prng.key(SEED + 1).to(dev),
                             (FIG9_BATCH,)) + 0.01
        for kind in ("per-sumtree", "per-cumsum", "amper-fr"):
            sampler = make_sampler(kind, n, device=dev, m=FIG9_M,
                                   lam_fr=2.0, csp_ratio=FIG9_CSP_RATIO,
                                   v_max=1.1, min_csp=FIG9_BATCH,
                                   fr_mode="fused")
            st = sampler.init()
            for lo in range(0, n, FIG9_FILL):  # unique rows a write
                rows = torch.arange(lo, min(lo + FIG9_FILL, n), device=dev)
                st = sampler.update(st, rows, fill[rows])
            keys = iter(prng.split(prng.key(SEED + 2).to(dev),
                                   FIG9_CALLS + 3))

            def batch(sampler=sampler, st=st, keys=keys):
                idx = sampler.sample(st, next(keys), FIG9_BATCH)
                sampler.update(st, idx.long(), new_p)

            wall, events = batch_times(batch)
            row[f"{kind}_ms_wall"], row[f"{kind}_ms_events"] = wall, events
        cfg = hw.HwConfig(er_size=n, m=FIG9_M, csp_ratio=FIG9_CSP_RATIO,
                          batch=FIG9_BATCH)
        gpu_us = row["per-sumtree_ms_wall"] * 1e3
        gpu_dev_us = row["per-sumtree_ms_events"] * 1e3
        row.update({
            "modeled": MODELED,
            "modeled_fr_ns": hw.latency_fr_ns(cfg),
            "modeled_k_ns": hw.latency_k_ns(cfg),
            "modeled_update_ns": hw.latency_update_ns(cfg),
            "modeled_speedup_fr_vs_sumtree_wall":
                hw.speedup_vs_gpu(cfg, gpu_us, "fr"),
            "modeled_speedup_k_vs_sumtree_wall":
                hw.speedup_vs_gpu(cfg, gpu_us, "k"),
            "modeled_speedup_fr_vs_sumtree_events":
                hw.speedup_vs_gpu(cfg, gpu_dev_us, "fr"),
            "modeled_speedup_k_vs_sumtree_events":
                hw.speedup_vs_gpu(cfg, gpu_dev_us, "k"),
            "paper_band_fr": FIG9_BANDS["fr"],
            "paper_band_k": FIG9_BANDS["k"]})
        if not all(np.isfinite(v) and v > 0 for k, v in row.items()
                   if k.endswith(("_wall", "_events", "_ns"))):
            fail("fig9", f"non-finite or non-positive time at {n} rows")
        emit(row)
    emit({"phase": "fig9_done", "ok": True, "modeled": MODELED,
          "phase_s": time.perf_counter() - t0})


def phase_launch_budget(state: dict) -> None:
    """``python -m repro_torch.analysis --launch-budget`` in a process of
    its own: the kernel nodes of the fused draw's graph and of the
    trainer's captured step against the committed budget; a finding
    fails the run.  Then the same graphs built and profiled in this
    process, after the run's other profiler sessions, and the kernel
    names each reading missed or added against the fresh process's: the
    profiler's losses, reported and not held (``analysis/launches.py``)."""
    from collections import Counter

    from repro_torch.analysis import launches

    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--launch-budget",
         "--format", "json"], capture_output=True, text=True, timeout=600,
        cwd=ROOT, env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")})
    rc = out.returncode
    try:
        payload = json.loads(out.stdout)
    except ValueError:
        fail("launch_budget", f"exit {rc}, no findings payload: "
             f"{out.stderr.strip()[-400:]}")
    counts = payload.get("launch_counts", {})
    if rc != 0:
        fail("launch_budget", f"exit {rc}: {payload['findings']}; nodes "
             f"{ {k: v['nodes'] for k, v in counts.items()} }")
    draw, inputs = launches.captured_draw()
    runner = launches.captured_step()
    here = {}
    for name, g in (("amper-fr-fused draw", draw),
                    ("captured agent step", runner.graph)):
        seen, names = launches.profiled_kernels(g.replay)
        fresh = Counter(counts[name]["profiled_names"])
        here[name] = {
            "nodes": launches.graph_nodes(g), "profiled_kernels": seen,
            "missed_vs_fresh": {k[:100]: v for k, v in (fresh - names)
                                .items()},
            "added_vs_fresh": {k[:100]: v for k, v in (names - fresh)
                               .items()}}
    del inputs, runner
    emit({"phase": "launch_budget", "ok": True, "exit": rc,
          "fresh_process": {k: {"nodes": v["nodes"],
                                "profiled_kernels": v["profiled_kernels"]}
                            for k, v in counts.items()},
          "this_process": here, "budgets": launches.BUDGETS,
          "budget_card": launches.BUDGET_CARD, "card": state["smi"]})


# The analysis gate, as the repo runs it on the CPU (README), here with
# RECOMPILE's card half: the trainer's runner captures its step once.
ANALYSIS_PATHS = ("src/repro_torch", "tests/test_torch_*.py",
                  "examples/torch_*.py", "chip_smoke.py")
ANALYSIS_BASELINE = "analysis-baseline-torch.json"
# The examples' twins on the card (each in a process of its own, at its
# default --device cuda): name, arguments.  The cart-pole twin's steps
# keep its four samplers under about a minute; the LM twin trains the
# reduced stablelm; the serve twin runs two of the reference example's
# archs reduced.
EXAMPLES_LM_CKPT = os.path.join(ROOT, "build", "examples_lm_ckpt")
EXAMPLES = (
    ("torch_quickstart", []),
    ("torch_dqn_cartpole", ["--num-envs", "16", "--steps", "400"]),
    ("torch_lm_train", ["--steps", "10", "--ckpt-dir", EXAMPLES_LM_CKPT]),
    ("torch_serve_decode", ["--arch", "hymba-1.5b"]),
    ("torch_serve_decode", ["--arch", "rwkv6-7b"]))
EXAMPLES_TIMEOUT = 300
QUICKSTART_PER_TOL = 1e-3  # as tests/test_torch_examples.py's PER_TOL


def src_env() -> dict:
    return {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}


def phase_analysis(state: dict) -> None:
    """``python -m repro_torch.analysis`` over the port, its tests, its
    examples and this script against ``analysis-baseline-torch.json``,
    in a process of its own on the card: the AST lint, DTYPE-WIDE,
    RECOMPILE's CPU half and its card half (the trainer's runner over
    two ``advance`` calls, new keys, beta values and buffer contents at
    every steady step: exactly one capture).  Any finding or a non-zero
    exit fails the run."""
    import glob

    paths = [p for pattern in ANALYSIS_PATHS
             for p in sorted(glob.glob(os.path.join(ROOT, pattern)))]
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", *paths,
         "--baseline", os.path.join(ROOT, ANALYSIS_BASELINE),
         "--format", "json"], capture_output=True, text=True, timeout=600,
        cwd=ROOT, env=src_env())
    wall_s = time.perf_counter() - t0
    try:
        payload = json.loads(out.stdout)
    except ValueError:
        fail("analysis", f"exit {out.returncode}, no findings payload: "
             f"{out.stderr.strip()[-600:]}")
    if out.returncode != 0 or payload["total"] != 0:
        fail("analysis", f"exit {out.returncode}: {payload['findings'][:5]}")
    card = payload.get("recompile_card", {})
    if "skipped" in card:
        fail("analysis", f"RECOMPILE's card half skipped: {card['skipped']}")
    last = list(card.values())[-1]
    if last["captures"] != 1 or last["graph_replays"] == 0:
        fail("analysis", f"the runner's captures over two advances: {card}")
    emit({"phase": "analysis", "ok": True, "exit": out.returncode,
          "paths": len(paths), "findings": payload["total"],
          "counts": payload["counts"], "baselined": payload["suppressed"],
          "captures": last["captures"], "recompile_card": card,
          "xla_float_f64_outputs": payload["xla_float_f64_outputs"],
          "wall_s": wall_s, "card": state["smi"]})


# A twin's process: its module run as a library, ``main(argv)`` called,
# and what ``main`` returns (the table's rows unrounded, the quickstart's
# means, an exit code) printed as the last line.
RUN_TWIN = ("import json, runpy, sys; twin = runpy.run_path(sys.argv[1]); "
            "print(json.dumps(twin['main'](sys.argv[2:])))")


def twin_path(name: str) -> str:
    return os.path.join(ROOT, "examples", f"{name}.py")


def example_run(name: str, args: list) -> dict:
    """One twin in a process of its own: exit code (non-zero, or a
    non-zero code from ``main``, fails the phase), wall seconds, its
    printed table and what ``main`` returned."""
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-c", RUN_TWIN, twin_path(name), *args],
        capture_output=True, text=True, timeout=EXAMPLES_TIMEOUT, cwd=ROOT,
        env=src_env())
    wall_s = time.perf_counter() - t0
    lines = out.stdout.strip().splitlines()
    if out.returncode != 0 or not lines or lines[-1] in ("1", "2"):
        fail("examples", f"{name} {' '.join(args)} exited {out.returncode}: "
             f"{out.stderr.strip()[-600:]} {lines[-3:]}")
    return {"twin": name, "args": args, "exit": out.returncode,
            "wall_s": wall_s, "stdout": lines[:-1],
            "returned": json.loads(lines[-1])}


def phase_examples(state: dict) -> None:
    """Each example twin on the card (``EXAMPLES``): its table, what its
    ``main`` returned and its wall seconds.  The quickstart's means on
    the card are held against its run on the CPU in this process: the
    buffer's, AMPER's and the replay cycle's equal, PER's within
    ``QUICKSTART_PER_TOL`` (the cumulative sums round differently)."""
    import contextlib
    import io
    import math
    import runpy

    runs = [example_run(name, args) for name, args in EXAMPLES]
    shutil.rmtree(EXAMPLES_LM_CKPT, ignore_errors=True)
    rows = runs[1]["returned"]
    if [r["sampler"] for r in rows] != ["uniform", "per-sumtree", "amper-k",
                                        "amper-fr"] or not all(
            math.isfinite(r["frames_per_s"]) for r in rows):
        fail("examples", f"the cart-pole twin's rows: {rows}")
    if not rows[-1]["captured"]:
        fail("examples", "the cart-pole twin's fused AMPER-fr step was not "
             "captured")
    card = runs[0]["returned"]
    with contextlib.redirect_stdout(io.StringIO()):
        host = runpy.run_path(twin_path("torch_quickstart"))["main"](
            ["--device", "cpu"])
    for name in ("buffer", "AMPER-fr", "AMPER-k", "replay_reward",
                 "max_priority"):
        if card[name] != host[name]:
            fail("examples", f"quickstart {name}: card {card[name]} != "
                 f"CPU {host[name]}")
    if abs(card["PER"] - host["PER"]) > QUICKSTART_PER_TOL:
        fail("examples", f"quickstart PER: card {card['PER']}, CPU "
             f"{host['PER']}")
    emit({"phase": "examples", "ok": True, "card": state["smi"],
          "runs": runs, "quickstart_cpu": host,
          "wall_s": sum(r["wall_s"] for r in runs)})


def same_agent_state(a, b) -> bool:
    """Params, Adam moments, ring storage and sampler state bit for bit."""
    from repro_torch.models.qhead import tree_leaves

    pairs = [(x, y) for t in ("params", "target_params", "opt_m", "opt_v")
             for x, y in zip(tree_leaves(getattr(a, t)),
                             tree_leaves(getattr(b, t)))]
    pairs += [(a.buffer.storage[k], b.buffer.storage[k])
              for k in a.buffer.storage]
    pairs += list(zip(a.buffer.sampler_state, b.buffer.sampler_state))
    return all(torch.equal(x, y) for x, y in pairs)


TABLE1_SEEDS, TABLE1_STEPS, TABLE1_STEADY = 2, 300, 100
TABLE1_RUNS = (  # (a) and (b): env, sampler, agent, n_step, fr_mode
    ("acrobot", "amper-k", "double", 3, "broadcast"),
    ("mountaincar", "amper-fr", "dueling", 1, "fused"),
)


def table1_run(state: dict, env: str, sampler: str, agent: str, n_step: int,
               fr_mode: str) -> tuple:
    """S seeds of DQN in lockstep through ``train_many`` at the training
    phases' width (1M replay), then ``evaluate_many``; seed 0 retrained
    alone through ``train`` must end in the same state bit for bit.
    Returns (the agent, its states, the run's numbers)."""
    from repro_torch import prng
    from repro_torch.kernels import ops
    from repro_torch.models.qhead import tree_leaves
    from repro_torch.rl.dqn import DQNConfig, make_dqn

    cfg = DQNConfig(env=env, sampler=sampler, agent=agent, n_step=n_step,
                    amper_fr_mode=fr_mode, num_envs=16, replay_size=N_ROWS,
                    batch=64, hidden=128, v_max=8.0, learn_start=100)
    dqn = make_dqn(cfg, device="cuda")
    keys = torch.stack([prng.key(SEED + s) for s in range(TABLE1_SEEDS)])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in keys:                       # set-up alone: S 1M-row replays
        dqn.init(k)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ops.reset_launches()
    t0 = time.perf_counter()
    states, metrics = dqn.train_many(keys, TABLE1_STEPS)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = dict(ops.launches)
    learn_steps = sum(1 for t in range(TABLE1_STEPS)
                      if t >= cfg.learn_start and t % cfg.train_every == 0)
    want = TABLE1_SEEDS * learn_steps if fr_mode == "fused" else 0
    if launches["amper_sample"] != want or \
            sum(launches.values()) != launches["amper_sample"]:
        fail("table1", f"{env}/{sampler}: launches {launches}, want "
             f"{want} amper_sample ({learn_steps} learn steps a seed)")
    state["launches"]["amper_sample"] = (
        state["launches"].get("amper_sample", 0) + launches["amper_sample"])
    losses = metrics["loss"][:, cfg.learn_start:]
    if not (bool(torch.isfinite(losses).all()) and all(
            bool(torch.isfinite(t).all())
            for st in states for t in tree_leaves(st.params))):
        fail("table1", f"{env}/{sampler}: non-finite params or loss")
    scores = dqn.evaluate_many(
        states, torch.stack([prng.key(SEED + 100 + s)
                             for s in range(TABLE1_SEEDS)]), 3)
    if scores.shape != (TABLE1_SEEDS,) or not bool(
            torch.isfinite(scores).all()):
        fail("table1", f"{env}/{sampler}: scores {scores.tolist()}")
    alone, _ = dqn.train(keys[0], TABLE1_STEPS)
    if not same_agent_state(alone, states[0]):
        fail("table1", f"{env}/{sampler}: train_many's seed 0 != train")
    # Steady lockstep iterations past the run, timed alone.
    step_keys = prng.split(prng.key(SEED + 4), (TABLE1_STEADY, TABLE1_SEEDS))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for ks in step_keys:
        for s, k in enumerate(ks):
            states[s], _ = dqn.agent_step(states[s], k)
    torch.cuda.synchronize()
    steady_s = time.perf_counter() - t0
    return dqn, states, {
        "sampler": sampler, "agent": agent, "n_step": n_step,
        "fr_mode": fr_mode, "seeds": TABLE1_SEEDS, "steps": TABLE1_STEPS,
        "learn_steps_per_seed": learn_steps, "launches": launches,
        "init_s": init_s, "train_s": train_s,
        "train_lockstep_per_s": TABLE1_STEPS / train_s,
        "steady_lockstep_per_s": TABLE1_STEADY / steady_s,
        "steady_ms_per_seed_step": steady_s / (TABLE1_STEADY
                                               * TABLE1_SEEDS) * 1e3,
        "eval_scores": scores.tolist(), "train_equals_train_many_seed0": True,
        "replay_rows": int(states[0].buffer.size)}


def phase_table1(state: dict) -> None:
    """The paper's learning path: AMPER-k and AMPER-fr over S seeds in
    lockstep (see ``table1_run``), then on the trained 1M-row tables each
    kNN mode of ``build_csp_k`` on the card held exactly against the same
    mode on the CPU (timed as a draw and as device work), and the
    ``interval`` and ``window`` draws held against ``broadcast``."""
    from repro_torch import prng
    from repro_torch.core import amper
    from repro_torch.core.replay_buffer import ReplayBuffer

    out = {}
    dqn, states, out["acrobot/amper-k"] = table1_run(state, *TABLE1_RUNS[0])
    st = states[0].buffer.sampler_state
    cpu = amper.AmperState(st.pq.cpu(), st.valid.cpu())
    key = prng.key(SEED + 5)
    knn = {}
    for mode in amper.KNN_MODES:
        cfg = dqn.replay.sampler.cfg._replace(knn_mode=mode)
        got = amper.build_csp_k(st.pq, st.valid, key, cfg)
        want = amper.build_csp_k(cpu.pq, cpu.valid, key, cfg)
        for f in ("selected", "indices", "count"):
            if not torch.equal(getattr(got, f).cpu(), getattr(want, f)):
                fail("table1", f"build_csp_k {mode}: {f} differs from the "
                     "CPU")
        smp = amper.AmperSampler(cfg, "k", device="cuda")

        def build():
            return amper.build_csp_k(st.pq, st.valid, key, cfg)

        split = sorted(device_ops(build).items(), key=lambda kv: -kv[1][1])
        knn[mode] = {
            "csp_count": int(want.count),
            "draw_ms": wall_ms(lambda: smp.sample(st, key, 64)),
            "build_csp_k_device_ms": device_time_ms(build, calls=4),
            "device_operations": sum(n for n, _ in dict(split).values()),
            "top_device_us": {k[:60]: v for k, v in split[:4]}}
    del dqn, states, st
    dqn, states, out["mountaincar/amper-fr"] = table1_run(
        state, *TABLE1_RUNS[1])
    buf, k = states[0].buffer, prng.key(SEED + 1)
    cfg = dqn.cfg
    draws = {"fused": dqn.replay.sample(buf, k, cfg.batch)}
    for mode in ("broadcast", "interval", "window"):
        twin = ReplayBuffer(cfg.replay_size,
                            plain_twin(dqn.replay.sampler, mode),
                            alpha=cfg.alpha, beta=cfg.beta)
        draws[mode] = twin.sample(buf, k, cfg.batch)
    idx_b, _, w_b = draws["broadcast"]
    for mode, (idx, _, w) in draws.items():
        if not torch.equal(idx, idx_b) or not torch.equal(w, w_b):
            fail("table1", f"the {mode} draw != the broadcast draw on the "
                 "trained buffer")
    emit({"phase": "table1", "ok": True, "captured": False, "runs": out,
          "replay": N_ROWS,
          "knn_modes": knn, "knn_cpu_exact": True,
          "fr_modes_equal_broadcast": sorted(draws)})


# The pixel path (Breakout and Freeway, the uint8 frame store, the conv
# Q-heads) at the training phases' width.  (a)-(c) train through ``train``,
# (d) through ``train_many``: name, env, sampler, agent, n_step, fr_mode,
# steps, steady learn steps timed after the run, and the replay kernels'
# launches per learn step (and seed).  With learn_start 100, (b) and (d)
# learn on 50 steps.
PIXEL_RUNS = (
    ("a", "breakout", "amper-fr", "double-dueling", 3, "fused", 500, 200,
     {"amper_sample": 1}),
    ("b", "freeway", "amper-fr", "dqn", 1, "kernel", 150, 50,
     {"multi_query_match": 1}),
    ("c", "breakout", "amper-fr-sharded", "dqn", 1, "fused", 200, 200,
     {"multi_query_match": SHARDS, "rank_select": SHARDS}),
    ("d", "freeway", "amper-fr", "dqn", 1, "fused", 150, 50,
     {"amper_sample": 1}),
)
PIXEL_SEEDS = 2
# Q-values of the conv heads on the card against the CPU, atol = rtol:
# float32 throughout (TF32 off), so the two differ only in the order of
# their sums (cuDNN's conv and cuBLAS against the CPU's, 1,024-term dense
# rows), about 1e-6; a frame stack or flatten in the wrong order moves
# Q-values by their own size (0.1-1).
PIXEL_Q_TOL = 1e-4


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal dtype, shape and bits (a float -0.0 is not 0.0)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def frame_store_bytes(buf, frame_store) -> dict:
    """The frame store's bytes on the card (storage and stamps), and those
    of a float buffer holding the same transitions with stacked ``obs``
    and ``next_obs`` in place of the frame."""
    frame = buf.storage["frame"]
    stored = nbytes(*buf.storage.values(), buf.write_stamp, buf.write_gen)
    stack = frame[0].numel() * frame_store.history_len * 4   # float32
    as_float = stored - nbytes(frame) + 2 * frame.shape[0] * stack
    return {"frame_store_bytes": stored, "float_stacked_bytes": as_float,
            "bytes_per_transition": stored / frame.shape[0],
            "float_bytes_per_transition": as_float / frame.shape[0]}


def pixel_check(phase: str, dqn, st, key) -> dict:
    """On a trained state: time the draw, ``materialize``, the actor's
    step (``act``) and the learner's (``learn``) alone, split
    ``materialize`` into device operations, hold the card's materialized
    batch at the drawn rows and 400 rows around the write head (written
    rows, the head and unwritten ones) against the CPU's on a copy of the
    buffer bit for bit, and the conv head's Q-values on it against the
    CPU within ``PIXEL_Q_TOL``."""
    from repro_torch.core.replay_buffer import ReplayBuffer
    from repro_torch.core.samplers import make_sampler
    from repro_torch.models.qhead import tree_map

    rb, buf, batch = dqn.replay, st.buffer, dqn.cfg.batch
    idx = rb.sampler.sample(buf.sampler_state, key, batch)
    draw_ms = wall_ms(lambda: rb.sampler.sample(buf.sampler_state, key,
                                                batch))
    materialize_ms = wall_ms(lambda: rb.materialize(buf, idx))
    split = device_ops(lambda: rb.materialize(buf, idx))
    head = (buf.pos + torch.arange(-200, 200, device=idx.device)) \
        % rb.capacity
    _, batch_, w = rb.sample(buf, key, batch)
    act_ms = wall_ms(lambda: dqn.act(st.params, st.env_state, st.obs,
                                     st.step, key))
    learn_ms = wall_ms(lambda: dqn.learn(st.params, st.target_params,
                                         st.opt_m, st.opt_v, st.step,
                                         batch_, w))
    rows = torch.cat([idx.long(), head])
    got = rb.materialize(buf, rows)
    cpu_rb = ReplayBuffer(rb.capacity, make_sampler(
        "uniform", rb.capacity, device="cpu"), frame_store=rb.frame_store)
    cpu_buf = buf._replace(
        storage={k: v.cpu() for k, v in buf.storage.items()},
        sampler_state=None, max_priority=buf.max_priority.cpu(),
        write_stamp=buf.write_stamp.cpu(), write_gen=buf.write_gen.cpu())
    want = cpu_rb.materialize(cpu_buf, rows.cpu())
    for k in want:
        if not same_bits(got[k].cpu(), want[k]):
            fail(phase, f"materialize {k}: the card's != the CPU's")
    with torch.no_grad():
        q = dqn.q_apply(st.params, got["obs"]).cpu()
        q_cpu = dqn.q_apply(tree_map(lambda t: t.cpu(), st.params),
                            want["obs"])
    if not (bool(torch.isfinite(q).all()) and torch.allclose(
            q, q_cpu, rtol=PIXEL_Q_TOL, atol=PIXEL_Q_TOL)):
        fail(phase, f"conv Q-values on the card != the CPU's: max |err| "
             f"{float((q - q_cpu).abs().max())}")
    return {"draw_ms": draw_ms, "materialize_ms": materialize_ms,
            "act_ms": act_ms, "learn_ms": learn_ms,
            "materialize_device_operations": sum(n for n, _ in
                                                 split.values()),
            "materialize_device_us": sum(t for _, t in split.values()),
            "materialize_cpu_exact_rows": int(rows.numel()),
            "q_max_abs_err_vs_cpu": float((q - q_cpu).abs().max()),
            "q_tol": PIXEL_Q_TOL, "obs_nonzero_share": float(
                (got["obs"] != 0).float().mean())}


def pixel_launches(phase: str, launches: dict, per_step: dict,
                   learn_steps: int, writes: dict) -> None:
    """Fail unless the run launched each replay kernel ``per_step`` times a
    learn step, ``write_last`` as ``writes`` says (``sharded_writes``),
    and no other kernel (the PRNG kernel aside: ``train``'s keys live on
    the card)."""
    want = {k: per_step.get(k, 0) * learn_steps for k in launches}
    want.update(writes)
    want["prng"] = launches["prng"]
    if launches != want:
        fail(phase, f"launches {launches}, want {want} ({learn_steps} "
             "learn steps)")


def pixel_run(state: dict, run, trace_dir: str | None) -> None:
    """One pixel run through ``train`` (see ``PIXEL_RUNS``): launches
    checked exactly, uint8 stacks and frames, finite params and losses,
    steady learn steps timed alone, ``pixel_check``, the draw held
    against the same sampler's plain broadcast match, and a greedy
    evaluation."""
    from repro_torch import prng
    from repro_torch.core.replay_buffer import ReplayBuffer
    from repro_torch.distributed.sharding import Mesh
    from repro_torch.kernels import ops
    from repro_torch.models.qhead import tree_leaves
    from repro_torch.rl.dqn import DQNConfig, make_dqn

    name, env, sampler, agent, n_step, fr_mode, steps, steady, per_step = run
    phase = f"pixel_{name}"
    mesh = (Mesh([torch.device("cuda", 0)] * SHARDS)
            if sampler.endswith("sharded") else None)
    cfg = DQNConfig(env=env, sampler=sampler, agent=agent, n_step=n_step,
                    amper_fr_mode=fr_mode, num_envs=16, replay_size=N_ROWS,
                    batch=64, hidden=128, history_len=4, v_max=8.0,
                    learn_start=100)
    dqn = make_dqn(cfg, device="cuda", mesh=mesh)
    key = prng.key(SEED)
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
    pixel_launches(phase, launches, per_step, learn_steps,
                   sharded_writes(cfg, 0, steps))
    for k, n in launches.items():
        state["launches"][k] = state["launches"].get(k, 0) + n
    if st.obs.dtype != torch.uint8 or \
            st.buffer.storage["frame"].dtype != torch.uint8:
        fail(phase, "the frame stack or the frame store is not uint8")
    losses = torch.stack(metrics["loss"])[cfg.learn_start:]
    if not (bool(torch.isfinite(losses).all()) and all(
            bool(torch.isfinite(t).all()) for t in tree_leaves(st.params))):
        fail(phase, "non-finite params or loss")
    keys = prng.split(prng.key(SEED + 4), steady)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in keys:
        st, _ = dqn.agent_step(st, k)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / steady * 1e3
    k = prng.key(SEED + 1)
    checks = pixel_check(phase, dqn, st, k)
    buf = st.buffer
    idx, batch, w = dqn.replay.sample(buf, k, cfg.batch)
    plain = ReplayBuffer(cfg.replay_size, plain_twin(dqn.replay.sampler),
                         alpha=cfg.alpha, beta=cfg.beta,
                         frame_store=dqn.replay.frame_store)
    idx_p, batch_p, w_p = plain.sample(buf, k, cfg.batch)
    if not (torch.equal(idx, idx_p) and torch.equal(w, w_p) and all(
            same_bits(batch[f], batch_p[f]) for f in batch)):
        fail(phase, f"{fr_mode} draw != broadcast draw on the trained buffer")
    ret = dqn.evaluate(st, prng.key(SEED + 100), 4)
    if not np.isfinite(ret):
        fail(phase, f"evaluation return {ret}")
    prof = None
    if trace_dir is not None:
        ops.reset_launches()
        prof = profile_window(dqn, st, trace_dir, phase)
        sequence = prof.pop("kernel_sequence")
        prof["draw_kernels"] = check_draw_kernels(phase, sequence,
                                                  dict(ops.launches))
    emit({"phase": "pixel", "run": name, "ok": True, "captured": False,
          "env": env,
          "sampler": sampler, "agent": agent, "n_step": n_step,
          "fr_mode": fr_mode,
          "shards": getattr(dqn.replay.sampler, "n_shards", 1),
          "steps": steps, "learn_steps": learn_steps, "launches": launches,
          "init_s": init_s, "train_s": train_s, "steady_steps": steady,
          "steps_per_s": 1e3 / step_ms, "step_ms": step_ms, **checks,
          "draw_share": checks["draw_ms"] / step_ms,
          "materialize_share": checks["materialize_ms"] / step_ms,
          **frame_store_bytes(buf, dqn.replay.frame_store),
          "replay_rows": int(buf.size), "eval_return": ret,
          "loss_last": float(losses[-1]), "profile": prof})


def pixel_train_many(state: dict, run, trace_dir: str | None) -> None:
    """Run (d): ``PIXEL_SEEDS`` seeds in lockstep through ``train_many``,
    ``evaluate_many``, seed 0 retrained alone through ``train`` and held
    bit for bit, steady lockstep iterations, and ``pixel_check`` on
    seed 0."""
    from repro_torch import prng
    from repro_torch.kernels import ops
    from repro_torch.models.qhead import tree_leaves
    from repro_torch.rl.dqn import DQNConfig, make_dqn

    name, env, sampler, agent, n_step, fr_mode, steps, steady, per_step = run
    phase = f"pixel_{name}"
    # cuDNN's conv weight gradient may sum with atomics, in an order that
    # changes from call to call; the bit-for-bit check of train_many's seed
    # 0 against train needs its deterministic algorithms (TF32 is off).
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    cfg = DQNConfig(env=env, sampler=sampler, agent=agent, n_step=n_step,
                    amper_fr_mode=fr_mode, num_envs=16, replay_size=N_ROWS,
                    batch=64, hidden=128, history_len=4, v_max=8.0,
                    learn_start=100)
    dqn = make_dqn(cfg, device="cuda")
    keys = torch.stack([prng.key(SEED + s) for s in range(PIXEL_SEEDS)])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in keys:
        dqn.init(k)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ops.reset_launches()
    t0 = time.perf_counter()
    states, metrics = dqn.train_many(keys, steps)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = dict(ops.launches)
    learn_steps = sum(1 for t in range(steps)
                      if t >= cfg.learn_start and t % cfg.train_every == 0)
    pixel_launches(phase, launches, {k: PIXEL_SEEDS * n
                                     for k, n in per_step.items()},
                   learn_steps, {"write_last": PIXEL_SEEDS * sharded_writes(
                       cfg, 0, steps)["write_last"]})
    for k, n in launches.items():
        state["launches"][k] = state["launches"].get(k, 0) + n
    losses = metrics["loss"][:, cfg.learn_start:]
    if not (bool(torch.isfinite(losses).all()) and all(
            bool(torch.isfinite(t).all())
            for st in states for t in tree_leaves(st.params))):
        fail(phase, "non-finite params or loss")
    scores = dqn.evaluate_many(states, torch.stack(
        [prng.key(SEED + 100 + s) for s in range(PIXEL_SEEDS)]), 2)
    if scores.shape != (PIXEL_SEEDS,) or not bool(
            torch.isfinite(scores).all()):
        fail(phase, f"scores {scores.tolist()}")
    alone, _ = dqn.train(keys[0], steps)
    if not (same_agent_state(alone, states[0])
            and torch.equal(alone.obs, states[0].obs)):
        fail(phase, "train_many's seed 0 != train")
    torch.backends.cudnn.deterministic = deterministic
    step_keys = prng.split(prng.key(SEED + 4), (steady, PIXEL_SEEDS))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for ks in step_keys:
        for s, k in enumerate(ks):
            states[s], _ = dqn.agent_step(states[s], k)
    torch.cuda.synchronize()
    steady_s = time.perf_counter() - t0
    checks = pixel_check(phase, dqn, states[0], prng.key(SEED + 1))
    prof = None
    if trace_dir is not None:
        ops.reset_launches()
        prof = profile_window(dqn, states[0], trace_dir, phase)
        sequence = prof.pop("kernel_sequence")
        prof["draw_kernels"] = check_draw_kernels(phase, sequence,
                                                  dict(ops.launches))
    emit({"phase": "pixel", "run": name, "ok": True, "captured": False,
          "env": env,
          "sampler": sampler, "agent": agent, "n_step": n_step,
          "fr_mode": fr_mode, "seeds": PIXEL_SEEDS, "steps": steps,
          "learn_steps_per_seed": learn_steps, "launches": launches,
          "init_s": init_s, "train_s": train_s, "steady_steps": steady,
          "steady_lockstep_per_s": steady / steady_s,
          "steady_ms_per_seed_step": steady_s / (steady * PIXEL_SEEDS)
          * 1e3, **checks,
          **frame_store_bytes(states[0].buffer, dqn.replay.frame_store),
          "eval_returns": scores.tolist(),
          "train_equals_train_many_seed0": True, "profile": prof})


def phase_pixel(state: dict, trace_dir: str | None) -> None:
    """The pixel path's four runs (``PIXEL_RUNS``)."""
    for run in PIXEL_RUNS[:-1]:
        pixel_run(state, run, trace_dir)
    pixel_train_many(state, PIXEL_RUNS[-1], trace_dir)


# The resume phase: checkpoints and telemetry on the card.  (a) CartPole
# DQN + fused AMPER-fr through ``train_ckpt`` at the ``fused`` phase's
# width (1M replay), uninterrupted, killed at its first save and resumed,
# and ``train``; (b) a 4-shard Breakout frame store restored onto 2 shards
# and onto 1, then learning on 2; (c) a Breakout kill and resume with full
# and delta saves; (d) (a) again with telemetry on, and the replay health
# probe against the production draw.  Steps and save interval of (a), (b)
# and (c); (b) stops at its first save and resumes for its last 20 steps.
RESUME_A = (600, 200)
RESUME_B = (170, 150)
RESUME_C = (240, 120)
RESUME_DELTA_STEPS = (200, 30)   # steps between a full save and its delta
RESUME_TIMED_SAVES = 3
RESUME_STEADY = 100              # steady steps a turn, telemetry off / on


def learn_steps_between(cfg, a: int, b: int) -> int:
    return sum(1 for t in range(a, b)
               if t >= cfg.learn_start and t % cfg.train_every == 0)


def same_state(a, b) -> bool:
    """Every leaf of two checkpointable trees (an ``AgentState``) equal:
    names, dtypes, shapes and bits of the tensors, the host counters."""
    from repro_torch.train import checkpoint as ck

    na, la = ck._flatten_with_names(a)
    nb, lb = ck._flatten_with_names(b)
    return na == nb and all(
        same_bits(x, y) if isinstance(x, torch.Tensor)
        else type(x) is type(y) and x == y for x, y in zip(la, lb))


def fs_type(path: str) -> str:
    out = subprocess.run(["stat", "-f", "-c", "%T", path],
                         capture_output=True, text=True, timeout=30)
    return out.stdout.strip() or "unknown"


def resume_cfg(**kw):
    from repro_torch.rl.dqn import DQNConfig

    base = dict(env="cartpole", num_envs=16, replay_size=N_ROWS, batch=64,
                hidden=128, v_max=8.0, learn_start=100, sampler="amper-fr",
                amper_fr_mode="fused")
    base.update(kw)
    return DQNConfig(**base)


def sharded_writes(cfg, a: int, b: int) -> dict:
    """``write_last``'s launches in a DQN's steps ``[a, b)`` on one card:
    a sharded sampler's update launches it once, and the run updates once
    an add (every step, 1-step returns) and once a learn step; a dense
    sampler never launches it."""
    n = (b - a) + learn_steps_between(cfg, a, b)
    return {"write_last": n if cfg.sampler.endswith("-sharded") else 0}


def counted(phase: str, want: dict, fn):
    """``fn()`` with the kernels' counts zeroed just before and read just
    after; the phase fails unless they equal ``want`` (absent = 0), the
    PRNG kernel's aside (its count follows where the keys live)."""
    from repro_torch.kernels import ops

    ops.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    got = dict(ops.launches)
    if {k: v for k, v in got.items() if k != "prng"} != {
            k: want.get(k, 0) for k in got if k != "prng"}:
        fail(phase, f"launches {got}, want {want}")
    return out, got


def add_launches(state: dict, got: dict) -> None:
    for k, n in got.items():
        state["launches"][k] = state["launches"].get(k, 0) + n


def kill_and_resume(phase: str, dqn, key, n: int, interval: int,
                    directory: str, want_first: dict, want_rest: dict):
    """Preempt ``train_ckpt`` at its first save, resume it from a fresh
    manager to ``n``; the launches of each part counted exactly.
    Returns (state, resume seconds, launches)."""
    from repro_torch.train.checkpoint import CheckpointManager

    mgr = CheckpointManager(directory, save_interval=interval)
    mgr.request_preemption()
    (_, _, done), first = counted(phase, want_first,
                                  lambda: dqn.train_ckpt(key, n, mgr))
    if done != interval:
        fail(phase, f"preempted run stopped at {done}, not {interval}")
    t0 = time.perf_counter()
    (st, _, done), rest = counted(phase, want_rest, lambda: dqn.train_ckpt(
        key, n, CheckpointManager(directory, save_interval=interval)))
    resume_s = time.perf_counter() - t0
    if done != n:
        fail(phase, f"resumed run stopped at {done}, not {n}")
    return st, resume_s, {k: first[k] + rest[k] for k in first}


def save_and_delta(phase: str, dqn, st, directory: str, step: int,
                   extra: int) -> tuple:
    """On a trained state checkpointed at ``step`` in ``directory``: time
    ``RESUME_TIMED_SAVES`` full saves (elsewhere) and the restore, hold
    the restore against the state (and, for a frame store, the
    materialized batch of one draw), then run ``extra`` more steps and
    save, time and restore one ``replay_dirty`` delta against ``step``.
    Returns (the state after the extra steps, numbers)."""
    from repro_torch import prng
    from repro_torch.train import checkpoint as ck
    from repro_torch.train import replay_checkpoint as rck

    rb = dqn.replay

    def view(s):
        return s._replace(buffer=rck.dense_view(rb, s.buffer))

    full_path = ck._file_path(directory, step)
    save_ms = []
    timing = ck.CheckpointManager(directory + "_timing", keep=1)
    for i in range(RESUME_TIMED_SAVES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        timing.save(step + i, view(st))
        save_ms.append((time.perf_counter() - t0) * 1e3)
    shutil.rmtree(directory + "_timing")
    restore_ms = []
    for _ in range(RESUME_TIMED_SAVES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        back = dqn.load_ckpt(directory, step)
        torch.cuda.synchronize()
        restore_ms.append((time.perf_counter() - t0) * 1e3)
    if not same_state(back, st):
        fail(phase, f"the full checkpoint at {step} restores another state")
    out = {"full_save_bytes": os.path.getsize(full_path),
           "full_save_ms_median": float(np.median(save_ms)),
           "full_save_ms": save_ms,
           "restore_ms_median": float(np.median(restore_ms)),
           "restore_ms": restore_ms}
    if rb.frame_store is not None:
        k = prng.key(SEED + 7)
        idx = rb.sampler.sample(st.buffer.sampler_state, k, dqn.cfg.batch)
        got = rb.materialize(back.buffer, idx.long())
        want = rb.materialize(st.buffer, idx.long())
        if not all(same_bits(got[f], want[f]) for f in want):
            fail(phase, "materialize after the restore != before it")
        out["materialize_equal_after_restore"] = True
    del back
    marks = rck.replay_marks(st.buffer)
    rows = []
    for key in prng.split(prng.key(SEED + 8), extra):
        st, m = dqn.agent_step(st, key)
        if m["idx"] is not None:
            rows.append(m["idx"])
    touched = torch.cat(rows).cpu().tolist() if rows else []
    dirty = ck.dirty_like(view(st), True)._replace(
        buffer=rck.replay_dirty(rb, st.buffer, marks, touched))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = ck.save_incremental(directory, step + extra, view(st),
                               base_step=step, dirty=dirty,
                               meta={"step": step + extra})
    delta_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    back = dqn.load_ckpt(directory, step + extra)
    torch.cuda.synchronize()
    delta_restore_ms = (time.perf_counter() - t0) * 1e3
    if not same_state(back, st):
        fail(phase, f"the delta at {step + extra} restores another state")
    out.update({"delta_steps": extra, "delta_bytes": os.path.getsize(path),
                "delta_save_ms": delta_ms,
                "delta_restore_ms": delta_restore_ms,
                "delta_rows_touched": len(set(touched))})
    return st, out


def steady_rate(dqn, st, steps: int, seed: int):
    from repro_torch import prng

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in prng.split(prng.key(seed), steps):
        st, _ = dqn.agent_step(st, k)
    torch.cuda.synchronize()
    return st, steps / (time.perf_counter() - t0)


def resume_flat(state: dict, root: str) -> dict:
    """(a) and (d): CartPole fused AMPER-fr at 1M rows."""
    from repro_torch import obs, prng
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.rl.dqn import make_dqn

    cfg = resume_cfg()
    n, interval = RESUME_A
    dqn = make_dqn(cfg, device="cuda")
    key = prng.key(SEED)

    def draws(a, b):  # one train / train_ckpt call over [a, b)
        return {"amper_sample": learn_steps_between(cfg, a, b)}

    t0 = time.perf_counter()
    (st_a, _, done), got = counted("resume_a", draws(0, n), lambda: dqn.
                                   train_ckpt(key, n, CheckpointManager(
                                       f"{root}/a", save_interval=interval)))
    run_s = time.perf_counter() - t0
    add_launches(state, got)
    st_b, resume_s, got = kill_and_resume(
        "resume_a", dqn, key, n, interval, f"{root}/b", draws(0, interval),
        draws(interval, n))
    add_launches(state, got)
    (st_t, _), got = counted("resume_a", draws(0, n),
                             lambda: dqn.train(key, n))
    add_launches(state, got)
    if not (same_state(st_a, st_b) and same_state(st_a, st_t)):
        fail("resume_a", "uninterrupted, resumed and train states differ")
    del st_b, st_t
    shutil.rmtree(f"{root}/b")
    # (d) telemetry: run A again with a registry and a JSONL log.
    reg = obs.Registry()
    log = f"{root}/telemetry.jsonl"
    exporter = obs.JsonlExporter(log)
    prev = obs.set_registry(reg)
    try:
        t0 = time.perf_counter()
        (st_d, _, _), got_d = counted(
            "resume_d", draws(0, n), lambda: dqn.train_ckpt(
                key, n, CheckpointManager(f"{root}/d",
                                          save_interval=interval)))
        run_d_s = time.perf_counter() - t0
        exporter.write_snapshot(reg.snapshot(), extra={"step": n})
    finally:
        obs.set_registry(prev)
        exporter.close()
    add_launches(state, got_d)
    metrics = [r for r in obs.read_jsonl(log)
               if r["kind"] == "snapshot"][-1]["metrics"]
    spans = {name: metrics[f"span_{name}_ms"]["count"]
             for name in ("replay_sample", "checkpoint_save", "steady_step")}
    # a replayed draw records no replay_sample span: the eager learn
    # steps and the warm-up record one, and every steady step (the
    # warm-up and the replays) a steady_step span
    steady = steady_learn_steps(cfg, 0, n)
    if spans != {"replay_sample": learn_steps_between(cfg, 0, n)
                 - steady + 1, "checkpoint_save": n // interval,
                 "steady_step": steady}:
        fail("resume_d", f"span counts {spans}")
    if not same_state(st_a, st_d):
        fail("resume_d", "the run with telemetry ended in another state")
    del st_d
    shutil.rmtree(f"{root}/d")
    st_a, saves = save_and_delta("resume_a", dqn, st_a, f"{root}/a", n,
                                 RESUME_DELTA_STEPS[0])
    shutil.rmtree(f"{root}/a")
    # Steady steps/s in turns: off, on, on, off.
    rates = {"off": [], "on": []}
    for i, mode in enumerate(("off", "on", "on", "off")):
        prev = obs.set_registry(obs.Registry() if mode == "on" else None)
        try:
            st_a, rate = steady_rate(dqn, st_a, RESUME_STEADY, SEED + 10 + i)
        finally:
            obs.set_registry(prev)
        rates[mode].append(rate)
    health = resume_health(state, dqn, st_a, reg)
    return {"a": {"steps": n, "save_interval": interval,
                  "learn_steps": learn_steps_between(cfg, 0, n),
                  "launches_per_run": draws(0, n), "run_s": run_s,
                  "resume_s": resume_s,
                  "equal_resumed_uninterrupted_train": True, **saves},
            "d": {"launches": got_d, "run_s": run_d_s,
                  "span_counts": spans,
                  "span_checkpoint_save_ms": metrics[
                      "span_checkpoint_save_ms"],
                  "span_replay_sample_ms_mean": metrics[
                      "span_replay_sample_ms"]["mean"],
                  "checkpoint_full_bytes": metrics[
                      "checkpoint_full_bytes"]["value"],
                  "steady_steps": RESUME_STEADY,
                  "steady_steps_per_s_off": rates["off"],
                  "steady_steps_per_s_on": rates["on"],
                  "log_records": len(obs.read_jsonl(log)),
                  "equal_state_with_telemetry": True, **health}}


def resume_health(state: dict, dqn, st, reg) -> dict:
    """``ReplayHealth`` and the probe on the trained 1M table with the key
    of a production draw, for the agent's fused sampler and a ``kernel``
    twin: the probe's sampled priorities equal the draw's, bit for bit,
    and the KL gauge is finite."""
    from repro_torch import obs, prng

    smp = dqn.replay.sampler
    ss = st.buffer.sampler_state
    _, k_sample = prng.split(prng.key(SEED + 9))
    batch, v_max = dqn.cfg.batch, smp.cfg.v_max
    out = {}
    for mode, sampler in (("fused", smp), ("kernel",
                                             plain_twin(smp, "kernel"))):
        draw = sampler.sample(ss, k_sample, batch)
        want = sampler.priorities(ss)[draw.long()] / v_max
        p_sel = obs.make_replay_probe(sampler, batch)(ss, k_sample)[4]
        if not same_bits(p_sel, want):
            fail("resume_d", f"the {mode} probe's draw != the production "
                 "draw")
        health = obs.ReplayHealth(reg, sampler, batch)
        read, got = counted("resume_d", {"multi_query_match": 1},
                            lambda: health.update(ss, k_sample))
        add_launches(state, got)
        if not np.isfinite(read["kl_nats"]):
            fail("resume_d", f"KL gauge {read['kl_nats']}")
        out[f"health_{mode}"] = {**read, "probe_launches": got}
    return out


def resume_pixel(state: dict, root: str) -> dict:
    """(b) the sharded elastic restore and (c) the pixel kill and resume,
    on Breakout with the 1M uint8 frame store."""
    from repro_torch import prng
    from repro_torch.distributed.sharding import Mesh
    from repro_torch.rl.dqn import make_dqn
    from repro_torch.train.checkpoint import CheckpointManager

    key = prng.key(SEED)
    # (b): 4 shards, preempted at its first save.
    cfg = resume_cfg(env="breakout", sampler="amper-fr-sharded",
                     history_len=4)
    n, interval = RESUME_B
    cuda = torch.device("cuda", 0)

    def sharded(s, a, b):
        k = learn_steps_between(cfg, a, b) * s
        return {"multi_query_match": k, "rank_select": k,
                **sharded_writes(cfg, a, b)}

    dqn4 = make_dqn(cfg, device="cuda", mesh=Mesh([cuda] * SHARDS))
    mgr = CheckpointManager(f"{root}/b", save_interval=interval)
    mgr.request_preemption()
    (st4, _, done), got = counted(
        "resume_b", sharded(SHARDS, 0, interval),
        lambda: dqn4.train_ckpt(key, n, mgr))
    add_launches(state, got)
    if done != interval:
        fail("resume_b", f"preempted run stopped at {done}")
    rb4 = dqn4.replay
    table = rb4.sampler.to_dense(st4.buffer.sampler_state)
    member = rb4.sampler.membership(st4.buffer.sampler_state,
                                    prng.key(42))
    anchors = torch.arange(0, 3 * dqn4.cfg.num_envs * interval,
                           device=rb4.device) % N_ROWS
    batch4 = rb4.materialize(st4.buffer, anchors)
    restore = {}
    for s in (2, 1):
        dqn = make_dqn(cfg, device="cuda", mesh=Mesh([cuda] * s))
        times = []
        for _ in range(2):  # the first restore after the save, and again
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st = dqn.load_ckpt(f"{root}/b", interval)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        restore[f"restore_onto_{s}_ms"] = times
        dense = dqn.replay.sampler.to_dense(st.buffer.sampler_state)
        got_b = dqn.replay.materialize(st.buffer, anchors)
        if not (len(st.buffer.sampler_state.pq) == s
                and same_state(table, dense)
                and torch.equal(member, dqn.replay.sampler.membership(
                    st.buffer.sampler_state, prng.key(42)))
                and all(same_bits(got_b[f], batch4[f]) for f in batch4)):
            fail("resume_b", f"the restore onto {s} shards differs")
        del st, dense
        if s == 2:
            (st2, _, done), got = counted(
                "resume_b", sharded(2, interval, n),
                lambda: dqn.train_ckpt(key, n, CheckpointManager(
                    f"{root}/b", save_interval=interval)))
            add_launches(state, got)
            if done != n or st2.step != n:
                fail("resume_b", f"the 2-shard resume stopped at {done}")
            learn2 = got
            del st2
    b = {"steps": n, "save_interval": interval, "shards_saved": SHARDS,
         "full_save_bytes": os.path.getsize(f"{root}/b/step_{interval:010d}"
                                            ".ckpt"),
         "anchors": int(anchors.numel()), **restore,
         "learn_steps_on_2_shards": learn_steps_between(cfg, interval, n),
         "launches_on_2_shards": learn2,
         "equal_tables_membership_materialize": True}
    del dqn4, st4
    shutil.rmtree(f"{root}/b")
    # (c): one card, fused.
    cfg = resume_cfg(env="breakout", history_len=4)
    n, interval = RESUME_C
    dqn = make_dqn(cfg, device="cuda")

    def draws(a, c):
        return {"amper_sample": learn_steps_between(cfg, a, c)}

    (st_a, _, _), got = counted("resume_c", draws(0, n), lambda: dqn.
                                train_ckpt(key, n, CheckpointManager(
                                    f"{root}/c", save_interval=interval)))
    add_launches(state, got)
    st_b, resume_s, got = kill_and_resume(
        "resume_c", dqn, key, n, interval, f"{root}/c_kill",
        draws(0, interval), draws(interval, n))
    add_launches(state, got)
    if not same_state(st_a, st_b):
        fail("resume_c", "the resumed pixel run != the uninterrupted one")
    del st_b
    shutil.rmtree(f"{root}/c_kill")
    st_a, saves = save_and_delta("resume_c", dqn, st_a, f"{root}/c", n,
                                 RESUME_DELTA_STEPS[1])
    shutil.rmtree(f"{root}/c")
    return {"b": b, "c": {"steps": n, "save_interval": interval,
                          "launches_per_run": draws(0, n),
                          "resume_s": resume_s,
                          "equal_resumed_uninterrupted": True, **saves}}


def phase_resume(state: dict) -> None:
    """Checkpoints and telemetry on the card: (a)-(d) above.  The card's
    float work runs under ``cudnn.deterministic`` (TF32 off), as the
    pixel phase's bit-for-bit check of ``train_many`` against ``train``."""
    root = os.path.join(ROOT, "build", "resume_ckpt")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        t0 = time.perf_counter()
        out = resume_flat(state, root)
        out.update(resume_pixel(state, root))
        out["phase_s"] = time.perf_counter() - t0
        out["filesystem"] = fs_type(root)
    finally:
        torch.backends.cudnn.deterministic = deterministic
        shutil.rmtree(root, ignore_errors=True)
    # (a) and (d) run train_ckpt on the captured step; (b) and (c) are
    # pixel runs, eager
    emit({"phase": "resume", "ok": True, "replay": N_ROWS,
          "captured": {"a": True, "b": False, "c": False, "d": True},
          **out})



RUNTIME_SYNC = 300        # (a) trainer iterations
RUNTIME_ASYNC = 400       # (b) and (f) learner steps
RUNTIME_SHORT = 200       # (c) and (d)
RUNTIME_CKPT = (400, 100, 200)   # (e): target, save interval, preempt at
RUNTIME_PIXEL = 150       # (g)
RUNTIME_PROBE_EVERY = 8   # (f): one slab draw in 8 probed
RUNTIME_RATIO = 1         # the actors' cap, in env steps a learner step:
#                           the sync trainer's one, so (b) and (a) learn
#                           from as many frames a step
# The stages' spans, whose host ms each run reports (each includes its
# waits for the GIL and the card).
RUNTIME_SPANS = ("learn", "rollout", "slab_draw", "add_block",
                 "apply_feedback")
# The reference's RunResult.metrics keys of an async run
# (repro/runtime/service.py), the optional "health" aside.
RUNTIME_KEYS = {"mode", "learner_steps", "total_learner_steps",
                "learner_steps_per_sec", "wall_time", "frames",
                "total_frames", "frames_per_sec", "blocks", "return_mean",
                "recent_returns", "beta", "feedback_seqs", "staleness",
                "queue_depth", "losses", "resumed_from", "preempted_at",
                "snapshot", "checkpoint"}


def runtime_service(cfg, num_actors: int = 2, mesh=None,
                    ratio: int = RUNTIME_RATIO, **kw):
    """The phase's async service: chunk 32, slab 4, prefetch depth 2, the
    actors capped at ``ratio`` env steps a learner step."""
    from repro_torch.runtime import ReplayService

    return ReplayService(cfg, num_actors=num_actors, chunk_len=32, slab=4,
                         prefetch_depth=2, feedback_log=True, device="cuda",
                         mesh=mesh, max_replay_ratio=ratio * cfg.num_envs,
                         **kw)


def checked_draws(svc) -> dict:
    """Wrap ``svc._sample`` to count the slab draws and hold each against
    the plain draw: while the prefetcher still holds the replay-state
    lock, the same sampler with the broadcast match (no kernel) draws on
    the same state and key, and must give the same rows in the slab's
    flat order.  A mismatch raises in the prefetch thread, which fails
    the run.  Keeps the last draw's key and row priorities for the
    probe's check."""
    sampler = svc.dqn.replay.sampler
    plain = plain_twin(sampler)
    rows = svc.cfg.batch * svc.slab
    sample = svc._sample
    seen = {"draws": 0}

    def checked(st, key, beta):
        out = sample(st, key, beta)
        flat = out[0].transpose(0, 1).reshape(-1)
        want = plain.sample(st.sampler_state, key, rows)
        if not torch.equal(flat, want):
            raise AssertionError(
                f"slab draw {seen['draws']}: kernel rows != plain rows "
                f"({int((flat != want).sum())} of {rows} differ)")
        seen["draws"] += 1
        seen["key"] = key
        seen["prio"] = sampler.priorities(st.sampler_state)[flat.long()]
        return out

    svc._sample = checked
    return seen


def runtime_run(phase: str, svc, key, n: int, per_draw: dict,
                manager=None, seen: dict | None = None):
    """``svc.run`` with the kernels' counts zeroed just before and read
    just after.  The phase fails if a stage failed (``run`` re-raises
    it), unless the feedback is gapless and in order, the reference's
    metric keys are there and the params finite, and unless each kernel
    launched ``per_draw`` times a slab draw (and the match once more a
    health probe).  ``seen``: the counters of a ``checked_draws`` wrap
    already in place.  The run records into a registry of its own, whose
    span means (``RUNTIME_SPANS``) join the counters.  Returns (result,
    draw counters, launches).  A sharded sampler's updates launch
    ``write_last`` once each: once a block added and once a feedback
    applied, as the run's ``add_block`` and ``apply_feedback`` spans
    count them."""
    from repro_torch import obs
    from repro_torch.kernels import ops
    from repro_torch.models.qhead import tree_leaves

    if seen is None:
        seen = checked_draws(svc)
    reg = obs.Registry()
    svc.telemetry = (svc.telemetry or obs.Telemetry(probe_every=0)
                     )._replace(registry=reg)
    ops.reset_launches()
    try:
        res = svc.run(key, n, manager=manager)
    except Exception as e:  # a stage's error, re-raised by run()
        fail(phase, f"{type(e).__name__}: {e} (from {e.__cause__!r})")
    torch.cuda.synchronize()
    got = dict(ops.launches)
    m = res.metrics
    probes = int(m.get("health", {}).get("probe_draws", 0))
    want = {k: per_draw.get(k, 0) * seen["draws"] for k in got}
    want["multi_query_match"] += probes
    snap = reg.snapshot()
    seen["host_ms"] = {}
    for span in RUNTIME_SPANS:
        st = obs.hist_stats(snap.data[f"span_{span}_ms"],
                            snap.meta[f"span_{span}_ms"]["bounds"])
        seen["host_ms"][span] = {"count": st["count"], "mean": st["mean"],
                                 "p95": st["p95"]}
    if svc.dqn.cfg.sampler.endswith("-sharded"):
        want["write_last"] = (seen["host_ms"]["add_block"]["count"]
                              + seen["host_ms"]["apply_feedback"]["count"])
    if got != want:
        fail(phase, f"launches {got} for {seen['draws']} slab draws and "
             f"{probes} probes, want {want}")
    start = m["resumed_from"] or 0
    if m["feedback_seqs"] != list(range(start, start + m["learner_steps"])):
        fail(phase, "priority feedback not gapless and in order")
    if not set(m) >= RUNTIME_KEYS:
        fail(phase, f"metric keys missing: {sorted(RUNTIME_KEYS - set(m))}")
    if not all(bool(torch.isfinite(t).all()) for t in tree_leaves(res.params)):
        fail(phase, "non-finite params")
    return res, seen, got


def runtime_summary(res, seen: dict, got: dict) -> dict:
    m = res.metrics
    return {"learner_steps": m["learner_steps"],
            "learner_steps_per_s": m["learner_steps_per_sec"],
            "frames": m["frames"], "frames_per_s": m["frames_per_sec"],
            "wall_s": m["wall_time"], "staleness": m["staleness"],
            "queue_depth": m["queue_depth"], "slab_draws": seen["draws"],
            "draws_held_against_plain": seen["draws"], "launches": got,
            "host_ms": seen["host_ms"],
            "replay_rows": int(res.buffer.size),
            "return_mean": m["return_mean"]}


def runtime_sync(state: dict) -> dict:
    """(a) sync mode, fused: the final agent state equals ``train``'s
    (params, target, Adam moments, ring and sampler state) bit for bit."""
    from repro_torch import prng
    from repro_torch.runtime import ReplayService

    cfg = resume_cfg()
    svc = ReplayService(cfg, sync=True, num_actors=1, device="cuda")
    step, last = svc._agent_step, {}

    def keeping(st, k):
        st, mt = step(st, k)
        last["state"] = st
        return st, mt

    svc._agent_step = keeping
    key = prng.key(SEED)
    want = {"amper_sample": learn_steps_between(cfg, 0, RUNTIME_SYNC)}
    res, got = counted("runtime_a", want, lambda: svc.run(key, RUNTIME_SYNC))
    add_launches(state, got)
    # train captures its steady step: the replays count their launches
    (st_t, _), got_t = counted("runtime_a", want,
                               lambda: svc.dqn.train(key, RUNTIME_SYNC))
    add_launches(state, got_t)
    if not same_agent_state(last["state"], st_t):
        fail("runtime_a", "the sync service's state != train's")
    m = res.metrics
    return {"steps": RUNTIME_SYNC, "learner_steps": m["learner_steps"],
            "learner_steps_per_s": m["learner_steps_per_sec"],
            "frames_per_s": m["frames_per_sec"], "launches": got,
            "equal_train": True}


def runtime_ckpt(state: dict, root: str) -> dict:
    """(e) async with a ``CheckpointManager``: a save every 100 learner
    steps, preemption asked for as the first save at or after step 200
    returns, and a fresh service resuming to 400 with gapless feedback."""
    from repro_torch import prng
    from repro_torch.train.checkpoint import CheckpointManager

    n, interval, kill_at = RUNTIME_CKPT

    class Preempting(CheckpointManager):
        def save(self, step, *args, **kwargs):
            out = super().save(step, *args, **kwargs)
            if step >= kill_at:
                self.request_preemption()
            return out

    cfg = resume_cfg()
    key = prng.key(SEED + 5)
    draw = {"amper_sample": 1}
    mgr = Preempting(root, save_interval=interval)
    r1, s1, got1 = runtime_run("runtime_e", runtime_service(cfg), key, n,
                               draw, manager=mgr)
    add_launches(state, got1)
    m1 = r1.metrics
    cut = m1["preempted_at"]
    if cut is None or not kill_at <= cut < n:
        fail("runtime_e", f"preempted at {cut}, not in [{kill_at}, {n})")
    if m1["snapshot"]["saved"] < 2 or m1["snapshot"]["drain_cycles"] != 0:
        fail("runtime_e", f"snapshots {m1['snapshot']}")
    r2, s2, got2 = runtime_run(
        "runtime_e", runtime_service(cfg), key, n, draw,
        manager=CheckpointManager(root, save_interval=interval))
    add_launches(state, got2)
    m2 = r2.metrics
    if m2["resumed_from"] != cut or m2["total_learner_steps"] != n:
        fail("runtime_e", f"resumed from {m2['resumed_from']} to "
             f"{m2['total_learner_steps']}, want {cut} to {n}")
    if m1["feedback_seqs"] + m2["feedback_seqs"] != list(range(n)):
        fail("runtime_e", "feedback across the two runs not gapless")
    return {"target": n, "save_interval": interval, "preempted_at": cut,
            "snapshot": m1["snapshot"], "checkpoint": m1["checkpoint"],
            "resumed_snapshot": m2["snapshot"],
            "resumed_checkpoint": m2["checkpoint"],
            "first": runtime_summary(r1, s1, got1),
            "resumed": runtime_summary(r2, s2, got2)}


def runtime_probe(state: dict) -> dict:
    """(f) (b) with telemetry on: every probe re-derives the production
    slab draw it follows (the same key, the same row priorities), and
    the health gauges are finite."""
    from repro_torch import obs, prng
    from repro_torch.obs import probes

    svc = runtime_service(resume_cfg(), telemetry=obs.Telemetry(
        probe_every=RUNTIME_PROBE_EVERY))
    seen = checked_draws(svc)   # keeps each draw's key and priorities
    make_probe = probes.make_replay_probe
    checked = []

    def checking(sampler, batch):
        probe = make_probe(sampler, batch)

        def run(st, key):
            out = probe(st, key)
            if not (torch.equal(key, seen["key"]) and torch.equal(
                    out[4], seen["prio"] / sampler.cfg.v_max)):
                raise AssertionError("the probe's draw != the production "
                                     "draw it follows")
            checked.append(True)
            return out

        return run

    probes.make_replay_probe = checking
    try:
        res, s, got = runtime_run("runtime_f", svc, prng.key(SEED + 6),
                                  RUNTIME_ASYNC, {"amper_sample": 1},
                                  seen=seen)
    finally:
        probes.make_replay_probe = make_probe
    add_launches(state, got)
    health = res.metrics["health"]
    if not (checked and len(checked) == health["probe_draws"]
            and all(np.isfinite(v) for v in health.values())):
        fail("runtime_f", f"{len(checked)} probes checked, health {health}")
    return {**runtime_summary(res, s, got), "probes_equal_draw":
            len(checked), "health": health}


def runtime_pixel(state: dict) -> dict:
    """(g) Breakout on the uint8 frame store: one actor, fused; two
    actors are refused."""
    from repro_torch import prng

    cfg = resume_cfg(env="breakout", history_len=4)
    try:
        runtime_service(cfg, num_actors=2)
    except ValueError as e:
        refused = str(e)
    else:
        fail("runtime_g", "a frame store accepted two actors")
    svc = runtime_service(cfg, num_actors=1)
    res, s, got = runtime_run("runtime_g", svc, prng.key(SEED + 7),
                              RUNTIME_PIXEL, {"amper_sample": 1})
    add_launches(state, got)
    if res.buffer.storage["frame"].dtype != torch.uint8:
        fail("runtime_g", "the frame store is not uint8")
    return {**runtime_summary(res, s, got), "two_actors_refused": refused}


SPLIT_STEPS = 200   # learner steps a service setting of runtime_split


def split_wall_ms(fn, calls: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e3


def split_alone() -> dict:
    """Each stage's work alone on the main thread and the default stream,
    synchronized (host wall ms a call, mean), on a buffer filled by 150
    ``train`` steps: one ``act`` step, one rollout chunk, one slab of 4
    ``learn`` steps, one slab draw of 256 rows, one ``add_block`` of a
    chunk and one feedback apply."""
    from repro_torch import prng
    from repro_torch.rl.dqn import make_dqn
    from repro_torch.runtime.actor import make_rollout
    from repro_torch.runtime.learner import make_slab_learner
    from repro_torch.runtime.pipeline import make_slab_sampler

    cfg = resume_cfg()
    dqn = make_dqn(cfg, device="cuda")
    st, _ = dqn.train(prng.key(SEED), 150)
    rb = dqn.replay
    sample = make_slab_sampler(rb, cfg.batch, 4)
    key = prng.key(7)
    idx, batch, w, stamp = sample(st.buffer, key, 0.4)
    learn = make_slab_learner(dqn)
    roll = make_rollout(dqn, 32)
    ep = torch.zeros(cfg.num_envs, device="cuda")
    block = roll(st.params, st.env_state, st.obs, 0, ep, None, key)[4]
    td = torch.rand(idx.shape, device="cuda")
    buf = {"state": st.buffer}

    def add():
        buf["state"] = rb.add_block(buf["state"], block, aggregated=True)

    def apply():
        buf["state"] = rb.update_priorities(
            buf["state"], idx.reshape(-1), td.reshape(-1),
            stamp=stamp.reshape(-1, 2))

    return {"act_ms": split_wall_ms(lambda: dqn.act(
                st.params, st.env_state, st.obs, 0, key), 64),
            "rollout_chunk_ms": split_wall_ms(lambda: roll(
                st.params, st.env_state, st.obs, 0, ep, None, key), 3),
            "learn_slab_ms": split_wall_ms(lambda: learn(
                st.params, st.target_params, st.opt_m, st.opt_v, 0, batch,
                w), 10),
            "slab_draw_ms": split_wall_ms(
                lambda: sample(st.buffer, key, 0.4), 20),
            "add_block_ms": split_wall_ms(add, 10),
            "apply_feedback_ms": split_wall_ms(apply, 10)}


def split_service(actors: int, ratio: int, threads: int | None,
                  switch: float | None, profile: bool) -> dict:
    """The async service for ``SPLIT_STEPS`` learner steps (no plain
    check): learner steps/s and the stages' span means, with PyTorch's
    intra-op threads at ``threads`` and the interpreter's switch interval
    at ``switch`` when given (restored after); with ``profile`` also the
    card's busy share (every kernel's and copy's device time over the
    run's wall time, torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from repro_torch import obs, prng

    reg = obs.Registry()
    svc = runtime_service(resume_cfg(), num_actors=actors, ratio=ratio,
                          telemetry=obs.Telemetry(registry=reg,
                                                  probe_every=0))
    old, old_switch = torch.get_num_threads(), sys.getswitchinterval()
    if threads is not None:
        torch.set_num_threads(threads)
    if switch is not None:
        sys.setswitchinterval(switch)
    try:
        if profile:
            with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                res = svc.run(prng.key(SEED + 1), SPLIT_STEPS)
                wall = time.perf_counter() - t0
            busy_us = sum(e.self_device_time_total
                          for e in prof.key_averages()
                          if e.device_type == DeviceType.CUDA)
        else:
            res = svc.run(prng.key(SEED + 1), SPLIT_STEPS)
    finally:
        torch.set_num_threads(old)
        sys.setswitchinterval(old_switch)
    snap = reg.snapshot()
    spans = {}
    for name in RUNTIME_SPANS:
        st = obs.hist_stats(snap.data[f"span_{name}_ms"],
                            snap.meta[f"span_{name}_ms"]["bounds"])
        spans[name] = {"count": st["count"], "mean_ms": st["mean"]}
    m = res.metrics
    out = {"actors": actors, "env_steps_per_learner_step": ratio,
           "intra_op_threads": threads or old,
           "switch_interval_s": switch or old_switch,
           "learner_steps_per_s": m["learner_steps_per_sec"],
           "frames_per_s": m["frames_per_sec"],
           "queue_depth": m["queue_depth"], "host_ms": spans}
    if profile:
        out["device_busy_share"] = busy_us / 1e6 / wall
    return out


def phase_runtime_split(state: dict) -> None:
    """Where the runtime's time goes: each stage alone (``split_alone``),
    then the service in five settings, in turns, the actors capped at
    the phase's one env step a learner step unless said: one actor; two
    actors (with the card's busy share); two capped at 4 env steps (the
    cap of ``examples/torch_async_dqn.py``); two with one intra-op CPU
    thread; two with the switch interval at 0.2 ms (1/25 of the
    interpreter's 5 ms)."""
    out = {"alone": split_alone(), "service": [
        split_service(actors, ratio, threads, switch, profile)
        for actors, ratio, threads, switch, profile in (
            (1, RUNTIME_RATIO, None, None, False),
            (2, RUNTIME_RATIO, None, None, True),
            (2, 4, None, None, False),
            (2, RUNTIME_RATIO, 1, None, False),
            (2, RUNTIME_RATIO, None, 2e-4, False))]}
    emit({"phase": "runtime_split", "ok": True, "steps": SPLIT_STEPS,
          "nvidia_smi": state["smi"], **out})


def phase_runtime(state: dict) -> None:
    """The async replay runtime on the card, (a)-(g): CartPole, 16 envs
    an actor, batch 64, hidden 128, a 1M-row replay, AMPER-fr (m 20,
    lambda' 2.0, CSP ratio 0.15, v_max 8), chunk 32, slab 4, prefetch
    depth 2, learn_start 100.  Every slab draw of (b)-(g) is held
    against the plain draw while the lock is held, launch counts are
    exact, and each run reports its stages' host ms from its spans.
    ``runtime_split`` splits the time further."""
    from repro_torch import prng
    from repro_torch.distributed.sharding import Mesh

    root = os.path.join(ROOT, "build", "runtime_ckpt")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    out = {"a": runtime_sync(state)}
    for name, n, cfg, per_draw, mesh in (
            ("b", RUNTIME_ASYNC, resume_cfg(), {"amper_sample": 1}, None),
            ("c", RUNTIME_SHORT, resume_cfg(amper_fr_mode="kernel"),
             {"multi_query_match": 1}, None),
            ("d", RUNTIME_SHORT, resume_cfg(sampler="amper-fr-sharded"),
             {"multi_query_match": SHARDS, "rank_select": SHARDS},
             Mesh([torch.device("cuda", 0)] * SHARDS))):
        res, seen, got = runtime_run(
            f"runtime_{name}", runtime_service(cfg, mesh=mesh),
            prng.key(SEED + len(out)), n, per_draw)
        add_launches(state, got)
        out[name] = runtime_summary(res, seen, got)
    try:
        out["e"] = runtime_ckpt(state, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["f"] = runtime_probe(state)
    out["g"] = runtime_pixel(state)
    sync_rate = out["a"]["learner_steps_per_s"]
    emit({"phase": "runtime", "ok": True, "captured": False,
          "replay": N_ROWS,
          "actors": 2, "chunk": 32, "slab": 4, "prefetch_depth": 2,
          "max_replay_ratio": RUNTIME_RATIO * 16,
          "async_over_sync": out["b"]["learner_steps_per_s"] / sync_rate,
          "phase_s": time.perf_counter() - t0, "nvidia_smi": state["smi"],
          **out})

# Decode vs prefill in float32, relative to max |logit|.  Both paths are
# float32 throughout (TF32 off) and differ only in the order of their sums
# (GEMM vs GEMV, the flash vs the decode kernel).  Sound runs on the H100
# read 8.4e-7; 1e-5 is about 12x that, and tight enough that one key of a
# few hundred masked wrongly, or one stale cache row far from the live end,
# fails the check, while a wrong position or mask moves logits by
# O(max |logit|).
SERVE_F32_TOL = 1e-5


def decode_vs_prefill(engine, prompts, steps: int) -> dict:
    """Greedy-decode ``steps`` tokens after a prefill of ``prompts``, and
    hold the logits of each decode step against the last-position logits
    of a prefill of the same sequence (``tests/test_serving.py``'s
    check).  Returns the largest difference relative to max |logit|."""
    B, P = prompts.shape
    max_len = P + steps + 1
    logits, cache = engine.prefill({"tokens": prompts}, max_len)
    seq = prompts
    worst = 0.0
    for _ in range(steps):
        tok = torch.argmax(logits, dim=-1).reshape(B, 1).to(torch.int32)
        seq = torch.cat([seq, tok], dim=1)
        step_logits, cache = engine.decode(tok, cache)
        logits = step_logits[:, -1]
        want, _ = engine.prefill({"tokens": seq}, max_len)
        scale = float(want.abs().max())
        worst = max(worst, float((logits - want).abs().max()) / scale)
    return {"prompt": P, "steps": steps, "max_rel_err": worst,
            "max_abs_logit": scale, "tol": SERVE_F32_TOL}


def generate_launches(cfg, gen: int) -> dict:
    """The flash and decode launches of one greedy generate of ``gen``
    tokens: a decoder's prefill launches flash once a layer (none for
    rwkv, which has no attention) and each of the ``gen - 1`` decode
    steps the decode kernel once a layer; whisper's prefill launches
    flash once an encoder layer and decodes its first token, so each of
    its ``gen`` decode steps launches the decode kernel twice a decoder
    layer (self and cross)."""
    if cfg.family == "audio":
        return {"flash_attention": cfg.n_enc_layers,
                "decode_attention": 2 * cfg.n_layers * gen}
    per = 0 if cfg.block_kind == "rwkv" else cfg.n_layers
    return {"flash_attention": per, "decode_attention": per * (gen - 1)}


def serve_arch(state: dict, phase: str, arch: str, batch: int,
               prompt: int, gen: int):
    """``arch`` at full width and depth through ``Model`` + ``Engine``,
    seeded weights and the serve CLI's inputs (prompts, whisper's frames,
    paligemma's patch embeddings): init timed, one greedy generate (the
    main path: flash and decode launches exact, added to the run's
    counts), then prefill and decode timed alone (after the generate
    warmed them up), with the kernels' launches a decode token.  Returns
    (report, cfg, params, inputs, engine)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import cli_inputs
    from repro_torch.models.model_api import Model
    from repro_torch.serving import Engine

    cfg = get_config(arch)
    model = Model.from_config(cfg)
    gc.collect()  # the last phase's tensors, before 65 GB of params
    torch.cuda.empty_cache()
    before_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = model.init_params(
        torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    params_gb = torch.cuda.memory_allocated() / 1e9 - before_gb
    inputs = cli_inputs(cfg, SEED, batch, prompt, "cuda")
    engine = Engine(model, params)
    max_len = engine.cache_len(prompt, gen)

    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = engine.generate(inputs, gen)
    torch.cuda.synchronize()
    generate_s = time.perf_counter() - t0
    got = {k: ops.launches[k] for k in ("flash_attention",
                                        "decode_attention")}
    want = generate_launches(cfg, gen)
    if got != want:
        fail(phase, f"{arch}: one generate launched {got}, not {want}")
    for k, n in got.items():
        state["launches"][k] = state["launches"].get(k, 0) + n
    if tuple(res.tokens.shape) != (batch, gen) or not bool(
            ((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all()) \
            or not bool(torch.isfinite(res.logits_last).all()):
        fail(phase, f"{arch}: tokens {tuple(res.tokens.shape)} out of "
             "the vocabulary or non-finite logits")

    prefill_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = engine.prefill(inputs, max_len)
        torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t0)
    tok = Engine._choose(logits.reshape(batch, -1), 0.0, None, 0)
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(gen - 1):
        lg, cache = engine.decode(tok, cache)
        tok = Engine._choose(lg[:, -1], 0.0, None, 0)
    torch.cuda.synchronize()
    decode_s = (time.perf_counter() - t0) / (gen - 1)
    per_token = {k: ops.launches[k] / (gen - 1)
                 for k in ("flash_attention", "decode_attention")}
    if not bool(torch.isfinite(lg).all()):
        fail(phase, f"{arch}: non-finite decode logits")
    report = {
        "arch": arch, "layers": cfg.n_layers, "d_model": cfg.d_model,
        "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.head_dim],
        "params": lm_param_count(cfg), "params_gb": params_gb,
        "allocated_before_gb": before_gb,
        "batch": batch, "prompt": prompt, "gen": gen, "init_s": init_s,
        "generate_s": generate_s, "launches": got,
        "kernel_launches_a_decode_token": per_token,
        "prefill_ms": float(np.median(prefill_s)) * 1e3,
        "prefill_ms_all": [x * 1e3 for x in prefill_s],
        "decode_ms_per_token": decode_s * 1e3,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    del res, cache, logits, lg
    return report, cfg, params, inputs, engine


def phase_serve(state: dict, trace_dir: str | None) -> None:
    """stablelm-1.6b at full width through ``Model`` + ``Engine``: one
    greedy generate (the main path, launch counts checked exactly), then
    prefill and decode timed alone (``serve_arch``), then decode held
    against prefill in float32."""
    import dataclasses

    from repro_torch.models.model_api import Model
    from repro_torch.serving import Engine

    report, cfg, params, inputs, engine = serve_arch(
        state, "serve", ARCH, SERVE_BATCH, SERVE_PROMPT, SERVE_GEN)
    prompts = inputs["tokens"]
    max_len = SERVE_PROMPT + SERVE_GEN + 1
    profile = None
    if trace_dir is not None:
        logits, cache = engine.prefill({"tokens": prompts}, max_len)
        box = [Engine._choose(logits, 0.0, None, 0), cache]

        def step():
            lg, box[1] = engine.decode(box[0], box[1])
            box[0] = Engine._choose(lg[:, -1], 0.0, None, 0)

        profile = profile_steps(step, 8, trace_dir, "serve_decode",
                                ("serve_decode", "serve_prefill"))
        del profile["kernel_sequence"]
        profile["decode_attention_launches_per_token"] = cfg.n_layers
        del box, logits, cache

    # Decode against prefill, in float32 at full width on a shorter prompt.
    engine32 = Engine(Model.from_config(dataclasses.replace(
        cfg, dtype="float32")), params)
    check = decode_vs_prefill(engine32, prompts[:, :256], 8)
    if not check["max_rel_err"] <= SERVE_F32_TOL:
        fail("serve", f"float32 decode != prefill: {check}")
    emit({"phase": "serve", "ok": True, **report, "max_len": max_len,
          "tokens_per_s": SERVE_BATCH / report["decode_ms_per_token"] * 1e3,
          "prefill_tokens_per_s": SERVE_BATCH * SERVE_PROMPT
          / report["prefill_ms"] * 1e3,
          "decode_vs_prefill_f32": check, "profile": profile})


# The LM trainer (``python -m repro_torch.launch.train``) at full width:
# stablelm-1.6b, batch 8 x 128 tokens, AMPER-fr sequence replay over
# 2,048 sequences; steady steps are 5-29.
LM_STEPS, LM_STEADY = 30, 5
LM_DEVICE = "cuda"
LM_ARGS = ["--arch", ARCH, "--batch", "8", "--seq-len", "128",
           "--n-seqs", "2048", "--sampler", "amper-fr", "--log-every", "10",
           "--device", LM_DEVICE]
# the reference's kill-and-resume test (tests/test_checkpoint.py)
LM_RESUME_ARGS = ["--arch", ARCH, "--reduced", "--batch", "4", "--seq-len",
                  "32", "--n-seqs", "64", "--sampler", "amper-fr",
                  "--log-every", "100", "--ckpt-every", "100",
                  "--device", LM_DEVICE]
LM_STAGES = ("sample", "train_step", "per_seq_loss", "update")
# per-sequence losses through the flash kernel against attention_ref, bf16,
# as max |difference| over max |loss|: the attention outputs differ by
# bf16 roundings (ATTN_TOL), which 24 layers carry into the logits
LM_SEQ_TOL = 1e-2
# the main run's first step against a step computed again from the same
# seed and batch through chunked_attention and autograd alone: the same
# computation, deterministic, so the loss and grad norm agree to rounding
LM_STEP_TOL = 1e-6


def lm_param_count(cfg) -> int:
    from repro_torch.models import common
    from repro_torch.models.model_api import Model

    n = []
    common.map_specs(lambda sp: n.append(int(np.prod(sp.shape))),
                     Model.from_config(cfg).param_specs())
    return sum(n)


def lm_flash_at_train_shape(cfg, batch: int, seq: int) -> dict:
    """The flash kernel at the per-sequence loss's shape, held against
    attention_ref and timed beside it and SDPA."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import attention_ref

    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = attention_inputs([(batch, H, seq, D), (batch, Hkv, seq, D),
                                (batch, Hkv, seq, D)], torch.bfloat16, 7)
    err = check_close("lm_train", "flash at the training shape",
                      ops.flash_attention(q, k, v, causal=True),
                      attention_ref(q, k, v, causal=True),
                      ATTN_TOL[torch.bfloat16])
    ms = device_time_ms(lambda: ops.flash_attention(q, k, v, causal=True))
    plain_ms = device_time_ms(lambda: attention_ref(q, k, v, causal=True),
                              calls=10, reps=3)
    library_ms = device_time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True))
    flops = 2 * 2 * seq * seq * D * batch * H / 2
    bound_ms, bound_by = attention_bound(nbytes(q, k, v, q), flops)
    return {"shape": [batch, H, Hkv, seq, D], "dtype": "bfloat16",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


@contextlib.contextmanager
def plain_route():
    """``ops.flash_attention`` swapped for its plain version
    (``attention_ref``, the same arguments) while the block runs: a
    forward through the plain route."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import attention_ref

    real = ops.flash_attention
    ops.flash_attention = lambda q, k, v, **kw: attention_ref(q, k, v, **kw)
    try:
        yield
    finally:
        ops.flash_attention = real


def lm_checks(first: dict) -> dict:
    """(b): the first step against a chunked-only step from the same
    seed and batch, the per-sequence losses through the flash kernel
    against attention_ref, and the deterministic mode's cost in step
    time (the steps alternate with it on and off)."""
    from repro_torch import prng
    from repro_torch.launch import train as launch_train
    from repro_torch.models.qhead import tree_leaves
    from repro_torch.train.optimizer import global_norm
    from repro_torch.train.train_step import _unflatten_like

    dev = torch.device(LM_DEVICE)
    args = launch_train.parse_args(LM_ARGS + ["--steps", str(LM_STEPS)])
    cfg, model, step_fn, data, st, dst = launch_train.build(args, dev)
    _, batch = data.sample(dst, prng.fold_in(prng.key(args.seed), 0))
    with launch_train.deterministic(dev), torch.enable_grad():
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(st.params)]
        loss, _ = model.loss(_unflatten_like(st.params, leaves), batch)
        gnorm = global_norm(torch.autograd.grad(loss, leaves))
    del leaves
    loss, gnorm = float(loss.detach()), float(gnorm)
    step_err = {k: abs(x - first[k]) / abs(x)
                for k, x in (("loss", loss), ("grad_norm", gnorm))}
    if not max(step_err.values()) <= LM_STEP_TOL:
        fail("lm_train", f"first step != chunked-only step: {step_err}")

    flash_loss = launch_train.per_sequence_loss(model, st.params, batch)
    with plain_route():
        plain_loss = launch_train.per_sequence_loss(model, st.params, batch)
    seq_err = float((flash_loss - plain_loss).abs().max()
                    / plain_loss.abs().max())
    if not (bool(torch.isfinite(flash_loss).all())
            and seq_err <= LM_SEQ_TOL):
        fail("lm_train", f"per-sequence losses: flash vs attention_ref "
             f"{seq_err} > {LM_SEQ_TOL}")

    times = {"on": [], "off": []}
    import contextlib
    for i in range(10):
        mode = "on" if i % 2 else "off"
        ctx = (launch_train.deterministic(dev) if mode == "on"
               else contextlib.nullcontext())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with ctx:
            st, _ = step_fn(st, batch)
        torch.cuda.synchronize()
        if i >= 2:
            times[mode].append((time.perf_counter() - t0) * 1e3)
    del st, dst
    return {"first_step_vs_chunked_only": {
                "loss": loss, "grad_norm": gnorm,
                "rel_err": step_err, "tol": LM_STEP_TOL},
            "seq_loss_flash_vs_plain": {
                "max_rel_err": seq_err, "tol": LM_SEQ_TOL,
                "flash": flash_loss.tolist(), "plain": plain_loss.tolist()},
            "train_step_ms_deterministic": {
                k: float(np.median(v)) for k, v in times.items()},
            "train_step_ms_deterministic_all": times}


def lm_kill_and_resume(root: str) -> dict:
    """(c): 6 steps uninterrupted against 3, stop, resume to 6, reduced,
    on the card; the final checkpoints' arrays bit for bit."""
    import contextlib
    import io

    from repro_torch.launch import train as launch_train

    a, b = os.path.join(root, "a"), os.path.join(root, "b")
    shutil.rmtree(root, ignore_errors=True)
    out = io.StringIO()
    sigterm = signal.getsignal(signal.SIGTERM)  # the launcher hooks it
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        for d, n in ((a, 6), (b, 3), (b, 6)):
            if launch_train.main(LM_RESUME_ARGS + [
                    "--steps", str(n), "--ckpt-dir", d]) != 0:
                fail("lm_train", "the reduced launcher failed")
    wall_s = time.perf_counter() - t0
    signal.signal(signal.SIGTERM, sigterm)
    if "resumed from step 3" not in out.getvalue():
        fail("lm_train", "the second reduced run did not resume at step 3")
    x = np.load(os.path.join(a, "step_0000000006.ckpt"))
    y = np.load(os.path.join(b, "step_0000000006.ckpt"))
    diff = sorted(f for f in set(x.files) | set(y.files)
                  if f not in x.files or f not in y.files
                  or not np.array_equal(x[f], y[f]))
    n_arrays = len(x.files)
    shutil.rmtree(root, ignore_errors=True)
    if diff:
        fail("lm_train", f"resumed checkpoint differs in {diff[:5]}")
    return {"arrays": n_arrays, "bitwise_equal": True, "wall_s": wall_s}


# (d): the other dense configs at full width, depth cut to fit one card
# with AdamW (full depth: 544 GB and 224 GB)
LM_OTHER, LM_OTHER_LAYERS, LM_OTHER_STEPS, LM_OTHER_GEN = (
    ("granite-34b", "phi3-medium-14b"), 2, 3, 16)


def cut_depth_run(phase: str, arch: str, layers: int, steps: int,
                  gen: int) -> dict:
    """``arch`` at full width and ``layers`` layers: ``steps`` train steps
    through the sequence replay, the train step and the per-sequence loss
    (batch 8 x 128), then, with ``gen``, a greedy generate; the flash and
    decode launches exact, losses and logits finite."""
    import dataclasses

    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    from repro_torch.models.model_api import Model
    from repro_torch.serving import Engine
    from repro_torch.train import data as data_mod
    from repro_torch.train import train_step as ts_mod
    from repro_torch.train.optimizer import AdamW, cosine_schedule

    dev = torch.device(LM_DEVICE)
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    model = Model.from_config(cfg)
    opt = AdamW(cosine_schedule(3e-4, 20, 30))
    step_fn = ts_mod.make_train_step(model, opt)
    data = data_mod.PrioritizedSeqData(
        data_mod.corpus_tokens(256, 129, cfg.vocab_size, SEED), 8,
        device=dev)
    ds = data.init()
    torch.cuda.reset_peak_memory_stats()
    st = ts_mod.init_train_state(
        model, opt, torch.Generator(device=dev).manual_seed(SEED), dev)
    ops.reset_launches()
    losses, step_ms, aux = [], [], []
    for step in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        idx, batch = data.sample(ds, prng.fold_in(prng.key(SEED), step))
        with launch_train.deterministic(dev):
            st, met = step_fn(st, batch)
            seq_loss = launch_train.per_sequence_loss(model, st.params,
                                                      batch)
        ds = data.update(ds, idx, seq_loss)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(met["loss"]))
        aux.append({k: float(v) for k, v in met.items()
                    if k.startswith("moe_")})
    flash = ops.launches["flash_attention"]
    want = 0 if cfg.block_kind == "rwkv" else steps * cfg.n_layers
    if flash != want or not np.all(np.isfinite(losses)):
        fail(phase, f"{arch}: {flash} flash launches in {steps} steps, "
             f"losses {losses}")
    if cfg.n_experts and not all(len(a) == 3 and np.all(np.isfinite(
            list(a.values()))) for a in aux):
        fail(phase, f"{arch}: MoE metrics missing or non-finite: {aux}")
    out = {"layers": cfg.n_layers, "d_model": cfg.d_model,
           "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.head_dim],
           "losses": losses, "step_ms": step_ms,
           "train_launches": {"flash_attention": flash},
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    if cfg.n_experts:
        out["moe_metrics_first_last"] = [aux[0], aux[-1]]
    if gen:
        engine = Engine(model, st.params)
        ops.reset_launches()
        res = engine.generate({"tokens": batch["tokens"][:4, :64]
                               .contiguous()}, gen)
        got = {k: ops.launches[k]
               for k in ("flash_attention", "decode_attention")}
        if got != generate_launches(cfg, gen) or not bool(
                torch.isfinite(res.logits_last).all()):
            fail(phase, f"{arch}: generate launched {got}")
        out["generate_launches"] = got
        del engine, res
    del st, ds, data
    torch.cuda.empty_cache()
    return out


def lm_other_configs() -> dict:
    """(d): granite-34b (MQA, head dim 128, untied head) and
    phi3-medium-14b (GQA 40 / 10) at full width and 2 layers: a few train
    steps through the sequence replay, the train step and the
    per-sequence loss, then a greedy generate; the flash and decode
    launches exact, losses and logits finite."""
    return {arch: cut_depth_run("lm_train", arch, LM_OTHER_LAYERS,
                                LM_OTHER_STEPS, LM_OTHER_GEN)
            for arch in LM_OTHER}


def phase_lm_train(state: dict) -> None:
    """The LM trainer's main path at full width (a), held against its
    plain versions (b), killed and resumed at the reduced size (c), and
    the other dense configs at full width and cut depth (d)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train

    cfg = get_config(ARCH)
    n_params = lm_param_count(cfg)
    flash_train = lm_flash_at_train_shape(cfg, 8, 128)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # (a) the main path, through the launcher's entry point
    records, flash_after = [], []

    def on_step(rec):
        records.append(rec)
        flash_after.append(ops.launches["flash_attention"])

    ops.reset_launches()
    if launch_train.main(LM_ARGS + ["--steps", str(LM_STEPS)],
                         on_step=on_step) != 0:
        fail("lm_train", "the launcher returned non-zero")
    launches = dict(ops.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    per_step = np.diff([0] + flash_after).tolist()
    if per_step != [cfg.n_layers] * LM_STEPS:
        fail("lm_train", f"flash launches a step {per_step}, not "
             f"{cfg.n_layers} each")
    losses = [float(r["metrics"]["loss"]) for r in records]
    if not (np.all(np.isfinite(losses)) and all(
            bool(torch.isfinite(r["seq_loss"]).all()) for r in records)):
        fail("lm_train", f"non-finite losses: {losses}")
    state["launches"]["flash_attention"] = (
        state["launches"].get("flash_attention", 0)
        + launches["flash_attention"])
    steady = records[LM_STEADY:]
    step_s = [sum(r[k] for k in LM_STAGES) for r in steady]
    step_ms = float(np.median(step_s)) * 1e3
    tokens = 8 * 128
    shares = {k: sum(r[k] for r in steady) / sum(step_s) for k in LM_STAGES}
    init_s = records[0]["elapsed"] - sum(records[0][k] for k in LM_STAGES)
    first_step_s = sum(records[0][k] for k in LM_STAGES)
    mfu = 6 * n_params * tokens / (step_ms / 1e3) / BF16_FLOPS
    main_path = {
        "arch": ARCH, "params": n_params, "batch": 8, "tokens_a_seq": 128,
        "steps": LM_STEPS, "init_s": init_s, "first_step_s": first_step_s,
        "step_ms_median_steady": step_ms,
        "step_ms_steady_all": [x * 1e3 for x in step_s],
        "tokens_per_s": tokens / (step_ms / 1e3),
        "stage_share": shares,
        "stage_ms_median": {k: float(np.median([r[k] for r in steady]))
                            * 1e3 for k in LM_STAGES},
        "peak_mem_gb": peak_gb,
        "loss_first_last": [losses[0], losses[-1]],
        "grad_norm_first_last": [float(records[0]["metrics"]["grad_norm"]),
                                 float(records[-1]["metrics"]["grad_norm"])],
        "model_flops_share": mfu,
        "model_flops_share_def": "6 * params * tokens / step time / "
                                 "989e12 (dense bf16)",
        "launches": {k: v for k, v in launches.items() if v},
        "flash_launches_a_step": cfg.n_layers}
    del records, flash_after
    torch.cuda.empty_cache()

    # (b) against the plain versions; (c) kill and resume, reduced
    checks = lm_checks({"loss": losses[0], "grad_norm":
                        main_path["grad_norm_first_last"][0]})
    torch.cuda.empty_cache()
    resume = lm_kill_and_resume(os.path.join(ROOT, "build", "lm_train_ckpt"))
    torch.cuda.reset_peak_memory_stats()
    others = lm_other_configs()
    emit({"phase": "lm_train", "ok": True, "card": state["smi"],
          "main": main_path, "flash_at_train_shape": flash_train,
          "checks": checks, "kill_and_resume": resume,
          "other_configs": others})


# Phase lm_zoo: the sliding-window and deepseek configs on the card.
# (a) h2o-danube-3-4b at full width and depth: batch 2, a 4,160-token
# prompt, 32 greedy tokens, so that every decode step attends past the
# 4,096-key window; (b) deepseek-moe-16b and (c) deepseek-v2-lite-16b at
# full width and depth (65.5 and 62.8 GB of float32 params): batch 4,
# 256-token prompts, 16 greedy tokens; (d) each of the three at full width
# and 2 layers (the deepseeks: 1 dense + 1 MoE) through the trainer's
# step, 10 steps.
ZOO_WINDOW_ARCH = "h2o-danube-3-4b"
ZOO_MOE_ARCHS = ("deepseek-moe-16b", "deepseek-v2-lite-16b")
ZOO_WINDOW_SERVE = (2, 4160, 32)  # batch, prompt, generated tokens
ZOO_MOE_SERVE = (4, 256, 16)
ZOO_TRAIN_LAYERS, ZOO_TRAIN_STEPS = 2, 10
# The two kernels at the zoo's shapes, each held against its plain
# version in float32 and bf16 and timed in bf16 beside SDPA: flash (b,
# hq, hkv, sq, skv, d, dv, causal, window, prefix) at h2o's prefill and
# deepseek-v2-lite's (MLA: D 192, Dv 128); decode (b, hkv, group, s, d,
# dv, cur_len, window, timed) at h2o's decode (GQA 32 / 8, D 120, the
# window) and deepseek-v2-lite's (Hkv = H, group 1, D 192, Dv 128).
ZOO_FLASH = [(2, 32, 8, 4160, 4160, 120, 120, True, 4096, None),
             (4, 16, 16, 256, 256, 192, 128, True, None, None)]
# The last is held against the plain version and not timed: h2o's decode
# with a window of 1,024, whose bound (3,166) leaves 24 of the 33 splits
# of 128 keys wholly below it (at 4,096 the bound, 94, falls in the first
# split).
ZOO_DECODE = [(2, 8, 4, 4193, 120, 120, 4190, 4096, True),
              (4, 16, 1, 273, 192, 128, 271, None, True),
              (2, 8, 4, 4193, 120, 120, 4190, 1024, False)]
# In bf16 a kernel is held at 2e-2, while a softmax over 4,096 random keys
# gives outputs of about that size (std sqrt(e / 4096) = 0.026), so a key
# taken or lost at the window's bound (a move of about 1e-3) would pass.
# So a windowed bf16 case first lays a ladder of scores across the bound,
# in column 0 of q and k (the other columns stay random): against the
# rows past the window, the keys up to the ladder's top score
# LADDER_BASE + LADDER_STEP min(top - j, rungs), the others 0.  The live
# key at a row's bound then outscores every other live key by 2 or more
# and carries most of its weight, while a key below the bound outscores
# it: one key taken below the bound, or lost at it, moves that row's
# output by O(1).
LADDER_Q, LADDER_BASE, LADDER_STEP = 16.0, 12.0, 2.0
# A bidirectional bf16 case with neither window nor prefix hides only the
# keys past Skv: the wgmma kernel's TMA fills its last kv tile past Skv
# with zeros, and mask_edge's -inf there is all that keeps them out.  A
# zero key taken on random inputs would move a row by about 1e-3 (rows
# of about 0.04 at Skv 1,500), well inside 2e-2.  So such a case first
# lays an end ladder in column 0: every key scores END_LOW, the last key
# (Skv - 1) END_TOP.  Each row then puts nearly all its weight on the
# last key (it reads about v[Skv - 1], O(1)), while a zero-filled key,
# scoring 0, would outweigh it e^12 times: one taken moves every row by
# O(1).
END_LOW, END_TOP = -24.0, -12.0
# A causal bf16 case with neither window nor prefix hides the keys past
# each row's diagonal, and on random inputs a key taken past it would
# move a late row by about 1 / row, well inside 2e-2.  So such a case
# first lays a diagonal ladder in columns 0 and 1: every row scores key j
# at about LADDER_STEP j.  Each row then puts most of its weight on its
# last live key (key r: 0.86), while key r + 1 would outscore it by
# LADDER_STEP: one key taken past the diagonal moves the row by O(1).
# (a)'s float32 generate through the kernels against a float32 forward
# over the same tokens through the plain route (attention_ref), as max
# |difference| / max |logit| over the 32 generated positions: the two
# sum each 4,096-key softmax in other orders across 24 layers (the serve
# phase's decode vs prefill, both through the kernels at 256 tokens, read
# 8.4e-7), while a key of the window's edge taken or left wrongly moves
# the logits by 1e-2 or more.
ZOO_WINDOW_TOL = 1e-4


def lay_ladder(q: torch.Tensor, k: torch.Tensor, top: int,
               rungs: int) -> None:
    """Write the window's ladder (see LADDER_Q) into column 0 of q (the
    rows past the window, as the caller slices them) and of k (keys on
    axis -2), in place."""
    j = torch.arange(k.shape[-2], device=k.device)
    score = LADDER_BASE + LADDER_STEP * (top - j).clamp(max=rungs)
    k[..., 0] = torch.where(j <= top, score * k.shape[-1] ** 0.5 / LADDER_Q,
                            0.0).to(k.dtype)
    q[..., 0] = LADDER_Q


def lay_prefix_ladder(q: torch.Tensor, k: torch.Tensor, prefix: int) -> None:
    """The prefix's ladder, in column 0 of q (rows on axis -2) and k, in
    place: rows below P score key P - 1 at LADDER_BASE and key P at
    LADDER_BASE + LADDER_STEP, every other key 0; rows at or past P score
    nothing there.  A row below P then puts most of its weight on key P -
    1, the last of the prefix (hidden from it by the causal mask alone),
    while key P, the first past the prefix, would outscore it: a prefix
    bound one key short or long moves those rows by O(1)."""
    unit = k.shape[-1] ** 0.5 / LADDER_Q
    k[..., 0] = 0
    k[..., prefix - 1, 0] = LADDER_BASE * unit
    k[..., prefix, 0] = (LADDER_BASE + LADDER_STEP) * unit
    q[..., 0] = 0
    q[..., :prefix, 0] = LADDER_Q


def lay_end_ladder(q: torch.Tensor, k: torch.Tensor) -> None:
    """The end's ladder (see END_LOW), in column 0 of q and k (keys on
    axis -2), in place: every key scores END_LOW against every row, the
    last key END_TOP."""
    unit = k.shape[-1] ** 0.5 / LADDER_Q
    k[..., 0] = END_LOW * unit
    k[..., -1, 0] = END_TOP * unit
    q[..., 0] = LADDER_Q


def lay_causal_ladder(q: torch.Tensor, k: torch.Tensor) -> None:
    """The diagonal's ladder (see END_LOW), in columns 0 and 1 of q and k
    (keys on axis -2), in place: k holds 64 (j // 64) and j % 64, exact
    in bf16, and q one step for every row, so that the scores rise with
    the key exactly, whatever the rounding of q."""
    j = torch.arange(k.shape[-2], device=k.device)
    k[..., 0] = (64 * (j // 64)).to(k.dtype)
    k[..., 1] = (j % 64).to(k.dtype)
    q[..., :2] = LADDER_STEP * q.shape[-1] ** 0.5


def attention_cases(phase: str, flash_cases, decode_cases,
                    seed: int) -> list:
    """The flash kernel at ``flash_cases`` and the decode kernel at
    ``decode_cases`` against their plain versions (float32, and bf16 on a
    ladder across the window's or the prefix's bound where there is one,
    else across the diagonal, or the end of Skv where a flash case is
    bidirectional; a decode case without a window on random inputs),
    each timed in bf16 (a decode case where its ``timed`` says so) beside
    its plain version and SDPA (with a boolean mask where there is a
    window or a prefix) and the bound of the same work: the bytes moved,
    and the operations on the (q, k) pairs the mask keeps (flash) or the
    live keys (decode)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import (attention_mask, attention_ref,
                                         decode_attention_ref)

    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    for i, (b, hq, hkv, sq, skv, d, dv, causal, window,
            prefix) in enumerate(flash_cases):
        kw = {"causal": causal, "window": window, "prefix_len": prefix}
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = attention_inputs(
                [(b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, dv)], dtype,
                seed + i)
            ladder = dtype == torch.bfloat16
            if ladder and prefix is not None:
                lay_prefix_ladder(q, k, prefix)
            elif ladder and window is not None:
                # row r >= window has its bound at r - window + 1, in
                # [1, s - window]: the ladder spans keys 0 .. s - window
                q[:, :, :window, 0] = 0
                lay_ladder(q[:, :, window:], k, sq - window, sq - window)
            elif ladder and not causal:
                lay_end_ladder(q, k)
            elif ladder:
                lay_causal_ladder(q, k)
            got = ops.flash_attention(q, k, v, **kw)
            want = attention_ref(q, k, v, **kw)
            torch.cuda.synchronize()
            case = (f"b{b} hq{hq} hkv{hkv} sq{sq} skv{skv} d{d} dv{dv} "
                    f"{'causal' if causal else 'bidirectional'} "
                    f"window={window} prefix={prefix} {str(dtype)[6:]}"
                    + (" ladder" if ladder else ""))
            row = {"kernel": "flash_attention", "case": case,
                   "max_abs_err": check_close(phase, case, got, want,
                                              ATTN_TOL[dtype])}
            del want
            if dtype == torch.bfloat16:
                keep = attention_mask(sq, skv, causal, window, prefix,
                                      "cuda")
                flops = 2 * (d + dv) * b * hq * int(keep.sum())
                bound_ms, bound_by = attention_bound(nbytes(q, k, v, got),
                                                     flops)
                masked = window is not None or prefix is not None
                row.update(
                    ms=device_time_ms(lambda: ops.flash_attention(
                        q, k, v, **kw)),
                    plain_ms=device_time_ms(lambda: attention_ref(
                        q, k, v, **kw), calls=3, reps=2),
                    library_ms=device_time_ms(lambda: sdpa(
                        q, k, v, attn_mask=keep, enable_gqa=hq != hkv)
                        if masked else sdpa(
                            q, k, v, is_causal=causal,
                            enable_gqa=hq != hkv)),
                    bound_ms=bound_ms, bound_by=bound_by)
                del keep
            rows.append(row)
            del q, k, v, got
    for i, (b, hkv, g, s, d, dv, cur, window, timed) in enumerate(
            decode_cases):
        lo = 0 if window is None else max(0, cur - window)
        for dtype in (torch.bfloat16, torch.float32):
            sets = [attention_inputs([(b, hkv, g, d), (b, hkv, s, d),
                                      (b, hkv, s, dv)], dtype,
                                     seed + 100 + 10 * i + j)
                    for j in range(COLD_SETS if dtype == torch.bfloat16
                                   and timed else 1)]
            q, k, v = sets[0]
            ladder = window is not None and dtype == torch.bfloat16
            if ladder:
                # 32 rungs each side of the bound, and every key further
                # below it (whole splits, at a window of 1,024) on top
                lay_ladder(q, k, lo + 31, 64)
            cur_len = torch.tensor(cur, dtype=torch.int32, device="cuda")
            got = ops.decode_attention(q, k, v, cur_len, window=window)
            want = decode_attention_ref(q, k, v, cur_len, window)
            torch.cuda.synchronize()
            case = (f"b{b} hkv{hkv} group{g} s{s} d{d} dv{dv} cur{cur} "
                    f"window={window} {str(dtype)[6:]}"
                    + (" ladder" if ladder else ""))
            row = {"kernel": "decode_attention", "case": case,
                   "max_abs_err": check_close(phase, case, got, want,
                                              DECODE_TOL[dtype])}
            if dtype == torch.bfloat16 and timed:
                live = cur - lo
                moved = (nbytes(q, got, cur_len)
                         + b * hkv * live * (d + dv) * k.element_size())
                bound_ms, bound_by = attention_bound(
                    moved, 2 * b * hkv * g * live * (d + dv))
                row.update(
                    ms=cold_time_ms(lambda q, k, v: ops.decode_attention(
                        q, k, v, cur_len, window=window), sets),
                    plain_ms=device_time_ms(lambda: decode_attention_ref(
                        q, k, v, cur_len, window), calls=10, reps=3),
                    library_ms=cold_time_ms(lambda q, k, v: sdpa(
                        q.reshape(b, hkv * g, 1, d), k[:, :, lo:cur],
                        v[:, :, lo:cur], enable_gqa=g > 1), sets),
                    bound_ms=bound_ms, bound_by=bound_by, l2="cold",
                    bytes=moved)
            rows.append(row)
            del sets, q, k, v, got, want
    torch.cuda.empty_cache()
    return rows


def generate_logits(engine, inputs: dict, gen: int):
    """A greedy generate of ``gen`` tokens that keeps every step's logits:
    returns (logits [B, gen, V] of the prefill's and each decode step's
    position, the tokens [B, P + gen - 1] those positions read)."""
    from repro_torch.serving import Engine

    prompts = inputs["tokens"]
    B, P = prompts.shape
    logits, cache = engine.prefill(inputs, engine.cache_len(P, gen))
    logits = logits.reshape(B, -1)
    seq, got = [prompts], [logits]
    for _ in range(gen - 1):
        tok = Engine._choose(logits, 0.0, None, 0)
        seq.append(tok)
        lg, cache = engine.decode(tok, cache)
        logits = lg[:, -1]
        got.append(logits)
    del cache
    return torch.stack(got, dim=1), torch.cat(seq, dim=1)


def held(phase: str, name: str, got, want, tol: float) -> dict:
    """max |got - want| / max |want|, failing ``phase`` past ``tol`` or on
    a non-finite logit."""
    scale = float(want.abs().max())
    err = float((got - want).abs().max()) / scale
    if not (bool(torch.isfinite(got).all())
            and bool(torch.isfinite(want).all()) and err <= tol):
        fail(phase, f"{name}: {err} > {tol} of max |logit| {scale}, or "
             "non-finite logits")
    return {"max_rel_err": err, "max_abs_logit": scale, "tol": tol}


def zoo_window_check(cfg, params, inputs, gen: int) -> dict:
    """(a)'s check: a float32 greedy generate through the kernels (each
    decode step past the window), its logits held against a float32
    forward over the same tokens through the plain route."""
    import dataclasses

    from repro_torch.models import transformer
    from repro_torch.models.model_api import Model
    from repro_torch.serving import Engine

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    got, tokens = generate_logits(Engine(Model.from_config(cfg32), params),
                                  {"tokens": inputs["tokens"]}, gen)
    P = inputs["tokens"].shape[1]
    with torch.no_grad(), plain_route():
        x, _ = transformer.forward_hidden(cfg32, params, tokens)
        want = transformer.unembed(cfg32, params, x[:, P - 1:])
    return {"positions": [P - 1, P + gen - 2],
            **held("lm_zoo", cfg.name, got, want, ZOO_WINDOW_TOL),
            "window": cfg.sliding_window, "last_cur_len": P + gen - 1}


def phase_lm_zoo(state: dict) -> None:
    """The zoo's kernel shapes, (a) h2o-danube-3-4b served past its
    window and held against a plain float32 forward, (b) and (c) the
    deepseeks served at full depth, (d) the three through the trainer's
    step at 2 layers."""
    kernels = attention_cases("lm_zoo", ZOO_FLASH, ZOO_DECODE, 200)
    served = {}
    report, cfg, params, inputs, engine = serve_arch(
        state, "lm_zoo", ZOO_WINDOW_ARCH, *ZOO_WINDOW_SERVE)
    del engine
    report["float32_vs_plain_forward"] = zoo_window_check(
        cfg, params, inputs, ZOO_WINDOW_SERVE[2])
    served[ZOO_WINDOW_ARCH] = report
    del params, inputs
    for arch in ZOO_MOE_ARCHS:
        torch.cuda.empty_cache()
        served[arch], _, params, _, engine = serve_arch(
            state, "lm_zoo", arch, *ZOO_MOE_SERVE)
        del params, engine
    torch.cuda.empty_cache()
    trained = {}
    for arch in (ZOO_WINDOW_ARCH,) + ZOO_MOE_ARCHS:
        trained[arch] = cut_depth_run("lm_zoo", arch, ZOO_TRAIN_LAYERS,
                                      ZOO_TRAIN_STEPS, 0)
        state["launches"]["flash_attention"] = (
            state["launches"].get("flash_attention", 0)
            + trained[arch]["train_launches"]["flash_attention"])
    emit({"phase": "lm_zoo", "ok": True, "card": state["smi"],
          "kernels": kernels, "served": served, "trained": trained})


# Phase lm_families: the zoo's last four families on the card, each at
# full width and depth with seeded float32 params (bf16 activations) and
# the serve CLI's inputs: (a) rwkv6-7b (7.53e9 params), batch 4, a
# 1,024-token prompt (a multiple of its chunk of 128, so the chunked WKV
# runs, as sub-chunks of 32: ROADMAP C12), 32 greedy tokens; (b)
# hymba-1.5b, batch 2, a 1,100-token prompt (past the 1,024-key window on
# its 29 windowed layers), 32 tokens; (c) whisper-tiny, batch 4, 1,500
# seeded frames, 64 tokens from the first prompt token; (d) paligemma-3b,
# batch 4, 256 patch embeddings and a 256-token prompt, 32 tokens.  Each
# is held in float32 against a forward over the same tokens (below).
# Then (e) rwkv6-7b, hymba-1.5b and paligemma-3b at 2 layers through the
# trainer's step (the launcher's path, ``cut_depth_run``) and whisper-tiny
# at its full depth through ``Model.loss`` + ``make_train_step`` with
# seeded frames, 10 steps each.
FAMILY_SERVE = {"rwkv6-7b": (4, 1024, 32), "hymba-1.5b": (2, 1100, 32),
                "whisper-tiny": (4, 1, 64), "paligemma-3b": (4, 256, 32)}
FAMILY_TRAIN = ("rwkv6-7b", "hymba-1.5b", "paligemma-3b")
FAMILY_AUDIO_TRAIN = (8, 128)  # whisper's batch and text tokens
# The kernels at the new shapes (formats as ZOO_FLASH and ZOO_DECODE):
# flash at hymba's prefill (GQA 25 / 5, a windowed and a global layer),
# whisper's encoder (non-causal, 1,500 frames) and cross-attention (64
# text rows over 1,500 frames), paligemma's prefill (MQA 8 / 1, D 256,
# the 256-patch prefix); decode at hymba's step (group 5, windowed and
# global), whisper's cross-attention (cur_len = S = 1,500) and
# paligemma's step (group 8, D 256).
FAMILY_FLASH = [(2, 25, 5, 1100, 1100, 64, 64, True, 1024, None),
                (2, 25, 5, 1100, 1100, 64, 64, True, None, None),
                (4, 6, 6, 1500, 1500, 64, 64, False, None, None),
                (4, 6, 6, 64, 1500, 64, 64, False, None, None),
                (4, 8, 1, 512, 512, 256, 256, True, None, 256)]
FAMILY_DECODE = [(2, 5, 5, 1133, 64, 64, 1132, 1024, True),
                 (2, 5, 5, 1133, 64, 64, 1132, None, True),
                 (4, 6, 1, 1500, 64, 64, 1500, None, True),
                 (4, 1, 8, 545, 256, 256, 544, None, True)]
# The float32 checks, as max |difference| / max |logit| (ZOO_WINDOW_TOL's
# reasoning: the two sides sum each softmax, the WKV and the scan in other
# orders across the layers; a key or a state taken wrongly moves the
# logits by 1e-2 or more).
FAMILY_TOL = 1e-4


def family_check(cfg, params, inputs, gen: int) -> dict:
    """A float32 greedy generate through the kernels, each position's
    logits held against a float32 forward over the same tokens: rwkv6-7b
    against the recurrent forward (``rwkv_mode="recurrent"``: the
    generate's prefill ran the chunked WKV); hymba-1.5b and paligemma-3b
    (with its patch prefix) against the forward through the plain route;
    whisper-tiny against the teacher-forced forward through the kernels
    and through the plain route."""
    import dataclasses

    from repro_torch.models import encdec, transformer
    from repro_torch.models.model_api import Model
    from repro_torch.serving import Engine

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    got, tokens = generate_logits(Engine(Model.from_config(cfg32), params),
                                  inputs, gen)
    P = inputs["tokens"].shape[1]
    out = {"positions": [P - 1, P + gen - 2]}
    with torch.no_grad():
        if cfg.family == "audio":
            frames = inputs["frames"]
            want = encdec.forward(cfg32, params, tokens, frames)
            out["vs_forward_through_kernels"] = held(
                "lm_families", cfg.name, got, want, FAMILY_TOL)
            with plain_route():
                want = encdec.forward(cfg32, params, tokens, frames)
            out["vs_forward_plain_route"] = held(
                "lm_families", cfg.name, got, want, FAMILY_TOL)
            return out
        extra = inputs.get("patch_embeds")
        start = P - 1 + (0 if extra is None else extra.shape[1])
        if cfg.block_kind == "rwkv":
            ref = dataclasses.replace(cfg32, rwkv_mode="recurrent")
            x, _ = transformer.forward_hidden(ref, params, tokens)
            out["reference"] = "recurrent forward"
        else:
            with plain_route():
                x, _ = transformer.forward_hidden(cfg32, params, tokens,
                                                  extra_embeds=extra)
            out["reference"] = "forward through the plain route"
        want = transformer.unembed(cfg32, params, x[:, start:])
    out.update(held("lm_families", cfg.name, got, want, FAMILY_TOL))
    return out


# The two scans the families run in plain PyTorch (no Pallas kernel in the
# reference either; ROADMAP B17, B18), timed at the served shapes: rwkv's
# WKV at prefill (the chunked path, B 4, H 64, S 1,024, N 64, chunk 128)
# and decode (the recurrence, S 1), hymba's selective scan at prefill (B
# 2, S 1,100, d_inner 3,200, d_state 16) and decode (S 1); r, k, v, u, dt,
# B and C in bf16 as the model passes them, the rest float32.
SCAN_CASES = [("wkv_chunked", 1024), ("wkv_recurrent", 1),
              ("ssm_scan", 1100), ("ssm_scan", 1)]


def plain_scans() -> list:
    """Each scan of SCAN_CASES: host wall ms (synchronized), the device
    operations a call and their device ms (torch.profiler), and the bound
    of the same work: its inputs read and outputs written once over the
    memory rate, its multiply-adds over the float32 rate."""
    from repro_torch.models import mamba, rwkv6

    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def rnd(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * scale).to(dtype)

    bf16, rows = torch.bfloat16, []
    for name, S in SCAN_CASES:
        if name.startswith("wkv"):
            B, H, N = 4, 64, 64
            r, k, v = (rnd(B, H, S, N, dtype=bf16) for _ in range(3))
            lw = torch.empty(B, H, S, N, device="cuda").uniform_(
                rwkv6.LW_MIN, rwkv6.LW_MAX, generator=gen)
            args = (r, k, v, lw, rnd(H, N, scale=0.5),
                    rnd(B, H, N, N, scale=0.1))
            if name == "wkv_chunked":
                C = rwkv6.sub_chunk(128)

                def fn():
                    return rwkv6.wkv_chunked(*args, 128)
                # per sub-chunk and head: A and y_intra (C x C x N), the
                # state's read and update (C x N x N)
                macs = B * H * (S // C) * 2 * (C * C * N + C * N * N)
            else:
                def fn():
                    return rwkv6.wkv_recurrent(*args)
                macs = B * H * S * 3 * N * N
            out_bytes = (B * H * S * N + B * H * N * N) * 4
            shape = {"B": B, "H": H, "S": S, "N": N}
        else:
            B, Di, Ns = 2, 3200, 16
            u = rnd(B, S, Di, dtype=bf16)
            dt = torch.nn.functional.softplus(rnd(B, S, Di)).to(bf16)
            b_in, c_in = (rnd(B, S, Ns, dtype=bf16) for _ in range(2))
            args = (u, dt, b_in, c_in, rnd(Di, Ns, scale=0.5), rnd(Di),
                    rnd(B, Di, Ns))

            def fn():
                return mamba._ssm_scan(*args)
            macs = B * S * Di * Ns * 2
            out_bytes = (B * S * Di + B * Di * Ns) * 4
            shape = {"B": B, "S": S, "d_inner": Di, "d_state": Ns}
        with torch.no_grad():
            moved = nbytes(*args) + out_bytes
            by_bytes = moved / HBM_BYTES_PER_S * 1e3
            by_ops = 2 * macs / F32_FLOPS * 1e3
            calls = 2 if S > 1 else 20
            dev = device_ops(fn, calls=calls)
            rows.append({
                "scan": name, **shape,
                "wall_ms": wall_ms(fn, calls=calls),
                "device_ms": sum(us for _, us in dev.values()) / 1e3,
                "device_ops_a_call": sum(n for n, _ in dev.values()),
                "bound_ms": max(by_bytes, by_ops),
                "bound_by": "bytes" if by_bytes >= by_ops else "operations"})
        del args
    torch.cuda.empty_cache()
    return rows


def whisper_train_run(steps: int) -> dict:
    """whisper-tiny at its full depth (4 + 4 layers) through
    ``Model.loss`` and ``make_train_step`` (the launcher refuses an
    encoder-decoder, as the reference's has no audio path): a seeded
    batch of tokens and 1,500 frames, ``steps`` AdamW steps, losses
    finite."""
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch_train
    from repro_torch.models.model_api import Model
    from repro_torch.train import train_step as ts_mod
    from repro_torch.train.optimizer import AdamW, cosine_schedule

    dev = torch.device(LM_DEVICE)
    cfg = get_config("whisper-tiny")
    model = Model.from_config(cfg)
    opt = AdamW(cosine_schedule(3e-4, 20, 30))
    step_fn = ts_mod.make_train_step(model, opt)
    B, S = FAMILY_AUDIO_TRAIN
    toks = prng.randint(prng.key(SEED + 2), (B, S + 1), 0, cfg.vocab_size,
                        device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    batch = {"tokens": toks[:, :-1].contiguous(),
             "targets": toks[:, 1:].contiguous(),
             "loss_mask": torch.ones(B, S, device=dev),
             "frames": torch.randn(B, cfg.enc_seq, cfg.d_model,
                                   generator=gen, device=dev)}
    torch.cuda.reset_peak_memory_stats()
    st = ts_mod.init_train_state(model, opt, gen, dev)
    losses, step_ms = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with launch_train.deterministic(dev):
            st, met = step_fn(st, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(met["loss"]))
    if not np.all(np.isfinite(losses)):
        fail("lm_families", f"whisper-tiny: non-finite losses {losses}")
    out = {"layers": [cfg.n_enc_layers, cfg.n_layers], "batch": [B, S],
           "frames": cfg.enc_seq, "losses": losses, "step_ms": step_ms,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    del st, batch
    torch.cuda.empty_cache()
    return out


def phase_lm_families(state: dict) -> None:
    """The kernels at the four families' shapes, (a)-(d) each arch served
    at full width and depth and held in float32, (e) each trained."""
    kernels = attention_cases("lm_families", FAMILY_FLASH, FAMILY_DECODE,
                              400)
    served = {}
    for arch, (batch, prompt, gen) in FAMILY_SERVE.items():
        report, cfg, params, inputs, engine = serve_arch(
            state, "lm_families", arch, batch, prompt, gen)
        del engine
        report["float32_check"] = family_check(cfg, params, inputs, gen)
        served[arch] = report
        del params, inputs
        torch.cuda.empty_cache()
    trained = {}
    for arch in FAMILY_TRAIN:
        trained[arch] = cut_depth_run("lm_families", arch, ZOO_TRAIN_LAYERS,
                                      ZOO_TRAIN_STEPS, 0)
        state["launches"]["flash_attention"] = (
            state["launches"].get("flash_attention", 0)
            + trained[arch]["train_launches"]["flash_attention"])
    trained["whisper-tiny"] = whisper_train_run(ZOO_TRAIN_STEPS)
    emit({"phase": "lm_families", "ok": True, "card": state["smi"],
          "kernels": kernels, "plain_scans": plain_scans(),
          "served": served, "trained": trained})


DRY_TABLE_LOG2 = 28          # the reference's AMPER cell: 2^28 priorities
DRY_BATCH = 65_536           # its batch
DRY_MODES = ("broadcast", "kernel", "fused")
DRY_TIMED = 20               # steady draws timed a mode (the median)
DRY_SWEEP_DIR = os.path.join(ROOT, "build", "dryrun")
DRY_SWEEP_TIMEOUT = 600      # seconds the LM sweep may take from its start
DRY_SWEEP_WORKERS = 7        # sweep processes at once (the machine's cores
# but the smoke's own)
DRY_SWEEP_BY_SHAPE = ("hymba-1.5b", "rwkv6-7b")  # a process a cell: the
# long scans (a meta op a step) make their cells the sweep's longest
DRY_REPLACES = {"multi_query_match": "src/repro/kernels/tcam_match.py:73",
                "rank_select": "src/repro/kernels/amper_sample.py:276"}


class LmSweep:
    """The LM sweep: every arch x shape cell of ``python -m
    repro_torch.launch.dryrun`` (traced on ``meta``, the single-pod
    mesh), as one invocation an arch (``--arch A``; a cell, ``--shape S``
    too, for ``DRY_SWEEP_BY_SHAPE``, longest first),
    ``DRY_SWEEP_WORKERS`` at a time, each a process at the lowest CPU
    priority that sees no card (it runs nothing there) with one CPU
    thread.  ``run_phases`` starts it after the build and waits for it
    before the first phase that times the host, so that it overlaps only
    the kernel phases, whose times are the card's."""

    def __init__(self):
        import threading

        self.lock = threading.Lock()
        self.procs, self.done, self.threads = [], [], []
        self.stopped = False
        self.t0 = self.end = None

    def start(self) -> None:
        import threading

        from repro_torch.configs import ARCH_IDS
        from repro_torch.models.model_api import SHAPE_CELLS

        os.makedirs(DRY_SWEEP_DIR, exist_ok=True)
        jobs = [(a, sh) for a in DRY_SWEEP_BY_SHAPE for sh in SHAPE_CELLS]
        jobs += [(a, None) for a in ARCH_IDS if a not in DRY_SWEEP_BY_SHAPE]
        env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
               "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1"}
        self.t0 = time.perf_counter()

        def worker():
            while True:
                with self.lock:
                    if self.stopped or not jobs:
                        return
                    arch, shape = jobs.pop(0)
                    name = arch + (f"-{shape}" if shape else "")
                    out = os.path.join(DRY_SWEEP_DIR, name + ".json")
                    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                           "--arch", arch, "--out", out]
                    cmd += ["--shape", shape] if shape else []
                    with open(out + ".log", "w") as log:
                        proc = subprocess.Popen(cmd, stdout=log,
                                                stderr=subprocess.STDOUT,
                                                cwd=ROOT, env=env)
                    with contextlib.suppress(OSError):
                        os.setpriority(os.PRIO_PROCESS, proc.pid, 19)
                    self.procs.append(proc)
                rc = proc.wait()
                with self.lock:
                    self.done.append((name, rc, out))

        self.threads = [threading.Thread(target=worker, daemon=True)
                        for _ in range(DRY_SWEEP_WORKERS)]
        for t in self.threads:
            t.start()

    def wait(self) -> None:
        """Start the sweep if it has not started, and wait for its end."""
        if self.t0 is None:
            self.start()
        for t in self.threads:
            t.join(timeout=max(0.0, DRY_SWEEP_TIMEOUT
                               - (time.perf_counter() - self.t0)))
            if t.is_alive():
                fail("dryrun", f"the LM sweep ran past {DRY_SWEEP_TIMEOUT} s")
        if self.end is None:
            self.end = time.perf_counter()

    def stop(self) -> None:
        """Start no more sweep processes and kill those still running."""
        with self.lock:
            self.stopped = True
            procs = list(self.procs)
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait()

    def report(self) -> dict:
        """Wait for the sweep; its cell count, errors, skips and seconds
        (fails the phase on an error or a non-zero exit)."""
        self.wait()
        results = []
        for name, rc, out in sorted(self.done):
            if rc != 0 or not os.path.exists(out):
                with open(out + ".log") as f:
                    tail = f.read()[-600:]
                fail("dryrun", f"the LM sweep's {name} exited {rc}: {tail}")
            with open(out) as f:
                results += json.load(f)
        errors = [f"{r['arch']} x {r['shape']}: {r.get('error')}"
                  for r in results if r["status"] == "error"]
        if errors:
            fail("dryrun", f"the LM sweep's errors: {errors[:3]}")
        ok = [r for r in results if r["status"] == "ok"]
        # the sharded program's terms: every ok cell has them, and the
        # deepseeks went through the shard-map dispatch
        unset = [f"{r['arch']} x {r['shape']}" for r in ok if None in (
            r["roofline"]["coll_bytes_per_dev"],
            r["roofline"]["t_collective_s"],
            r["memory"]["temp_bytes_per_dev"])]
        if unset:
            fail("dryrun", f"the LM sweep left terms unset: {unset[:3]}")
        scatter = [f"{r['arch']} x {r['shape']}" for r in ok
                   if r["arch"].startswith("deepseek")
                   and set(r["moe_dispatch"]) != {"shard_map"}]
        if scatter:
            fail("dryrun", f"not through the shard-map dispatch: {scatter}")
        terms = {f"{r['arch']} x {r['shape']}": {
            "coll_bytes_per_dev": r["roofline"]["coll_bytes_per_dev"],
            "t_collective_s": r["roofline"]["t_collective_s"],
            "temp_bytes_per_dev": r["memory"]["temp_bytes_per_dev"],
            "bottleneck": r["roofline"]["bottleneck"]} for r in ok}
        return {"cells": len(results),
                "ok": len(ok), "sharded_terms": terms,
                "errors": len(errors),
                "skips": {f"{r['arch']} x {r['shape']}": r["reason"]
                          for r in results if r["status"] == "skip"},
                "seconds": self.end - self.t0,
                "processes": len(self.done), "workers": DRY_SWEEP_WORKERS,
                "trace_s_sum": sum(r.get("trace_s", 0.0) for r in results),
                "out": os.path.relpath(DRY_SWEEP_DIR, ROOT)}


def dry_kernel_rows(state: dict, cell, launches: dict) -> dict:
    """``multi_query_match`` and ``rank_select`` on shard 0 of the
    single-pod cell (2^24 rows, the draw's m = 20 ranges, 65,536 ranks),
    held exactly against their plain versions and timed beside them; the
    kernels-line rows at this shape, with ``launches`` (the single-pod
    draws', whose shards have this shape)."""
    from repro_torch import prng
    from repro_torch.core.amper import fr_intervals, group_representatives
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import multi_query_match_ref, rank_select_ref

    pq, valid = cell.pq[0], cell.valid[0]
    kq, _ = prng.split(cell.key)  # the draw's ranges come from kq
    lo, hi = (t.to(pq.device) for t in fr_intervals(
        group_representatives(kq, cell.cfg), cell.cfg))
    sel, counts = ops.multi_query_match(pq, valid, lo, hi)
    sel_p, counts_p = multi_query_match_ref(pq, valid, lo, hi)
    members = int(sel_p.sum())
    rank = rank_cases(members, DRY_BATCH, seed=7)
    idx, cnt = ops.rank_select(pq, valid, lo, hi, rank)
    idx_p, cnt_p = rank_select_ref(pq, valid, lo, hi, rank)
    torch.cuda.synchronize()
    if not (torch.equal(sel, sel_p) and torch.equal(counts, counts_p)):
        fail("dryrun", "multi_query_match != plain on a 2^24-row shard")
    if not (torch.equal(idx, idx_p) and torch.equal(cnt, cnt_p)):
        fail("dryrun", f"rank_select != plain on a 2^24-row shard at "
             f"{DRY_BATCH} ranks: {int((idx != idx_p).sum())} differ")
    rows = {}
    for name, fn, plain, moved, err in (
            ("multi_query_match",
             lambda: ops.multi_query_match(pq, valid, lo, hi),
             lambda: multi_query_match_ref(pq, valid, lo, hi),
             nbytes(pq, valid, lo, hi, sel, counts),
             max(max_abs_diff(sel, sel_p), max_abs_diff(counts, counts_p))),
            ("rank_select", lambda: ops.rank_select(pq, valid, lo, hi, rank),
             lambda: rank_select_ref(pq, valid, lo, hi, rank),
             nbytes(pq, valid, lo, hi, rank, idx, cnt),
             max(max_abs_diff(idx, idx_p), max_abs_diff(cnt, cnt_p)))):
        key = f"{name}@2^24"
        rows[key] = {
            "name": f"{name} (AMPER cell: one 2^24-row shard"
                    + (f", {DRY_BATCH} ranks)" if name == "rank_select"
                       else ", m = 20)"),
            "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": DRY_REPLACES[name],
            "max_abs_err": err, "ms": device_time_ms(fn),
            "plain_ms": device_time_ms(plain, calls=10, reps=3),
            "bound_ms": moved / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": None}
        state["kernels"][key] = rows[key]
        state["launches"][key] = launches[name]
    return {"members": members, **{k: {f: v[f] for f in ("ms", "plain_ms",
                                                         "bound_ms")}
                                   for k, v in rows.items()}}


def phase_dryrun(state: dict, sweep: LmSweep) -> None:
    """The dry run (``launch/dryrun.py``): the paper's own workload, the
    sharded AMPER-fr draw over 2^28 priorities with a batch of 65,536, on
    both production meshes (16 shards of 2^24 rows, 32 of 2^23), through
    ``run_amper_cell`` and then in each of ``DRY_MODES`` on one table:
    ``kernel`` and ``fused`` equal to ``broadcast`` bit for bit, one
    ``multi_query_match`` (and in ``fused`` one ``rank_select``) a shard
    a draw, the steady draw timed; the two kernels at the new shape held
    and timed; then the LM sweep's report (``LmSweep``)."""
    from repro_torch.core import sharded as shc
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh

    dev = torch.device("cuda")
    names = ("multi_query_match", "rank_select")
    launches = dict.fromkeys(names, 0)
    meshes, rows = {}, None
    for multi_pod in (False, True):
        ops.reset_launches()
        t0 = time.perf_counter()
        report = dryrun.run_amper_cell(multi_pod, DRY_TABLE_LOG2, DRY_BATCH,
                                       device="cuda")
        cli_s = time.perf_counter() - t0
        if report["status"] != "ok":
            fail("dryrun", f"run_amper_cell({multi_pod}): "
                 f"{report.get('error')} {report.get('traceback', '')[-600:]}")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        mesh = make_production_mesh(multi_pod=multi_pod, device=dev)
        cell = dryrun.amper_cell(mesh, DRY_TABLE_LOG2, DRY_BATCH, dev)
        axes = [a for a in ("pod", "data") if a in mesh.axis_names]
        draws = {m: shc.sharded_sample_fr(mesh, cell.cfg._replace(
            fr_mode=m), DRY_BATCH, axis_names=axes) for m in DRY_MODES}
        want = draws["broadcast"](cell.pq, cell.valid, cell.key)
        if [int(want.min()), int(want.max())] != report["draw_index_range"]:
            fail("dryrun", f"run_amper_cell drew {report['draw_index_range']}"
                 f", the same cell {[int(want.min()), int(want.max())]}")
        modes = {}
        for m in DRY_MODES:
            before = {k: ops.launches[k] for k in names}
            got = draws[m](cell.pq, cell.valid, cell.key)
            torch.cuda.synchronize()
            per_draw = {k: ops.launches[k] - before[k] for k in names}
            if not torch.equal(got, want):
                fail("dryrun", f"{m} != broadcast on the 2^28 cell "
                     f"({'multi' if multi_pod else 'single'}-pod): "
                     f"{int((got != want).sum())} of {DRY_BATCH} differ")
            expect = {"broadcast": (0, 0), "kernel": (cell.n_shards, 0),
                      "fused": (cell.n_shards, cell.n_shards)}[m]
            if tuple(per_draw[k] for k in names) != expect:
                fail("dryrun", f"{m}: launches a draw {per_draw}, want "
                     f"{dict(zip(names, expect))}")
            times = []
            for _ in range(DRY_TIMED):
                t1 = time.perf_counter()
                draws[m](cell.pq, cell.valid, cell.key)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t1) * 1e3)
            modes[m] = {"launches_a_draw": per_draw,
                        "draw_ms_median": float(np.median(times)),
                        "draw_ms_range": [min(times), max(times)]}
        mesh_launches = {k: ops.launches[k] for k in names}
        for k in names:
            launches[k] += mesh_launches[k]
        shard_bytes = report["memory"]["argument_bytes_per_dev"]
        meshes[report["mesh"]] = {
            "n_shards": cell.n_shards, "rows_per_shard": report[
                "rows_per_shard"], "compile_s": report["compile_s"],
            "run_amper_cell_s": cli_s,
            "shard_bytes": shard_bytes,
            "bound_ms_a_shard": shard_bytes / HBM_BYTES_PER_S * 1e3,
            "bound_ms_table": report["memory"]["table_bytes"]
            / HBM_BYTES_PER_S * 1e3,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "modes": modes, "modes_equal_broadcast": True}
        if not multi_pod:
            rows = dry_kernel_rows(state, cell, mesh_launches)
        del cell, draws, want
        torch.cuda.empty_cache()
    for k in names:
        state["launches"][k] = state["launches"].get(k, 0) + launches[k]
    emit({"phase": "dryrun", "ok": True, "card": state["smi"],
          "table_log2": DRY_TABLE_LOG2, "batch": DRY_BATCH, "amper": meshes,
          "launches": launches, "kernels_at_2^24": rows,
          "lm_sweep": sweep.report()})


# --- the process mesh (phase ``mesh``) ----------------------------------------
#
# Ranks are spawned processes (``launch.mesh.run_ranks``) that share the one
# card: ``gloo`` with CUDA tensors (NCCL refuses two ranks on one card), and
# NCCL at world size 1.  The kernels are built in this process first, so the
# ranks load the built libraries.  Every function a rank runs is defined at
# module level here and imports only torch and the port.

MESH_DQN_STEPS = 200      # (a): agent steps a mode (learn_start 100)
MESH_DQN_TIMED = 50       # the last of them, timed
MESH_DQN_RANKS = 2        # (a) and (e): ranks (2 shards each in (a))
MESH_CELL_RANKS = 4       # (b) and (d): ranks (4 of the 16 shards each)
MESH_CELL_MODES = ("kernel", "fused")
MESH_CELL_TIMED = 5       # (b), (c): draws timed a mode
MESH_MOE_ARCH = "deepseek-moe-16b"
MESH_MOE_TOKENS = (4, 256)
MESH_MOE_TOL = 1e-5       # (d): atol = rtol against one process
MESH_POD_ARCH, MESH_POD_LAYERS = "stablelm-1.6b", 2
MESH_POD_BATCH = (2, 128)  # (e): sequences a pod, tokens
MESH_RANK_TIMEOUT = 400.0


def fingerprint(t: torch.Tensor) -> int:
    """An exact fingerprint of a tensor's bits (sum of each element's bits
    times its position, in wrapping int64), computed on its device."""
    flat = t.detach().contiguous().reshape(-1)
    as_int = {1: torch.int8, 2: torch.int16, 4: torch.int32,
              8: torch.int64}[flat.element_size()]
    bits = flat.view(as_int).to(torch.int64)
    pos = torch.arange(1, bits.numel() + 1, device=bits.device)
    return int((bits * pos).sum())


def mesh_dqn_run(mesh, mode: str) -> dict:
    """(a) on ``mesh``: the ``sharded`` phase's agent (CartPole, 16 envs,
    batch 64, hidden 128, 1M rows on 4 shards, AMPER-fr in ``mode``)
    through ``runner`` (eager), ``MESH_DQN_STEPS`` steps from ``SEED``; its
    draws, a params fingerprint, the returns, the launches and the steps/s
    of the last ``MESH_DQN_TIMED`` steps."""
    from repro_torch import prng
    from repro_torch.kernels import ops
    from repro_torch.models.qhead import tree_leaves
    from repro_torch.rl.dqn import DQNConfig, make_dqn

    cfg = DQNConfig(env="cartpole", num_envs=16, replay_size=N_ROWS,
                    batch=64, hidden=128, v_max=8.0, learn_start=100,
                    sampler="amper-fr-sharded", amper_fr_mode=mode)
    dqn = make_dqn(cfg, device=mesh.home, mesh=mesh)
    key = prng.key(SEED)
    ops.reset_launches()
    run = dqn.runner(dqn.init(key), key, MESH_DQN_STEPS, capture=False,
                     record_idx=True)
    run.advance(MESH_DQN_STEPS - MESH_DQN_TIMED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = run.advance(MESH_DQN_STEPS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return {"idx": torch.stack([i for i in run.idx if i is not None]).cpu(),
            "params": [fingerprint(t) for t in tree_leaves(st.params)],
            "returns": st.last_returns.cpu(),
            "launches": {k: v for k, v in ops.launches.items() if v},
            "steps_per_s": MESH_DQN_TIMED / dt,
            "held_rows": int(st.buffer.storage["obs"].shape[0])}


def mesh_cell_draws(mesh) -> dict:
    """(b), (c) on ``mesh``: the dry run's 2^28-row cell (the shards this
    process holds), drawn in ``MESH_CELL_MODES``: the first draw, its
    launches, and ``MESH_CELL_TIMED`` timed draws (ms)."""
    from repro_torch.core import sharded as shc
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun

    cell = dryrun.amper_cell(mesh, DRY_TABLE_LOG2, DRY_BATCH, mesh.home)
    axes = [a for a in ("pod", "data") if a in mesh.axis_names]
    out = {"held": len(cell.pq)}
    for m in MESH_CELL_MODES:
        draw = shc.sharded_sample_fr(mesh, cell.cfg._replace(fr_mode=m),
                                     DRY_BATCH, axis_names=axes)
        ops.reset_launches()
        idx = draw(cell.pq, cell.valid, cell.key)
        torch.cuda.synchronize()
        launches = {k: v for k, v in ops.launches.items() if v}
        times = []
        for _ in range(MESH_CELL_TIMED):
            t0 = time.perf_counter()
            draw(cell.pq, cell.valid, cell.key)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out[m] = {"idx": idx.cpu(), "launches_a_draw": launches,
                  "draw_ms_median": float(np.median(times)),
                  "draw_ms_range": [min(times), max(times)]}
    return out


def mesh_moe_run(mesh) -> dict:
    """(d) on the 2 x 2 ``mesh``: one deepseek-moe-16b MoE layer at full
    width (float32 weights and tokens from ``SEED``) through
    ``moe_apply`` under the training rules: output, metrics, ms."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import common
    from repro_torch.models import moe as moe_mod

    cfg = get_config(MESH_MOE_ARCH)
    dev = mesh.home
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = common.init_params(gen, moe_mod.moe_specs(cfg, None), dev)
    x = torch.randn(*MESH_MOE_TOKENS, cfg.d_model, generator=gen,
                    device=dev)
    with shd.use_rules(shd.ShardingRules(mesh, shd.TRAIN_RULES)):
        out, metrics = moe_mod.moe_apply(cfg, params, x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        moe_mod.moe_apply(cfg, params, x)
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return {"out": out.cpu(), "metrics": {k: float(v)
                                          for k, v in metrics.items()},
            "ms": ms}


def mesh_pod_run(mesh) -> dict:
    """(e) on the ("pod",) ``mesh``: stablelm-1.6b at full width and
    ``MESH_POD_LAYERS`` layers (params and tokens from ``SEED``), each
    pod's gradient on its ``MESH_POD_BATCH`` half of the batch, synced by
    ``grad_fn_with_pod_sync`` (int8 and float32): fingerprints and ms."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.distributed.collectives import grad_fn_with_pod_sync
    from repro_torch.models.model_api import Model
    from repro_torch.models.qhead import tree_leaves, tree_map

    cfg = dataclasses.replace(get_config(MESH_POD_ARCH),
                              n_layers=MESH_POD_LAYERS)
    model = Model.from_config(cfg)
    dev = mesh.home
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = model.init_params(gen, dev)
    b, s = MESH_POD_BATCH
    n_pod = mesh.shape["pod"]
    tok = torch.randint(0, cfg.vocab_size, (n_pod * b, s + 1),
                        generator=gen, device=dev)
    batch = {"tokens": tok[:, :-1], "targets": tok[:, 1:],
             "loss_mask": torch.ones(n_pod * b, s, device=dev)}

    def grad_fn(p, piece):
        p = tree_map(lambda t: t.detach().requires_grad_(True), p)
        loss, _ = model.loss(p, piece)
        return list(torch.autograd.grad(loss, tree_leaves(p)))

    out = {"n_params": sum(t.numel() for t in tree_leaves(params))}
    torch.use_deterministic_algorithms(True)
    try:
        for compress in (True, False):
            fn = grad_fn_with_pod_sync(grad_fn, mesh, compress=compress)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            synced = fn(params, batch)
            torch.cuda.synchronize()
            out[f"compress={compress}"] = {
                "ms": (time.perf_counter() - t0) * 1e3,
                "fingerprints": [fingerprint(t) for t in synced],
                "finite": all(bool(torch.isfinite(t).all()) for t in synced)}
            del synced
    finally:
        torch.use_deterministic_algorithms(False)
    return out


def mesh_ranks_dqn(rank: int, world: int, dev) -> dict:
    """The ranks of (a) and (e)."""
    from repro_torch.launch.mesh import make_process_mesh

    out = {}
    replay = make_process_mesh((SHARDS,), ("data",), backend="gloo",
                               device=dev)
    for m in ("kernel", "fused"):
        out[m] = mesh_dqn_run(replay, m)
    pods = make_process_mesh((world,), ("pod",), backend="gloo", device=dev)
    out["pod"] = mesh_pod_run(pods)
    return out


def mesh_ranks_cell(rank: int, world: int, dev) -> dict:
    """The ranks of (b) and (d)."""
    from repro_torch.launch.mesh import make_process_mesh

    prod = make_process_mesh((16, 16), ("data", "model"), backend="gloo",
                             device=dev)
    out = {"cell": mesh_cell_draws(prod)}
    moe = make_process_mesh((2, 2), ("data", "model"), backend="gloo",
                            device=dev)
    out["moe"] = mesh_moe_run(moe)
    return out


def mesh_ranks_nccl(rank: int, world: int, dev) -> dict:
    """The rank of (c): the cell's draws over a 16 x 16 process mesh of
    one NCCL rank, every shard local."""
    from repro_torch.launch.mesh import make_process_mesh

    prod = make_process_mesh((16, 16), ("data", "model"), backend="nccl",
                             device=dev)
    return mesh_cell_draws(prod)


def mesh_launches(state: dict, runs, want: dict) -> dict:
    """The kernels' launches summed over ``runs`` (one dict a rank), held
    to ``want`` and added to the kernels line's counts."""
    got = {}
    for r in runs:
        for k, v in r.items():
            got[k] = got.get(k, 0) + v
    for k, v in want.items():
        if got.get(k, 0) != v:
            fail("mesh", f"{k} launched {got.get(k, 0)} times, want {v}")
        state["launches"][k] = state["launches"].get(k, 0) + got[k]
    return got


def phase_mesh(state: dict) -> None:
    """The process mesh: (a) the ``sharded`` phase's DQN on 2 ranks x 2
    shards in ``kernel`` and ``fused`` against one process, bit for bit;
    (b) the dry run's 2^28-row cell on 16 shards over 4 ranks in both
    modes against one process, bit for bit; (c) the same draws at NCCL
    world size 1; (d) a full-width deepseek-moe-16b MoE layer over a
    2 x 2 ("data", "model") mesh of 4 ranks against the 4 slots in one
    process; (e) ``grad_fn_with_pod_sync`` on stablelm-1.6b's 2-layer
    gradients over 2 pods against one process."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import Mesh
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import make_production_mesh, run_ranks
    from repro_torch.rl.dqn import DQNConfig

    build.build_all()  # the ranks find the libraries built
    cuda = torch.device("cuda")
    t_phase = time.perf_counter()
    # the single-process twins
    one = {m: mesh_dqn_run(Mesh([cuda] * SHARDS), m) for m in ("kernel",
                                                               "fused")}
    one["cell"] = mesh_cell_draws(make_production_mesh(device=cuda))
    torch.cuda.empty_cache()
    one["moe"] = mesh_moe_run(Mesh(np.full((2, 2), cuda, dtype=object),
                                   ("data", "model")))
    one["pod"] = mesh_pod_run(Mesh([cuda] * MESH_DQN_RANKS, ("pod",)))
    torch.cuda.empty_cache()
    learn = sum(1 for t in range(MESH_DQN_STEPS) if t >= 100
                and t % DQNConfig.train_every == 0)
    t0 = time.perf_counter()
    two = run_ranks(mesh_ranks_dqn, MESH_DQN_RANKS, backend="gloo",
                    device="cuda", timeout=MESH_RANK_TIMEOUT)
    two_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    four = run_ranks(mesh_ranks_cell, MESH_CELL_RANKS, backend="gloo",
                     device="cuda", timeout=MESH_RANK_TIMEOUT)
    four_s = time.perf_counter() - t0
    nccl = run_ranks(mesh_ranks_nccl, 1, backend="nccl", device="cuda",
                     timeout=MESH_RANK_TIMEOUT)[0]
    # (a)
    dqn = {}
    for m in ("kernel", "fused"):
        for r, got in enumerate(two):
            g, o = got[m], one[m]
            if not np.array_equal(g["idx"], o["idx"].numpy()):
                fail("mesh", f"(a) {m}: rank {r}'s draws != one process's")
            if g["params"] != o["params"]:
                fail("mesh", f"(a) {m}: rank {r}'s params != one process's")
            if not np.array_equal(g["returns"].view(np.int32),
                                  o["returns"].numpy().view(np.int32)):
                fail("mesh", f"(a) {m}: rank {r}'s returns != one process's")
            if g["held_rows"] != N_ROWS // MESH_DQN_RANKS:
                fail("mesh", f"(a) rank {r} holds {g['held_rows']} rows")
        per_step = {"kernel": {"multi_query_match": SHARDS},
                    "fused": {"multi_query_match": SHARDS,
                              "rank_select": SHARDS}}[m]
        want = {k: v * learn for k, v in per_step.items()}
        if any(o["launches"].get(k) != v for k, v in want.items()):
            fail("mesh", f"(a) {m}: one process launched {o['launches']}")
        got = mesh_launches(state, [g[m]["launches"] for g in two], want)
        dqn[m] = {"bit_identical": True, "learn_steps": learn,
                  "draws_compared": int(o["idx"].numel()),
                  "steps_per_s_ranks": [g[m]["steps_per_s"] for g in two],
                  "steps_per_s_one_process": o["steps_per_s"],
                  "launches_ranks": got}
    # (b), (c)
    cell = {}
    for m in MESH_CELL_MODES:
        want = one["cell"][m]["idx"].numpy()
        for r, got in enumerate(four):
            if not np.array_equal(got["cell"][m]["idx"], want):
                fail("mesh", f"(b) {m}: rank {r}'s draw != one process's")
        if not np.array_equal(nccl[m]["idx"], want):
            fail("mesh", f"(c) {m}: the NCCL world-1 draw != one process's")
        per_draw = {"multi_query_match": 16} if m == "kernel" else \
            {"multi_query_match": 16, "rank_select": 16}
        got = mesh_launches(state, [g["cell"][m]["launches_a_draw"]
                                    for g in four], per_draw)
        mesh_launches(state, [nccl[m]["launches_a_draw"]], per_draw)
        cell[m] = {"bit_identical": True, "launches_a_draw_ranks": got,
                   "draw_ms_median_ranks": [g["cell"][m]["draw_ms_median"]
                                            for g in four],
                   "draw_ms_range_ranks": [g["cell"][m]["draw_ms_range"]
                                           for g in four],
                   "draw_ms_median_one_process": one["cell"][m][
                       "draw_ms_median"],
                   "draw_ms_median_nccl_world_1": nccl[m]["draw_ms_median"]}
    # (d)
    want = one["moe"]["out"].numpy()
    moe = {"tol": MESH_MOE_TOL, "ms_one_process": one["moe"]["ms"],
           "ms_ranks": [g["moe"]["ms"] for g in four],
           "metrics": one["moe"]["metrics"]}
    for r, got in enumerate(four):
        out = got["moe"]["out"]
        err = float(np.abs(out - want).max())
        if not np.isfinite(out).all() or not np.allclose(
                out, want, atol=MESH_MOE_TOL, rtol=MESH_MOE_TOL):
            fail("mesh", f"(d) rank {r}'s MoE output off by {err}")
        for k, v in got["moe"]["metrics"].items():
            if not np.isclose(v, one["moe"]["metrics"][k],
                              atol=MESH_MOE_TOL, rtol=MESH_MOE_TOL):
                fail("mesh", f"(d) rank {r}'s {k} {v} != "
                     f"{one['moe']['metrics'][k]}")
        moe.setdefault("max_abs_err", []).append(err)
        moe.setdefault("bit_identical", []).append(
            bool(np.array_equal(out.view(np.int32), want.view(np.int32))))
    moe["drop_frac"] = one["moe"]["metrics"]["moe_drop_frac"]
    # (e)
    pod = {"n_params": one["pod"]["n_params"]}
    for c in ("compress=True", "compress=False"):
        for r, got in enumerate(two):
            g = got["pod"][c]
            if not g["finite"] or g["fingerprints"] != \
                    one["pod"][c]["fingerprints"]:
                fail("mesh", f"(e) {c}: rank {r}'s synced gradients != "
                     "one process's")
        pod[c] = {"bit_identical": True, "ms_one_process":
                  one["pod"][c]["ms"], "ms_ranks": [g["pod"][c]["ms"]
                                                    for g in two]}
    cfg = get_config(MESH_MOE_ARCH)
    emit({"phase": "mesh", "ok": True, "card": state["smi"],
          "backend": {"ranks": "gloo (CUDA tensors)", "nccl": "world 1"},
          "a_dqn": dqn, "b_cell": cell, "d_moe": {
              **moe, "d_model": cfg.d_model, "experts": cfg.n_experts,
              "top_k": cfg.moe_top_k, "tokens": list(MESH_MOE_TOKENS)},
          "e_pod_sync": pod, "spawn_s": {"2_ranks": two_s, "4_ranks": four_s},
          "phase_s": time.perf_counter() - t_phase})


# --- the auto-SPMD side of the mesh (phase ``spmd``) -------------------------
#
# DTensor programs under the sharding rules.  (a) and (b) spawn ranks that
# share the one card over gloo (as phase ``mesh``); (c) runs rank 0 of a fake
# group of 256 in this process.

SPMD_ARCH, SPMD_LAYERS = "stablelm-1.6b", 2
SPMD_RANKS = 2             # (a): a 1 x 2 ("data", "model") mesh
SPMD_TRAIN = (2, 256)      # (a): sequences, tokens of the train step
SPMD_SERVE = (2, 1024, 8)  # (a): prompts, prompt tokens, decode steps
SPMD_TOL = 1e-4            # (a): float32, max |err| / max |one process|
SPMD_MOE_RANKS = 4         # (b): a 2 x 2 mesh
SPMD_CELL = "prefill_32k"  # (c): stablelm-1.6b's serve cell, full depth
SPMD_PEAK_RATIO = 2.0      # (c): traced and measured peaks within 2x


def spmd_rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want| (float32)."""
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max().clamp(
        min=1e-30))


def spmd_serve(model, params, prompts, steps, tokens=None) -> tuple:
    """A prefill of ``prompts`` and ``steps`` decode steps: each step's
    logits [B, V] (whole), and the tokens fed (greedy on these logits
    unless ``tokens`` are given)."""
    from repro_torch.distributed import sharding as shd

    B, S = prompts.shape
    logits, cache = model.prefill(params, {"tokens": prompts}, S + steps)
    seen, fed = [], []
    for i in range(steps + 1):
        whole = logits.full_tensor() if shd.is_dtensor(logits) else logits
        seen.append(whole.reshape(B, -1))
        if i == steps:
            break
        tok = (tokens[i] if tokens is not None
               else whole.reshape(B, -1).argmax(-1, keepdim=True)
               .to(torch.int32))
        fed.append(tok)
        tok = shd.distribute(tok, ("batch", None))
        logits, cache = model.decode_step(params, tok, cache)
    return seen, fed


def spmd_ranks_dense(rank: int, world: int, dev) -> dict:
    """(a) on each rank, DTensor's all-gathers routed through c10d's
    (``launch.mesh.c10d_gathers``: the functional one kills a gloo rank
    holding CUDA tensors, ``tools/dist_probe.py``)."""
    from repro_torch.launch.mesh import c10d_gathers

    with c10d_gathers() as avoided:
        out = spmd_dense_checks(world, dev)
    out["avoided"] = [f"torch.distributed._functional_collectives.{n}"
                      for n in avoided]
    return out


def spmd_dense_checks(world: int, dev) -> dict:
    """(a) on each rank: stablelm-1.6b at full width, ``SPMD_LAYERS``
    layers, float32 (params and tokens from ``SEED`` on the card, the
    same on every rank), on a 1 x ``world`` mesh.  Under the training
    rules: the loss and every gradient of the sharded program against
    this rank's one-process unsharded run, and one sharded AdamW step
    keeping every leaf's placements.  Under the serve rules: a prefill
    and decode steps against the one-process greedy generate's logits,
    fed its tokens, with the flash and decode kernels' launches."""
    import dataclasses

    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.models.model_api import Model
    from repro_torch.models.qhead import tree_leaves
    from repro_torch.train import train_step as tts
    from repro_torch.train.optimizer import AdamW

    cfg = dataclasses.replace(get_config(SPMD_ARCH), n_layers=SPMD_LAYERS,
                              dtype="float32")
    model = Model.from_config(cfg)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = model.init_params(gen, dev)
    B, S = SPMD_TRAIN
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen,
                         device=dev, dtype=torch.int32)
    batch = {"tokens": toks[:, :-1].contiguous(),
             "targets": toks[:, 1:].contiguous(),
             "loss_mask": torch.ones((B, S), device=dev)}
    pb, ps, steps = SPMD_SERVE
    prompts = torch.randint(0, cfg.vocab_size, (pb, ps), generator=gen,
                            device=dev, dtype=torch.int32)
    mesh = make_process_mesh((1, world), ("data", "model"), backend="gloo",
                             device=dev)

    def grads(p, b):
        leaves = [t.detach().requires_grad_(True) for t in tree_leaves(p)]
        loss, _ = model.loss(tts._unflatten_like(p, leaves), b)
        return loss, torch.autograd.grad(loss, leaves)

    out = {}
    t0 = time.perf_counter()
    loss1, g1 = grads(params, batch)
    rules = shd.ShardingRules(mesh, shd.TRAIN_RULES)
    with shd.use_rules(rules), implicit_replication():
        loss, g = grads(shd.distribute_tree(params, model.param_axes()),
                        tts.shard_batch(batch, rules))
        g = [x.full_tensor() for x in g]
        loss = loss.full_tensor()
    out["tp"] = {"loss": float(loss), "loss_one": float(loss1),
                 "loss_err": abs(float(loss) - float(loss1))
                 / abs(float(loss1)),
                 "grad_err": max(spmd_rel_err(a, b) for a, b in zip(g, g1))}
    del g, g1
    opt = AdamW(1e-3)
    state = tts.TrainState(step=torch.zeros((), dtype=torch.int32,
                                            device=dev),
                           params=params, opt_state=opt.init(params))
    placed = tts.shard_train_state(state, model, opt, rules)
    before = [tuple(t.placements) for t in tree_leaves(placed)
              if t is not None]
    new, met = tts.make_sharded_train_step(model, opt, rules)(
        placed, tts.shard_batch(batch, rules))
    out["tp"]["kept_placements"] = before == [
        tuple(t.placements) for t in tree_leaves(new) if t is not None]
    out["tp"]["step_loss"] = float(met["loss"].full_tensor())
    del placed, new, state
    torch.cuda.synchronize()
    out["tp"]["s"] = time.perf_counter() - t0
    # serve: the one-process greedy generate, then the sharded run fed
    # its tokens
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device=dev).manual_seed(SEED),
                               dev)
    want, fed = spmd_serve(model, params, prompts, steps)
    rules = shd.ShardingRules(mesh, shd.SERVE_RULES)
    ops.reset_launches()
    with shd.use_rules(rules), implicit_replication():
        got, _ = spmd_serve(model, shd.distribute_tree(
            params, model.param_axes()), shd.distribute(
                prompts, ("batch", None)), steps, fed)
    torch.cuda.synchronize()
    out["serve"] = {"logit_err": max(spmd_rel_err(a, b)
                                     for a, b in zip(got, want)),
                    "finite": all(bool(torch.isfinite(a).all())
                                  for a in got),
                    "launches": {k: v for k, v in ops.launches.items() if v},
                    "s": time.perf_counter() - t0}
    return out


def spmd_moe_grads(mesh) -> dict:
    """(b) on the 2 x 2 ``mesh``: a deepseek-moe-16b MoE layer at full
    width (float32 weights, tokens and a loss weight from ``SEED``)
    through ``moe_apply`` under the training rules, forward and backward:
    fingerprints of the output, the metrics and every gradient (x, then
    the params in ``tree_leaves`` order), and ms."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import common
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.qhead import tree_leaves

    cfg = get_config(MESH_MOE_ARCH)
    dev = mesh.home
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = common.init_params(gen, moe_mod.moe_specs(cfg, None), dev)
    x = torch.randn(*MESH_MOE_TOKENS, cfg.d_model, generator=gen, device=dev)
    w = torch.randn(*MESH_MOE_TOKENS, cfg.d_model, generator=gen, device=dev)
    leaves = [t.requires_grad_(True) for t in [x] + tree_leaves(params)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with shd.use_rules(shd.ShardingRules(mesh, shd.TRAIN_RULES)):
        out, m = moe_mod.moe_apply(cfg, params, x)
        loss = ((out * w).sum() + 0.01 * m["moe_lb_loss"]
                + 1e-3 * m["moe_z_loss"])
        grads = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    return {"out": fingerprint(out), "finite": bool(torch.isfinite(
        out).all()) and all(bool(torch.isfinite(g).all()) for g in grads),
        "metrics": [fingerprint(v) for v in m.values()],
        "grads": [fingerprint(g) for g in grads],
        "ms": (time.perf_counter() - t0) * 1e3}


def spmd_ranks_moe(rank: int, world: int, dev) -> dict:
    """(b) on each rank of a 2 x 2 process mesh."""
    from repro_torch.launch.mesh import make_process_mesh

    return spmd_moe_grads(make_process_mesh(
        (2, 2), ("data", "model"), backend="gloo", device=dev))


def spmd_production_device() -> dict:
    """(c): stablelm-1.6b's ``SPMD_CELL`` under the serve rules as rank 0
    of a fake group of 256, at full depth: the dry run's trace on
    ``meta`` (arguments + temporaries a device), then the same program on
    zeros on the card (``dryrun._trace(..., device="cuda")``), its
    measured peak above the phase's baseline beside the traced one, the
    flash kernel's launches and its per-device shape, timed."""
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun

    prog, mesh, rules, cfg, _ = dryrun.lower_cell(SPMD_ARCH, SPMD_CELL,
                                                  False)
    traced = dryrun._trace(prog, cfg, (False, rules.rules))  # on meta
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ops.reset_launches()
    shapes = []
    wrap = ops._fa.flash_attention_cuda

    def seen(q, k, v, *a):
        shapes.append([tuple(q.shape), tuple(k.shape), str(q.dtype)])
        return wrap(q, k, v, *a)

    ops._fa.flash_attention_cuda = seen
    t0 = time.perf_counter()
    try:
        q = dryrun._trace(prog, cfg, (False, rules.rules), device="cuda")
    finally:
        ops._fa.flash_attention_cuda = wrap
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    measured = torch.cuda.max_memory_allocated() - base
    launches = {k: v for k, v in ops.launches.items() if v}
    peak = traced["peak_live_bytes"]
    ratio = max(measured, peak) / max(min(measured, peak), 1)
    if ratio > SPMD_PEAK_RATIO:
        fail("spmd", f"(c) traced peak {peak} B vs measured {measured} B: "
             f"{ratio:.2f}x")
    if launches.get("flash_attention") != cfg.n_layers:
        fail("spmd", f"(c) flash launched {launches}, want {cfg.n_layers}")
    qs, ks, dt = shapes[0]
    dtype = getattr(torch, dt.split(".")[-1])
    qq, kk, vv = (torch.randn(sh, device="cuda", dtype=dtype)
                  for sh in (qs, ks, ks))
    ms = device_time_ms(lambda: ops._fa.flash_attention_cuda(
        qq, kk, vv, True, None, None), calls=10, reps=3)
    return {"cell": SPMD_CELL, "ranks": 256, "layers": cfg.n_layers,
            "argument_bytes_per_dev": traced["argument_bytes"],
            "temp_bytes_per_dev": peak - traced["argument_bytes"],
            "traced_peak_bytes": peak, "measured_peak_bytes": measured,
            "card_run_live_peak_bytes": q["peak_live_bytes"],
            "ratio": ratio, "launches": launches,
            "collectives": traced["coll_counts"],
            "flash_per_device": {"q": qs, "k": ks, "dtype": dt, "ms": ms},
            "run_s": run_s}


def phase_spmd(state: dict) -> None:
    """The sharding rules as DTensor programs: (a) stablelm-1.6b under the
    training and serve rules on 2 ranks against one process, the flash
    and decode kernels launched on each rank's heads; (b) a full-width
    deepseek-moe-16b MoE layer trained through the shard-map dispatch on
    4 ranks, output and every gradient bit for bit against the
    single-process 2 x 2 mesh; (c) one production device's program on
    the card (``spmd_production_device``)."""
    from repro_torch.distributed.sharding import Mesh
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import run_ranks

    build.build_all()
    cuda = torch.device("cuda")
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    dense = run_ranks(spmd_ranks_dense, SPMD_RANKS, backend="gloo",
                      device="cuda", timeout=MESH_RANK_TIMEOUT)
    dense_s = time.perf_counter() - t0
    pb, ps, steps = SPMD_SERVE
    want = {"flash_attention": SPMD_LAYERS,
            "decode_attention": SPMD_LAYERS * steps}
    for r, got in enumerate(dense):
        tp, sv = got["tp"], got["serve"]
        if tp["loss_err"] > SPMD_TOL or tp["grad_err"] > SPMD_TOL:
            fail("spmd", f"(a) rank {r}: tp loss err {tp['loss_err']}, "
                 f"grad err {tp['grad_err']} > {SPMD_TOL}")
        if not tp["kept_placements"]:
            fail("spmd", f"(a) rank {r}: the train step moved a leaf")
        if not sv["finite"] or sv["logit_err"] > SPMD_TOL:
            fail("spmd", f"(a) rank {r}: serve logits err {sv['logit_err']}")
        if sv["launches"] != want:
            fail("spmd", f"(a) rank {r} launched {sv['launches']}, "
                 f"want {want}")
    add_launches(state, {k: v * SPMD_RANKS for k, v in want.items()})
    t0 = time.perf_counter()
    one = spmd_moe_grads(Mesh(np.full((2, 2), cuda, dtype=object),
                              ("data", "model")))
    torch.cuda.empty_cache()
    four = run_ranks(spmd_ranks_moe, SPMD_MOE_RANKS, backend="gloo",
                     device="cuda", timeout=MESH_RANK_TIMEOUT)
    moe_s = time.perf_counter() - t0
    if not one["finite"]:
        fail("spmd", "(b) one process's MoE output or gradients not finite")
    for r, got in enumerate(four):
        for k in ("out", "metrics", "grads"):
            if got[k] != one[k]:
                fail("spmd", f"(b) rank {r}'s {k} != one process's")
    prod = spmd_production_device()
    add_launches(state, prod["launches"])
    emit({"phase": "spmd", "ok": True, "card": state["smi"],
          "backend": "gloo (CUDA tensors)",
          "a_dense": {"arch": SPMD_ARCH, "layers": SPMD_LAYERS,
                      "dtype": "float32", "mesh": [1, SPMD_RANKS],
                      "avoided": {"collectives": dense[0]["avoided"],
                                  "why": "segfaults a gloo rank with CUDA "
                                         "tensors (tools/dist_probe.py); "
                                         "c10d all_gather_into_tensor "
                                         "in its place"},
                      "train": list(SPMD_TRAIN), "serve": list(SPMD_SERVE),
                      "tol": SPMD_TOL, "ranks": dense, "spawn_s": dense_s},
          "b_moe": {"arch": MESH_MOE_ARCH, "tokens": list(MESH_MOE_TOKENS),
                    "mesh": [2, 2], "bit_identical": True,
                    "grads_compared": len(one["grads"]),
                    "ms_one_process": one["ms"],
                    "ms_ranks": [g["ms"] for g in four], "s": moe_s},
          "c_production_device": prod,
          "phase_s": time.perf_counter() - t_phase})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--profile", action="store_true",
                    help="after each training phase, trace 20 more steps "
                         "with torch.profiler, and 8 decode steps after "
                         "the serve phase")
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
    sweep = LmSweep() if "dryrun" in phases else None
    try:
        return run_phases(phases, args, sweep)
    finally:
        if sweep is not None:
            sweep.stop()


def timed(name: str, fn, *args, **kw):
    """``fn(*args, **kw)``, then a line with the seconds it took."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    emit({"phase_seconds": name, "s": round(time.perf_counter() - t0, 2)})
    return out


def timed_call(fn, *args, **kw):
    """:func:`timed` under the phase's name: a ``train_phase`` by its
    second argument, any other by its function name."""
    name = args[1] if fn is train_phase else fn.__name__.removeprefix(
        "phase_")
    return timed(name, fn, *args, **kw)


def run_phases(phases, args, sweep: LmSweep | None) -> int:
    """Run the named phases in order and print the closing lines; the LM
    sweep (for ``dryrun``) runs beside the kernel phases."""
    state = {"smi": nvidia_smi_line(), "kernels": {}, "launches": {}}
    for name, fn in (("device", phase_device), ("match", phase_match),
                     ("sample", phase_sample), ("rank", phase_rank),
                     ("graph", phase_graph), ("prng", phase_prng),
                     ("tcam", phase_tcam),
                     ("flash", phase_flash),
                     ("decode", phase_decode)):
        if name in phases:
            timed(name, fn, state)
        if name == "device" and sweep is not None:
            sweep.start()
    if sweep is not None:
        timed("dryrun_sweep_wait", sweep.wait)
    trace_dir = args.trace_dir if args.profile else None
    if "fused" in phases:
        timed_call(train_phase, state, "fused", 500, {"amper_sample": 1},
                   trace_dir, sampler="amper-fr", amper_fr_mode="fused")
    if "kernel" in phases:
        timed_call(train_phase, state, "kernel", 150,
                   {"multi_query_match": 1}, trace_dir, sampler="amper-fr",
                   amper_fr_mode="kernel")
    if "sharded" in phases:
        from repro_torch.distributed.sharding import Mesh

        mesh = Mesh([torch.device("cuda", 0)] * SHARDS)
        timed_call(train_phase, state, "sharded", 400,
                   {"multi_query_match": SHARDS, "rank_select": SHARDS},
                   trace_dir, mesh=mesh, sampler="amper-fr-sharded",
                   amper_fr_mode="fused")
        timed_call(per_sharded_run, mesh)
    if "mesh" in phases:
        timed_call(phase_mesh, state)
    if "spmd" in phases:
        timed_call(phase_spmd, state)
    if "fig9" in phases:
        timed_call(phase_fig9, state)
    if "launch_budget" in phases:
        timed_call(phase_launch_budget, state)
    if "analysis" in phases:
        timed_call(phase_analysis, state)
    if "examples" in phases:
        timed_call(phase_examples, state)
    if "table1" in phases:
        timed_call(phase_table1, state)
    if "pixel" in phases:
        timed_call(phase_pixel, state, trace_dir)
    if "resume" in phases:
        timed_call(phase_resume, state)
    if "runtime" in phases:
        timed_call(phase_runtime, state)
    if "runtime_split" in phases:
        timed_call(phase_runtime_split, state)
    if "serve" in phases:
        timed_call(phase_serve, state, trace_dir)
    if "lm_train" in phases:
        timed_call(phase_lm_train, state)
    if "lm_zoo" in phases:
        timed_call(phase_lm_zoo, state)
    if "lm_families" in phases:
        timed_call(phase_lm_families, state)
    if "dryrun" in phases:
        timed_call(phase_dryrun, state, sweep)
    emit({"phase": "profiler", "ok": True, "sessions_a_reading":
          PROFILER_SESSIONS, "retaken": PROFILER_RETAKES})
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
