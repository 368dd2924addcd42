"""The trace rules: RECOMPILE and DTYPE-WIDE, by recording aten ops.

Counterpart of ``repro/analysis/jaxpr_lint.py``'s RECOMPILE and
DTYPE-WIDE rules (its DISPATCH-BUDGET rule is
:mod:`repro_torch.analysis.launches`).  The port has no jaxpr: a
``TorchDispatchMode`` (:class:`OpRecorder`) records each aten op a call
dispatches, with its non-tensor arguments and the dtype and shape of
its tensor arguments and outputs, and that record stands in for the
jaxpr.

* ``RECOMPILE`` — the slab-prefetch draw must be *one* program across
  draws: evolving buffer contents, annealed beta values and advancing
  keys are data, not signature.  A call's signature is its recorded op
  sequence, so a Python scalar threaded into an op, a dtype flip or a
  shape change makes a new one, and a CUDA graph captured from one call
  could not be replayed for the next: it would be captured again (the
  reference's jit would retrace).  CPU half (:func:`check_recompile`):
  ``runtime/pipeline.py::make_slab_sampler`` driven as the reference's
  check drives its own; the annealed-beta calls share one signature and
  the beta=None calls add at most one more.  Card half
  (:func:`check_recapture`): the trainer's :class:`~repro_torch.rl.dqn.
  DQN` runner over a run whose steady steps see new keys, beta values
  and buffer contents captures its step once, and a second ``advance``
  on the same runner captures nothing more.  Without CUDA that half
  returns its reason as a skip, never a pass.
* ``DTYPE-WIDE`` — ``sample`` and ``update`` of the four registry
  samplers, run on the CPU: any float64 or complex128 op output, and any
  public output or state leaf wider than the reference's
  (:data:`REFERENCE_DTYPES`).  Not flagged: int64 inside a call, which
  is PyTorch's index dtype and the carrier of the port's uint32
  arithmetic (``core/amper.py``, ``prng.py``); and float64 produced
  under ``repro_torch/xla_float.py``, whose helpers reproduce XLA's
  float32 fused multiply-add and ``powf`` bit for bit through a float64
  intermediate and return float32 (their count is reported apart, see
  :func:`check_dtype_promotion`).  Weak types have no PyTorch
  counterpart, so the reference's weak-output half has none.

A host value turned into a tensor inside the call (``torch.tensor``,
``torch.as_tensor``: the host key path derives its keys so) is data to
the recorder, as an array constant is to jax's trace cache: its op is in
the signature, its value is not.
"""
from __future__ import annotations

import os
import sys
from collections import Counter

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.analysis.findings import Finding

_WIDE = (torch.float64, torch.complex128)
# float64 made under this file is the bit-exact emulation of XLA's float32
# arithmetic (module docstring), not a leak
_EXEMPT_FILE = os.path.join("repro_torch", "xla_float.py")
_ANALYSIS = os.path.join("repro_torch", "analysis") + os.sep

# The reference's dtype of each public output and state leaf of a
# registry sampler (repro/core/{per,amper}.py), by leaf name.
REFERENCE_DTYPES = {
    "indices": torch.int32,      # sample
    "weights": torch.float32,    # the IS weights of the drawn rows
    "total": torch.float32,
    "priorities": torch.float32,  # CumsumState.priorities, .priorities()
    "tree": torch.float32,       # SumTreeState
    "n_leaves": torch.int32,
    "pq": torch.int32,           # AmperState
    "valid": torch.bool,
}


def _describe(x):
    if isinstance(x, torch.Tensor):
        return (str(x.dtype), tuple(x.shape))
    if isinstance(x, (torch.dtype, torch.device, torch.layout,
                      torch.memory_format)):
        return str(x)
    return repr(x)


class OpRecorder(TorchDispatchMode):
    """Records every aten op dispatched while active: ``ops`` holds
    ``(name, arguments, outputs)`` per op (tensors as dtype and shape,
    other arguments by ``repr``); ``wide`` the float64 / complex128
    outputs outside ``xla_float.py`` as ``(op, dtype)`` counts, and
    ``exempt`` the count of those under it."""

    def __init__(self):
        super().__init__()
        self.ops: list[tuple] = []
        self.wide: Counter = Counter()
        self.exempt = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        flat_out = [o for o in tree_flatten(out)[0]
                    if isinstance(o, torch.Tensor)]
        self.ops.append((
            str(func), tuple(_describe(a) for a in tree_flatten(
                (args, kwargs))[0]),
            tuple(_describe(o) for o in flat_out)))
        for o in flat_out:
            if o.dtype in _WIDE:
                if _under_exempt_file():
                    self.exempt += 1
                else:
                    self.wide[(str(func), str(o.dtype))] += 1
        return out

    def signature(self) -> tuple:
        return tuple(self.ops)


def _under_exempt_file() -> bool:
    """Is the innermost frame of the port (outside ``analysis/``) on the
    stack in ``xla_float.py``?"""
    package = os.sep + "repro_torch" + os.sep
    f = sys._getframe(2)
    while f is not None:
        name = f.f_code.co_filename
        if package in name and _ANALYSIS not in name:
            return name.endswith(_EXEMPT_FILE)
        f = f.f_back
    return False


def record(fn, *args):
    """``(fn(*args), recorder)``."""
    rec = OpRecorder()
    with rec:
        out = fn(*args)
    return out, rec


def distinct_signatures(fn, calls) -> int:
    """Call ``fn`` on every argument tuple in ``calls``; the number of
    distinct recorded signatures (the reference's jit cache entries)."""
    return len({record(fn, *args)[1].signature() for args in calls})


# --------------------------------------------------------------------- #
# RECOMPILE
# --------------------------------------------------------------------- #

def _slab_calls():
    """The reference check's set-up on the port: a 128-row AMPER-fr
    buffer half filled, the slab draw (batch 8, slab 2), three states
    (filled, after ``add_batch``, after ``update_priorities``), keys from
    ``runtime.prng.sample_key`` and beta at 0.4 + 0.1 d; returns the draw,
    the annealed calls and the beta=None calls."""
    from repro_torch import prng
    from repro_torch.core.replay_buffer import ReplayBuffer
    from repro_torch.core.samplers import make_sampler
    from repro_torch.runtime.pipeline import make_slab_sampler
    from repro_torch.runtime.prng import sample_key

    capacity, batch, slab = 128, 8, 2
    rb = ReplayBuffer(capacity, make_sampler("amper-fr", capacity,
                                             device="cpu"))
    tr = {"obs": torch.zeros(4), "action": torch.tensor(0, dtype=torch.int32),
          "reward": torch.tensor(0.0), "next_obs": torch.zeros(4),
          "done": torch.tensor(0.0)}
    state = rb.init(tr)
    fill = {k: v.expand((capacity // 2,) + tuple(v.shape)).clone()
            for k, v in tr.items()}
    state = rb.add_batch(state, fill)
    sample = make_slab_sampler(rb, batch, slab)
    key = prng.key(0)
    states = [state, rb.add_batch(state, fill),
              rb.update_priorities(state, torch.arange(8),
                                   torch.linspace(0.1, 1.0, 8))]
    calls = [(s, sample_key(key, d),
              torch.tensor(0.4 + 0.1 * d, dtype=torch.float32))
             for d, s in enumerate(states)]
    none_calls = [(states[0], sample_key(key, 7), None),
                  (states[1], sample_key(key, 8), None)]
    return sample, calls, none_calls


def check_recompile() -> list[Finding]:
    """RECOMPILE's CPU half: one signature for the annealed-beta slab
    draws, two at most with the beta=None draws."""
    sample, calls, none_calls = _slab_calls()
    findings = []
    n = distinct_signatures(sample, calls)
    if n != 1:
        findings.append(Finding(
            rule="RECOMPILE", path="<trace:slab-prefetch>", line=0,
            message=f"slab draw changed its op signature across draws: {n} "
                    f"signatures for {len(calls)} identical-signature calls "
                    f"(a Python scalar, dtype or shape that follows the data "
                    f"in the call: a captured graph could not be replayed)"))
    # beta=None is a second intended signature: one more, not one a call
    n2 = distinct_signatures(sample, calls + none_calls)
    if n2 > 2:
        findings.append(Finding(
            rule="RECOMPILE", path="<trace:slab-prefetch>", line=0,
            message=f"constant-beta slab draw changed its op signature: {n2} "
                    f"signatures (expected 2: one annealed-beta, one "
                    f"beta=None)"))
    return findings


RECAPTURE_ROWS = 8192


def check_recapture(steps: int = 40) -> tuple[list[Finding], dict,
                                               str | None]:
    """RECOMPILE's card half: ``(findings, counts, skipped)``.  The
    trainer's runner (CartPole, AMPER-fr fused, beta annealed over the
    run, so every steady step sees a new key, beta and buffer) advanced
    to half the run and then to its end: one capture in all, the second
    ``advance`` replaying it.  ``counts``: the runner's captures, graph
    replays and eager steps after each ``advance``.  ``skipped`` is the
    reason the check could not run (None when it ran)."""
    if not torch.cuda.is_available():
        return [], {}, ("CUDA is not available: the card half counts CUDA "
                        "graph captures")
    from repro_torch import prng
    from repro_torch.rl.dqn import DQNConfig, make_dqn

    cfg = DQNConfig(env="cartpole", sampler="amper-fr",
                    amper_fr_mode="fused", num_envs=16,
                    replay_size=RECAPTURE_ROWS, batch=64, hidden=128,
                    learn_start=8, target_sync=1000, beta_end=1.0,
                    beta_anneal_steps=steps)
    dqn = make_dqn(cfg, device="cuda")
    key = prng.key(0)
    runner = dqn.runner(dqn.init(key), key, steps)
    counts = {}
    for stop in (steps // 2, steps):
        runner.advance(stop)
        counts[f"after advance({stop})"] = {
            k: runner.info[k] for k in ("captures", "graph_replays",
                                        "eager_steps")}
    findings = []
    caps = runner.info["captures"]
    if caps != 1 or runner.info["graph_replays"] == 0:
        findings.append(Finding(
            rule="RECOMPILE", path="<graph:captured-agent-step>", line=0,
            message=f"the trainer's runner captured its steady step {caps} "
                    f"time(s) and replayed it {runner.info['graph_replays']} "
                    f"time(s) over two advances (expected one capture, "
                    f"replayed at every later steady step)"))
    return findings, counts, None


# --------------------------------------------------------------------- #
# DTYPE-WIDE
# --------------------------------------------------------------------- #

def scan_dtypes(rec: OpRecorder, label: str) -> list[Finding]:
    """A finding for each float64 / complex128 op output ``rec`` saw
    (outside ``xla_float.py``), one per (op, dtype)."""
    return [Finding(rule="DTYPE-WIDE", path=f"<trace:{label}>", line=0,
                    message=f"{op} produces {dt} inside {label}: 64-bit "
                            f"float on the hot path")
            for (op, dt) in sorted(rec.wide)]


def check_leaves(leaves: dict, label: str) -> list[Finding]:
    """A finding for each public output or state leaf (``{name:
    tensor}``) wider than :data:`REFERENCE_DTYPES` holds, or not in it."""
    findings = []
    for name, x in leaves.items():
        want = REFERENCE_DTYPES.get(name)
        if want is None:
            findings.append(Finding(
                rule="DTYPE-WIDE", path=f"<trace:{label}>", line=0,
                message=f"leaf '{name}' ({x.dtype}) of {label} has no "
                        f"reference dtype in REFERENCE_DTYPES"))
        elif x.dtype.itemsize > want.itemsize or (
                x.dtype.is_floating_point != want.is_floating_point):
            findings.append(Finding(
                rule="DTYPE-WIDE", path=f"<trace:{label}>", line=0,
                message=f"leaf '{name}' of {label} is {x.dtype}, wider "
                        f"than the reference's {want}"))
    return findings


def _leaves(state) -> dict:
    if isinstance(state, torch.Tensor):
        return {"state": state}
    return {name: getattr(state, name) for name in state._fields}


def check_dtype_promotion(
        kinds=("per-cumsum", "per-sumtree", "amper-fr", "amper-k"),
        capacity: int = 256, batch: int = 16,
        exempt: dict | None = None) -> list[Finding]:
    """Run every named registry sampler's ``sample`` (and the IS weights
    of its draw) and ``update`` on the CPU under the recorder; flag
    64-bit float op outputs and wide public leaves.  ``exempt``, when
    given, receives the count of float64 outputs under ``xla_float.py``
    per label."""
    from repro_torch import prng
    from repro_torch.core.per import importance_from_selected
    from repro_torch.core.samplers import make_sampler

    findings = []
    key = prng.key(0)
    for i, kind in enumerate(kinds):
        sampler = make_sampler(kind, capacity, device="cpu")
        state = sampler.update(
            sampler.init(), torch.arange(capacity),
            prng.uniform(prng.fold_in(key, i), (capacity,)) + 0.01)
        idx = torch.arange(batch, dtype=torch.int32)
        prio = torch.linspace(0.1, 1.0, batch)

        def draw(s=state, sm=sampler):
            rows = sm.sample(s, key, batch)
            p = sm.priorities(s)
            total = sm.total(s)
            w = importance_from_selected(p[rows.long()], total, capacity,
                                         0.4)
            return {"indices": rows, "weights": w, "total": total,
                    "priorities": p}

        outs, rec_s = record(draw)
        new_state, rec_u = record(sampler.update, state, idx, prio)
        for label, rec, leaves in (
                (f"{kind}.sample", rec_s, outs),
                (f"{kind}.update", rec_u, _leaves(new_state))):
            findings.extend(scan_dtypes(rec, label))
            findings.extend(check_leaves(leaves, label))
            if exempt is not None:
                exempt[label] = rec.exempt
    return findings


def run_trace_checks(exempt: dict | None = None,
                     recapture: dict | None = None) -> list[Finding]:
    """Both rules (the CLI's ``--no-trace`` skips these).  RECOMPILE's
    card half runs where CUDA is; ``recapture``, when given, receives its
    counts, or its skip reason under ``"skipped"``."""
    findings = check_recompile() + check_dtype_promotion(exempt=exempt)
    got, counts, skipped = check_recapture()
    findings += got
    if recapture is not None:
        recapture.update(counts if skipped is None else {"skipped": skipped})
    return findings
