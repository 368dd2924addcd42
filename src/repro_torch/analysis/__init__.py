"""Analysis tools of the port (``python -m repro_torch.analysis``).

Counterpart of ``repro/analysis``, on one findings model
(:mod:`repro_torch.analysis.findings`, a copy of the reference's):

* :mod:`repro_torch.analysis.lint` — AST lint over source text (PRNG key
  reuse, wall-clock duration math, host syncs and tensor branches in a
  body a CUDA graph captures);
* :mod:`repro_torch.analysis.trace_lint` — the trace rules, over aten
  ops recorded by a ``TorchDispatchMode``: RECOMPILE (the slab draw one
  op signature across draws; the trainer's step captured once on a
  card) and DTYPE-WIDE (64-bit floats and wide leaves in the samplers);
* :mod:`repro_torch.analysis.launches` — the launch budget: CUDA kernel
  launches of one fused draw and of one captured agent step, counted on
  the card (the reference's DISPATCH-BUDGET rule);
* :mod:`repro_torch.analysis.locks` — lockdep: the lock-order recorder
  the runtime instruments, cycle findings, and the offline check of a
  JSONL acquisition log;
* :mod:`repro_torch.analysis.deadcode` — the dead-module report over
  ``repro_torch``.

Import cost matters: the runtime imports
:mod:`repro_torch.analysis.locks`, so this ``__init__`` imports only the
findings model (the other layers load lazily, from the CLI).
"""
from repro_torch.analysis.findings import Baseline, Finding  # noqa: F401

# Every rule the port's layers can emit; the Prometheus output shows each
# at 0 on a clean run.  Not here: the reference's DONATED-USE (PyTorch
# has no buffer donation, so no call invalidates its argument) and its
# weak-type half of DTYPE-WIDE (PyTorch has no weak types).  DTYPE-WIDE
# does not flag int64 inside a call: it is PyTorch's index dtype and the
# carrier of the port's uint32 arithmetic.
ALL_RULES = (
    "PRNG-REUSE",
    "WALL-CLOCK",
    "HOST-SYNC",
    "TRACED-BRANCH",
    "PARSE-ERROR",
    "DISPATCH-BUDGET",
    "RECOMPILE",
    "DTYPE-WIDE",
    "LOCK-ORDER",
)
