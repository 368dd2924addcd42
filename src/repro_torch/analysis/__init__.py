"""Analysis tools of the port (``python -m repro_torch.analysis``).

Counterpart of ``repro/analysis``, its torch-meaningful half, on one
findings model (:mod:`repro_torch.analysis.findings`, a copy of the
reference's):

* :mod:`repro_torch.analysis.locks` — lockdep: the lock-order recorder
  the runtime instruments, cycle findings, and the offline check of a
  JSONL acquisition log;
* :mod:`repro_torch.analysis.launches` — the launch budget: CUDA kernel
  launches of one fused draw and of one captured agent step, counted by
  torch.profiler on the card (the counterpart of the reference's
  jaxpr DISPATCH-BUDGET rule);
* :mod:`repro_torch.analysis.deadcode` — the dead-module report over
  ``repro_torch``.

The reference's AST lint and its RECOMPILE and DTYPE-WIDE trace rules
have no port yet.  Import cost matters: the runtime imports
:mod:`repro_torch.analysis.locks`, so this ``__init__`` imports only the
findings model (the other layers load lazily, from the CLI).
"""
from repro_torch.analysis.findings import Baseline, Finding  # noqa: F401

# Every rule the port's layers can emit.
ALL_RULES = (
    "DISPATCH-BUDGET",
    "LOCK-ORDER",
)
