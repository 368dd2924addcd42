"""PyTorch/CUDA port of the AMPER replay system (the ``repro`` package).

Mirrors ``repro``'s module names: ``repro_torch.core.amper`` is held
against ``repro.core.amper`` and so on.  The port imports torch only;
the kernels of the replay draw and of LM serving's attention are
hand-written CUDA for Hopper (``kernels/csrc``), built with nvcc at
first use.

Entry points take a ``device`` that defaults to ``"cuda"`` and raise if
CUDA is absent; pass ``device="cpu"`` to run on the CPU, where every
kernel wrapper takes its plain PyTorch version.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device(device)``, refusing CUDA when no card is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
