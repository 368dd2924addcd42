"""float32 arithmetic as XLA compiles the reference on the CPU.

The JAX reference runs jitted, and XLA's CPU compiler rewrites two float
patterns that torch evaluates as written:

* a multiply feeding an add becomes one fused multiply-add, rounded once;
* a division by a compile-time constant becomes a multiplication by the
  constant's float32 reciprocal, and constants next to each other fold
  into one float32 constant.

Where the port must match the reference bit for bit (the uniform draw,
the group representatives, the exploration schedule), it spells these
out with the helpers below; each use is checked against jitted jax in
the tests.
"""
from __future__ import annotations

import torch


def fma32(a: torch.Tensor, b: torch.Tensor, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once.

    The float32 product is exact in float64, so one float64 add and one
    rounding to float32 reproduce the fused multiply-add (a mismatch
    needs the float64 sum to land exactly on a float32 tie).
    """
    c = torch.as_tensor(c, dtype=torch.float32)
    return (a.double() * b.double() + c.double()).float()


def div_const(x: torch.Tensor, c: float) -> torch.Tensor:
    """float32 ``x / c`` for a constant ``c``, as ``x * float32(1 / c)``."""
    return x * torch.tensor(1.0 / c, dtype=torch.float32, device=x.device)
