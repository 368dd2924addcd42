"""Fixed-point priority quantization and TCAM prefix-mask generation.

Counterpart of ``repro/core/quantize.py``, bit for bit.  Priorities in
``[0, v_max]`` map to non-negative int32 fixed point with ``frac_bits``
fraction bits relative to ``v_max`` (the paper's INT-32 TCAM rows), and
a radius ``delta`` becomes the don't-care mask of Fig. 6(b2): bit ``p``
of delta's leading one and every bit below it.
"""
from __future__ import annotations

import torch

DEFAULT_FRAC_BITS = 24

# 2^0 .. 2^30: every positive int32 has its leading one at one of these.
_POW2 = tuple(1 << b for b in range(31))


def quantize(p: torch.Tensor, v_max: float,
             frac_bits: int = DEFAULT_FRAC_BITS) -> torch.Tensor:
    """Map float32 priorities in [0, v_max] to int32 fixed point.

    The top code is ``2**frac_bits - 1`` (all ones), so a saturated
    priority stays inside the largest prefix-aligned block below the
    range ceiling.  ``torch.round`` rounds half to even, as ``jnp.round``.
    """
    top = (1 << frac_bits) - 1
    scale = top / v_max
    q = torch.round(torch.clamp(p.to(torch.float32), 0.0, v_max) * scale)
    return torch.clamp(q, max=float(top)).to(torch.int32)


def dequantize(q: torch.Tensor, v_max: float,
               frac_bits: int = DEFAULT_FRAC_BITS) -> torch.Tensor:
    """Inverse of :func:`quantize` (up to rounding)."""
    scale = v_max / ((1 << frac_bits) - 1)
    return q.to(torch.float32) * scale


def prefix_mask(delta: torch.Tensor) -> torch.Tensor:
    """Don't-care mask for radius ``delta`` (int32), per Fig. 6(b2).

    torch has no count-leading-zeros, so the leading-one position is the
    number of powers of two at or below ``delta``, minus one, counted
    exactly in int64.  ``delta <= 0`` gives mask 0 (exact match).
    """
    d = delta.to(torch.int64)
    pow2 = torch.tensor(_POW2, dtype=torch.int64, device=d.device)
    p_pos = (d.clamp(min=0).unsqueeze(-1) >= pow2).sum(-1) - 1
    shifted = torch.where(p_pos >= 31, torch.full_like(d, -1),
                          (torch.ones_like(d) << (p_pos + 1)) - 1)
    return torch.where(d <= 0, torch.zeros_like(d), shifted).to(torch.int32)


def ternary_match(stored: torch.Tensor, query: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """Exact-match TCAM semantics with don't-care bits (broadcasting)."""
    return torch.bitwise_and(torch.bitwise_xor(stored, query),
                             torch.bitwise_not(mask)) == 0


def prefix_range(query: torch.Tensor, mask: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Inclusive int32 range ``[q & ~M, (q & ~M) | M]`` of a prefix query."""
    lo = torch.bitwise_and(query, torch.bitwise_not(mask))
    return lo, torch.bitwise_or(lo, mask)
