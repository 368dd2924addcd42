"""float32 arithmetic as XLA compiles the reference on the CPU.

The JAX reference runs jitted, and XLA's CPU compiler rewrites two float
patterns that torch evaluates as written:

* a multiply feeding an add becomes one fused multiply-add, rounded once;
* a division by a compile-time constant becomes a multiplication by the
  constant's float32 reciprocal, and constants next to each other fold
  into one float32 constant;
* a float32 power ``x ** y`` calls the C library's ``powf`` (glibc's,
  the algorithm of ARM's optimized-routines), whose float64 polynomials
  are accurate to about 2^-26, so about one result in 1,700 lies one ulp
  from the correctly rounded power that torch's vectorized ``pow``
  comes closer to; and a subnormal input reads as zero (XLA runs with
  denormals-are-zero).

Where the port must match the reference bit for bit (the uniform draw,
the group representatives, the exploration schedule, the LM replay's
priorities), it spells these out with the helpers below; each use is
checked against jitted jax in the tests.
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
    """float32 ``x / c`` for a constant ``c``, as ``x * float32(1 / c)``
    (the factor a 0-d host tensor, which a CUDA op takes as a scalar
    argument: no copy to the card, so a CUDA graph can capture it)."""
    return x * torch.tensor(1.0 / c, dtype=torch.float32)


# powf's tables (glibc ``e_powf_log2_data.c``, ``e_exp2f_data.c``): log2
# of x = 2^k z (z near 1) from 16 (1/c, log2 c) pairs and a degree-5
# polynomial in r = z/c - 1; 2^(y log2 x) from the 32 doubles 2^(j/32)
# and a cubic in the remainder.
_LOG2_TABLE = [(float.fromhex(a), float.fromhex(b)) for a, b in (
    ("0x1.661ec79f8f3bep+0", "-0x1.efec65b963019p-2"),
    ("0x1.571ed4aaf883dp+0", "-0x1.b0b6832d4fca4p-2"),
    ("0x1.49539f0f010b0p+0", "-0x1.7418b0a1fb77bp-2"),
    ("0x1.3c995b0b80385p+0", "-0x1.39de91a6dcf7bp-2"),
    ("0x1.30d190c8864a5p+0", "-0x1.01d9bf3f2b631p-2"),
    ("0x1.25e227b0b8ea0p+0", "-0x1.97c1d1b3b7af0p-3"),
    ("0x1.1bb4a4a1a343fp+0", "-0x1.2f9e393af3c9fp-3"),
    ("0x1.12358f08ae5bap+0", "-0x1.960cbbf788d5cp-4"),
    ("0x1.0953f419900a7p+0", "-0x1.a6f9db6475fcep-5"),
    ("0x1.0000000000000p+0", "0x0.0p+0"),
    ("0x1.e608cfd9a47acp-1", "0x1.338ca9f24f53dp-4"),
    ("0x1.ca4b31f026aa0p-1", "0x1.476a9543891bap-3"),
    ("0x1.b2036576afce6p-1", "0x1.e840b4ac4e4d2p-3"),
    ("0x1.9c2d163a1aa2dp-1", "0x1.40645f0c6651cp-2"),
    ("0x1.886e6037841edp-1", "0x1.88e9c2c1b9ff8p-2"),
    ("0x1.767dcf5534862p-1", "0x1.ce0a44eb17bccp-2"))]
_LOG2_POLY = [float.fromhex(a) for a in (
    "0x1.27616c9496e0bp-2", "-0x1.71969a075c67ap-2", "0x1.ec70a6ca7baddp-2",
    "-0x1.7154748bef6c8p-1", "0x1.71547652ab82bp+0")]
_EXP2_TABLE = [float.fromhex(a) for a in (
    "0x1.0000000000000p+0", "0x1.059b0d3158574p+0", "0x1.0b5586cf9890fp+0",
    "0x1.11301d0125b51p+0", "0x1.172b83c7d517bp+0", "0x1.1d4873168b9aap+0",
    "0x1.2387a6e756238p+0", "0x1.29e9df51fdee1p+0", "0x1.306fe0a31b715p+0",
    "0x1.371a7373aa9cbp+0", "0x1.3dea64c123422p+0", "0x1.44e086061892dp+0",
    "0x1.4bfdad5362a27p+0", "0x1.5342b569d4f82p+0", "0x1.5ab07dd485429p+0",
    "0x1.6247eb03a5585p+0", "0x1.6a09e667f3bcdp+0", "0x1.71f75e8ec5f74p+0",
    "0x1.7a11473eb0187p+0", "0x1.82589994cce13p+0", "0x1.8ace5422aa0dbp+0",
    "0x1.93737b0cdc5e5p+0", "0x1.9c49182a3f090p+0", "0x1.a5503b23e255dp+0",
    "0x1.ae89f995ad3adp+0", "0x1.b7f76f2fb5e47p+0", "0x1.c199bdd85529cp+0",
    "0x1.cb720dcef9069p+0", "0x1.d5818dcfba487p+0", "0x1.dfc97337b9b5fp+0",
    "0x1.ea4afa2a490dap+0", "0x1.f50765b6e4540p+0")]
_EXP2_POLY = [float.fromhex(a) for a in (
    "0x1.c6af84b912394p-5", "0x1.ebfce50fac4f3p-3", "0x1.62e42ff0c52d6p-1")]
_EXP2_SHIFT = float.fromhex("0x1.8p+47")     # rounds to a multiple of 1/32
_OVERFLOW = float.fromhex("0x1.fffffffd1d571p+6")


def powf(x: torch.Tensor, y: float) -> torch.Tensor:
    """float32 ``x ** y`` as XLA's CPU backend computes it: glibc's
    ``powf`` in float64 tensor ops, for ``x >= 0`` (or NaN) and a
    positive exponent ``y`` (taken as float32); ``y`` 1 and 0.5 are what
    XLA's algebraic simplifier makes of them (``x`` and a square root).

    log2 x = k + log2 c + log1p(z/c - 1) / ln 2 (a table pair and a
    polynomial), then 2^(y log2 x) = 2^(j/32) 2^(i) 2^r (a table entry,
    an exponent and a cubic), rounded once to float32.  A subnormal
    ``x`` is read as XLA reads it, as zero in ``powf``'s exponent
    arithmetic.  Equal to jitted jax over every float32 in [0, 12].
    """
    dev = x.device
    y = float(torch.tensor(y, dtype=torch.float32))
    if not y > 0:
        raise ValueError(f"powf: needs a positive exponent, got {y}")
    ix = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    subnormal = (ix > 0) & (ix < 0x00800000)
    # XLA's simplifier: x ** 1 is x, x ** 0.5 a square root
    if y == 1.0:
        return x.clone()
    if y == 0.5:  # correctly rounded (float64 has the bits to spare)
        return torch.sqrt(torch.where(subnormal, 0.0, x).double()).float()
    ix = torch.where(subnormal, -(23 << 23), ix)  # asuint(0 * 2^23) - 23 << 23
    # log2 x: x = 2^k z with z in [0x3f330000, 2 * 0x3f330000) as bits
    tmp = (ix - 0x3F330000) & 0xFFFFFFFF
    i = (tmp >> 19) & 15
    top = tmp & 0xFF800000
    iz = (ix - top) & 0xFFFFFFFF
    k = torch.where(top >= 2 ** 31, top - 2 ** 32, top) >> 23
    z = iz.to(torch.int32).view(torch.float32).double()
    tab = torch.tensor(_LOG2_TABLE, dtype=torch.float64, device=dev)[i]
    a = _LOG2_POLY
    r = z * tab[..., 0] - 1
    r2 = r * r
    q = (a[2] * r + a[3]) * r2 + (a[4] * r + (tab[..., 1] + k.double()))
    logx = (a[0] * r + a[1]) * (r2 * r2) + q
    # 2^(y log2 x)
    ylogx = y * logx
    kd = (ylogx + _EXP2_SHIFT) - _EXP2_SHIFT   # a multiple of 1/32
    kk = torch.round(kd * 32).to(torch.int64)
    r = ylogx - kd
    s = torch.ldexp(torch.tensor(_EXP2_TABLE, dtype=torch.float64,
                                 device=dev)[kk & 31],
                    (kk >> 5).double())
    c = _EXP2_POLY
    out = (((c[0] * r + c[1]) * (r * r) + (c[2] * r + 1)) * s).float()
    out = torch.where(ylogx > _OVERFLOW, torch.inf, out)
    out = torch.where((ylogx <= -150.0) | (x == 0), 0.0, out)
    return torch.where(torch.isnan(x) | torch.isinf(x), x, out)
