"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the full 700 W power limit)."""

HBM_BYTES_PER_S = 3.35e12
FLOPS = {"bfloat16": 989e12, "float16": 989e12, "tf32": 495e12,
         "float32": 67e12, "fp8": 1979e12}


def least_seconds(counts: dict, precision: str = "float32") -> float:
    """The least time the chip could take for ``counts`` (``bytes`` and
    ``flops``): the larger of bytes over the memory rate and operations
    over the precision's peak."""
    return max(counts.get("bytes", 0.0) / HBM_BYTES_PER_S,
               counts.get("flops", 0.0) / FLOPS[precision])
