"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at its 700 W limit; a run prints the card's power limit beside them)."""
HBM_BYTES_PER_S = 3.35e12
FLOPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}


def bytes_of(dtype: str) -> int:
    return 2 if dtype in ("bfloat16", "float16") else (1 if dtype == "uint8" else 4)


def bound_seconds(nbytes: float, flops: float, dtype: str) -> float:
    """The least time of a kernel: the larger of its bytes over the HBM
    bandwidth and its FLOPs over the peak of its type."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FLOPS_PER_S.get(dtype, FLOPS_PER_S["float32"]))
