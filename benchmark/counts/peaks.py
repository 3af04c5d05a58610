"""The card's published peaks (NVIDIA H100 SXM data sheet, dense rates,
at its 700 W limit; the copy of chip_smoke.py's table).  A float32
product at float32 accuracy runs fastest as three TF32 passes (3xTF32),
so float32's rate is TF32's over three."""

PEAK_FLOPS = {"float32": 495e12 / 3, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12          # HBM3, bytes/s
ITEM_BYTES = {"float32": 4, "bfloat16": 2}


def least_s(flops: float, nbytes: float, dtype: str) -> float:
    """The least time the card could take for the work: the larger of
    the operations over the dtype's peak and the bytes over HBM's
    (chip_smoke.py `bound_ms`, in seconds)."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES)
