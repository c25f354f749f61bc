"""Published peaks of the card, for roofline shares (NVIDIA H100 SXM data
sheet, dense rates, at its 700 W power limit; a card set to a lower limit
runs below them, so the result line names the card and its limit).

The data sheet gives no integer rate for the CUDA cores; the int32 rate is
at most the float32 one, so dividing integer operations by the float32 rate
keeps a bound a lower bound.
"""

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
SOURCE = "NVIDIA H100 SXM data sheet: 3.35 TB/s HBM3, 67 TFLOP/s FP32 (non-tensor)"


def bound_s(nbytes: float, ops: float) -> tuple[float, str]:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the float32 rate, and which it is."""
    tb, to = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return (tb, "bytes") if tb >= to else (to, "operations")
