"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W power limit)."""

#: FLOP/s by the dtype of a product's operands: bf16 tensor cores; float32
#: operands at the tensor cores' TF32 rate, the fastest arithmetic the card
#: offers them (a 3xTF32 split does three TF32 products, a SIMT GEMM runs
#: under 67 TFLOP/s, so neither can read above 100% against it)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12}
#: HBM3 bytes/s
PEAK_BYTES_PER_S = 3.35e12


def bound_s(nbytes: float, flops: float, dtype: str) -> float:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak rate of ``dtype``."""
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS[dtype])
