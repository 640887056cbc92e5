"""Share of the traced slice's busy device time in cuBLAS matrix products
(the model's projections, MLP and LM head), in %."""

from portbench.harness import is_gemm

SOURCE = "device_trace"
LAYER = "model (models/transformer.py: cuBLAS GEMMs, LM head)"
MOVES = "scored_tokens_per_s"


def read(t, ctx):
    return 100.0 * t.device_s(is_gemm) / t.busy_s if t.taken and t.busy_s > 0 else None
