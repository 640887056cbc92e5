"""The grouped expert products' share of their roofline in the traced slice,
in %: the least time the card could take for the held experts' gate / up and
down products at the rows the traced call routed to them
(``yardstick/moe.py``, published peaks) over the device time of the grouped
3xTF32 kernel. None where no grouped kernel ran."""

SOURCE = "device_trace"
LAYER = "sparse experts (models/moe.py, csrc/gemm_tf32x3.cu grouped)"
MOVES = "scored_tokens_per_s"


def read(t, ctx):
    sec = t.device_s(lambda name: "gemm_tf32x3_grouped" in name)
    bound = t.counters.get("experts_bound_s", 0.0)
    return 100.0 * bound / sec if sec > 0 and bound > 0 else None
