"""Device milliseconds a chunk of the sparse-expert layers: the program's
``moe.route``, ``moe.experts`` and ``moe.combine`` spans (router, dispatch,
the grouped products and SiLU·up, the weighted combine), by timing events
on the stream, over the traced call's chunks."""

from portbench import spans

SOURCE = "program_span"
LAYER = "sparse experts (models/moe.py, csrc/gemm_tf32x3.cu grouped)"
MOVES = "scored_tokens_per_s"


def read(t, ctx):
    return spans.device_ms_per_chunk(t, "moe.route", "moe.experts", "moe.combine")
