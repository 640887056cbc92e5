"""Device milliseconds a chunk of the expert layers' routing around the
products: the program's ``moe.route`` (router product, sigmoid, biased
top-k, the sort by expert and the gather of the rows) and ``moe.combine``
(the weighted sum back to the tokens) spans, over the traced call's
chunks."""

from portbench import spans

SOURCE = "program_span"
LAYER = "sparse experts (models/moe.py, csrc/gemm_tf32x3.cu grouped)"
MOVES = "scored_tokens_per_s"


def read(t, ctx):
    return spans.device_ms_per_chunk(t, "moe.route", "moe.combine")
