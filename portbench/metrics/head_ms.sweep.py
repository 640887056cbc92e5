"""Device milliseconds a chunk of the LM head and the NLL: the program's
``eval.nll_tail`` spans (the token sweep's scored tail), or its
``split.unembed`` and ``eval.nll`` spans (the split's full-window logits and
their NLL), by timing events on the stream, over the traced call's chunks."""

from portbench import spans

SOURCE = "program_span"
LAYER = "model (models/transformer.py: cuBLAS GEMMs, LM head)"
MOVES = "scored_tokens_per_s"


def read(t, ctx):
    return spans.device_ms_per_chunk(t, "eval.nll_tail", "split.unembed", "eval.nll")
