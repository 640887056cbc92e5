"""Device milliseconds a chunk of the token sweep's suffix forwards: the
program's ``eval.suffix`` spans (the layers after the cut over the ratios'
rows), by timing events on the stream, over the traced call's chunks."""

from portbench import spans

SOURCE = "program_span"
LAYER = "sweep and split drivers (eval/harness.py, eval/split_eval.py)"
MOVES = "scored_tokens_per_s"


def read(t, ctx):
    return spans.device_ms_per_chunk(t, "eval.suffix")
