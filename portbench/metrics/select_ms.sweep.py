"""Device milliseconds a chunk of the token sweep's selection: the
program's ``eval.importance`` (the methods' importance from the statistics)
and ``eval.codec`` (the simulated token codec over the ratios) spans, by
timing events on the stream, over the traced call's chunks."""

from portbench import spans

SOURCE = "program_span"
LAYER = "sweep and split drivers (eval/harness.py, eval/split_eval.py)"
MOVES = "scored_tokens_per_s"


def read(t, ctx):
    return spans.device_ms_per_chunk(t, "eval.importance", "eval.codec")
