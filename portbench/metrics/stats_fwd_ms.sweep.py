"""Device milliseconds a chunk of the token sweep's statistics forward:
the program's ``eval.stats_forward`` spans (the prefix pass with K-stats to
the deepest layer of interest and its full-depth continuation for the
ratio-0 baseline), by timing events on the stream, over the traced call's
chunks."""

from portbench import spans

SOURCE = "program_span"
LAYER = "sweep and split drivers (eval/harness.py, eval/split_eval.py)"
MOVES = "scored_tokens_per_s"


def read(t, ctx):
    return spans.device_ms_per_chunk(t, "eval.stats_forward")
