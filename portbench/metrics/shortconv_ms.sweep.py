"""Device milliseconds a chunk of the gated short convolutions between their
projections: the program's ``mix.conv`` spans (the split, B * x, the causal
taps, C *), over the traced call's chunks."""

from portbench import spans

SOURCE = "program_span"
LAYER = "short convolution (models/transformer.py short_conv)"
MOVES = "scored_tokens_per_s"


def read(t, ctx):
    return spans.device_ms_per_chunk(t, "mix.conv")
