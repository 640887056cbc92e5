"""The whole step's share of the card's bf16 peak, in %: the model FLOPs of
the prefills and decode steps the untraced part of the window ran
(yardstick/flops.py: causal attention, the LM head only where a token is
drawn) over its seconds, over 989 TFLOP/s."""

from portbench.yardstick.peaks import PEAK_FLOPS

SOURCE = "host_clock"
LAYER = "whole step"
MOVES = "decode_tokens_per_s"


def read(t, ctx):
    c = t.counters
    if not c.get("window_seconds"):
        return None
    return 100.0 * c["window_flops"] / c["window_seconds"] / PEAK_FLOPS[c["dtype"]]
