"""The whole step's share of the card's peak, in %: the model FLOPs of the
chunks the untraced calls of the window completed (yardstick/flops.py)
over their seconds, over the published peak of the cell's dtype."""

from portbench.yardstick.peaks import PEAK_FLOPS

SOURCE = "host_clock"
LAYER = "whole step"
MOVES = "scored_tokens_per_s"


def read(t, ctx):
    c = t.counters
    if not c.get("window_seconds") or not c.get("window_chunks"):
        return None
    return 100.0 * c["window_chunks"] * c["chunk_flops"] / c["window_seconds"] \
        / PEAK_FLOPS[c["dtype"]]
