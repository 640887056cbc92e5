"""K-stats' share of its roofline in the traced slice, in %: the least time
for causal attention with its column means and last rows (each pair's
products once, yardstick/attention.py) over the device time of the K-stats
kernels (``Trace.attention_s``: a forward and the column pass after it)."""

SOURCE = "device_trace"
LAYER = "attention statistics (csrc/attention_stats.cu)"
MOVES = "scored_tokens_per_s"


def read(t, ctx):
    sec = t.attention_s()[1]
    bound = t.counters.get("kstats_bound_s", 0.0)
    return 100.0 * bound / sec if sec > 0 and bound > 0 else None
