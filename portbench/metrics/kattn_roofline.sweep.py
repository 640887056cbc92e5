"""K-attn's share of its roofline in the traced slice, in %: the least time
the card could take for the causal attention of every K-attn call
(yardstick/attention.py, published peaks) over the device time of its
kernels (``Trace.attention_s``: forward kernels not followed by a column
pass)."""

SOURCE = "device_trace"
LAYER = "attention (models/flash_attention.py, csrc/causal_attention.cu)"
MOVES = "scored_tokens_per_s"


def read(t, ctx):
    sec = t.attention_s()[0]
    bound = t.counters.get("kattn_bound_s", 0.0)
    return 100.0 * bound / sec if sec > 0 and bound > 0 else None
