"""K-attn's share of its roofline at the prefills of the traced steps, in
%: the causal attention bound of each prompt's K-attn calls
(yardstick/attention.py) over the device time of their kernels."""

SOURCE = "device_trace"
LAYER = "attention (models/flash_attention.py, csrc/causal_attention.cu)"
MOVES = "decode_tokens_per_s"


def read(t, ctx):
    sec = t.attention_s()[0]
    bound = t.counters.get("kattn_bound_s", 0.0)
    return 100.0 * bound / sec if sec > 0 and bound > 0 else None
