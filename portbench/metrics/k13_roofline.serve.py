"""K13's share of its roofline in the traced steps, in %: the bytes every
paged decode attention call must move (the live K and V rows of every
running slot, q and the output; yardstick/attention.py) over HBM's peak
rate, over the device time of K13's split and merge kernels."""

SOURCE = "device_trace"
LAYER = "paged pool (models/paged_kv.py, csrc/paged_decode.cu)"
MOVES = "decode_tokens_per_s"


def read(t, ctx):
    sec = t.device_s(lambda n: "paged_decode" in n or "paged_merge" in n)
    bound = t.counters.get("k13_bound_s", 0.0)
    return 100.0 * bound / sec if sec > 0 and bound > 0 else None
