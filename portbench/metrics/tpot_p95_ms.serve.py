"""95th percentile of the (last token - first token) / (tokens - 1) of the requests completed,
over the window of the traced run, leaving out every request the traced
slice touched. A tail of the serve cell, kept here and not as an
end-to-end metric: its spread between runs of one seed would need a bound
past the 25 % a bound may take (PERF.md)."""

SOURCE = "host_clock"
LAYER = "batcher (serve/batching.py ContinuousBatcher.step)"
MOVES = "decode_tokens_per_s"


def read(t, ctx):
    return t.counters.get("tpot_p95_ms")
