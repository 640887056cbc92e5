"""Mean share of the batcher's slots that hold a running stream after a
step, over the untraced steps of the window, in %."""

SOURCE = "program_counter"
LAYER = "batcher (serve/batching.py ContinuousBatcher.step)"
MOVES = "decode_tokens_per_s"


def read(t, ctx):
    c = t.counters
    return 100.0 * c["slot_share"] if c.get("window_steps") else None
