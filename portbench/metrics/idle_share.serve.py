"""Share of the traced steps' wall time in which no device operation ran,
in %."""

SOURCE = "device_trace"
LAYER = "device"
MOVES = "decode_tokens_per_s"


def read(t, ctx):
    return 100.0 * (1.0 - t.busy_s / t.window_s) if t.taken and t.window_s > 0 else None
