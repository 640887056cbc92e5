"""Share of the traced slice in which no device operation ran, in %."""

SOURCE = "device_trace"
LAYER = "device"
MOVES = "scored_tokens_per_s"


def read(t, ctx):
    return 100.0 * (1.0 - t.busy_s / t.window_s) if t.taken and t.window_s > 0 else None
