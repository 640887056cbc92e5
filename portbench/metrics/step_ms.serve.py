"""Mean milliseconds of one ``ContinuousBatcher.step()`` (admissions with
their prefills, the ragged decode step, the sampler and the host's read of
the tokens), by the benchmark's clock around each call, over the untraced
steps of the window."""

SOURCE = "host_clock"
LAYER = "batcher (serve/batching.py ContinuousBatcher.step)"
MOVES = "decode_tokens_per_s"


def read(t, ctx):
    c = t.counters
    return 1e3 * c["window_step_s"] / c["window_steps"] if c.get("window_steps") else None
