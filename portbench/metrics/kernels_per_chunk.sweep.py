"""Device operations (kernels, copies, fills) the traced slice launched, a
chunk: the host's launch work a chunk of the sweep or split drivers costs."""

SOURCE = "device_trace"
LAYER = "sweep and split drivers (eval/harness.py, eval/split_eval.py)"
MOVES = "scored_tokens_per_s"


def read(t, ctx):
    chunks = t.counters.get("chunks")
    return t.kernels / chunks if t.taken and chunks else None
