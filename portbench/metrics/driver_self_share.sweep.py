"""The entry's own share of its call, in %: the self host time of the
program's ``eval.call`` span, less its ``eval.submit_group`` and
``eval.drain_group`` children, over its duration. What each call's edges
cost: parameter placement, the runtime build, checkpoint load and saves."""

from portbench import spans

SOURCE = "program_span"
LAYER = "sweep and split drivers (eval/harness.py, eval/split_eval.py)"
MOVES = "scored_tokens_per_s"
GROUP_SPANS = ("eval.submit_group", "eval.drain_group")


def read(t, ctx):
    every = spans.taken() if t.taken else []
    calls = spans.named(every, "eval.call")
    if not calls:
        return None
    own = sum(spans.self_s(every, c, of=GROUP_SPANS) for c in calls)
    return 100.0 * own / spans.host_s(calls)
