"""The host's seconds inside each group's submit over the card's seconds
for the same submit, in %: Σ host time of the program's
``eval.submit_group`` spans over Σ their device time (timing events on
the stream at the submit's entry and exit). Near 100 % the host waits for
the card inside submit (a pageable upload synchronising the stream), and
the device idles while the host enqueues the next group."""

from portbench import spans

SOURCE = "program_span"
LAYER = "sweep and split drivers (eval/harness.py, eval/split_eval.py)"
MOVES = "scored_tokens_per_s"


def read(t, ctx):
    got = spans.named(spans.taken(), "eval.submit_group") if t.taken else []
    host, dev = spans.host_s(got), spans.device_s(got)
    return 100.0 * host / dev if host is not None and dev else None
