"""The traffic is a function of the seed: the same seed gives the same
inputs, and every seed asks for the same work."""
from __future__ import annotations

import numpy as np
import torch

from portbench import weights
from portbench.kinds import serve_closed, split, sweep
from portbench.tests.conftest import TINY, small_ctx

BIG = 2 ** 40 + 12345


def test_corpus_and_weights_repeat_under_a_seed():
    a = weights.corpus(BIG, 1000, 151936)
    assert np.array_equal(a, weights.corpus(BIG, 1000, 151936))
    assert not np.array_equal(a, weights.corpus(BIG + 1, 1000, 151936))
    assert a.min() >= 0 and a.max() < 151936
    w1 = weights.make_weights(TINY, BIG, torch.float32, "cpu")
    w2 = weights.make_weights(TINY, BIG, torch.float32, "cpu")
    for k in w1["layers"]:
        assert torch.equal(w1["layers"][k], w2["layers"][k])
    assert torch.equal(w1["embed"], w2["embed"])


def test_sweep_and_split_slices_tile_the_corpus():
    mix = small_ctx("table-fp32").mix
    b0, e0 = sweep.slice_tokens(mix, 0, 3000)
    b1, _ = sweep.slice_tokens(mix, 1, 3000)
    assert e0 - b0 == mix["max_length"] + mix["chunks_per_call"] * mix["stride"]
    assert b1 - b0 == mix["chunks_per_call"] * mix["stride"]
    smix = small_ctx("split4-fp32").mix
    b0, e0 = split.slice_tokens(smix, 0, 3000)
    assert e0 - b0 == smix["max_length"] + (smix["chunks_per_call"] - 1) * smix["stride"]


def _rounds(seed, n=4):
    ctx = small_ctx("serve-closed", seed=seed)
    req = serve_closed.Requests(ctx.mix, seed, 256)
    return [[req.next(c) for c in range(ctx.mix["clients"])] for _ in range(n)]


def test_serve_requests_same_work_for_every_seed():
    a, a2, b = _rounds(BIG), _rounds(BIG), _rounds(BIG + 99)
    for ra, ra2, rb in zip(a, a2, b):
        assert [r["max_new_tokens"] for r in ra] == [r["max_new_tokens"] for r in ra2]
        assert all(np.array_equal(x["prompt"], y["prompt"]) for x, y in zip(ra, ra2))
        # another seed: the same sizes and greedy share in each round, dealt anew
        key = lambda rs: sorted((len(r["prompt"]), r["max_new_tokens"]) for r in rs)  # noqa: E731
        assert key(ra) == key(rb)
        assert sum(r["temperature"] == 0 for r in ra) == sum(r["temperature"] == 0 for r in rb)
    assert any(not np.array_equal(x["prompt"], y["prompt"]) for x, y in zip(a[0], b[0]))
