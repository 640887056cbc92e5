"""The port's offline tools against the TPU package's, on the CPU: the
window-batch memory preflight (``tools/wb_preflight.py`` over
``analysis/aot.py``), ``prepare_wikitext`` and ``check_reproduction``.

The preflight probes the sweep's calls on the card; here a peak reader
stands in for the card's allocator: the bytes a call returns, beside a
fixed resident size, which grow linearly with the window batch as the
card's peaks do. The cases are the reference's preflight tests: the
estimate grows with the batch, the halving lands under the budget, the
floor holds, the relevance preflight halves, the sweep wrapper sizes the
earliest layer; a probe that runs out of memory is a doesn't-fit, and any
other failure propagates.

``prepare_wikitext`` runs in both packages on a ``.jsonl``, a joined
``.txt`` and a ``save_to_disk`` directory with a tokenizer built offline
(``tokenizers``): the ``.npy`` and ``.meta.json`` are byte for byte equal,
and so is the printed line. ``check_reproduction`` runs in both on the same
result files: the same rows, output and exit codes.
"""
import json

import numpy as np
import pytest
import torch

from edgellm_tpu.tools import check_reproduction as j_check
from edgellm_tpu.tools import prepare_wikitext as j_prepare
from edgellm_tpu_torch.models import init_params, tiny_config
from edgellm_tpu_torch.tools import check_reproduction, prepare_wikitext, wb_preflight
from edgellm_tpu_torch.tools.wb_preflight import (estimate_sweep_peak_bytes,
                                                  largest_fitting_relevance_batch,
                                                  largest_fitting_window_batch,
                                                  preflight_token_sweep_batch)

CFG = tiny_config("qwen2", num_layers=4, hidden_size=32, num_heads=4, vocab_size=128)
RESIDENT = 1 << 20


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for y in x:
            yield from _tensors(y)


def output_bytes(call) -> int:
    """The stand-in peak: a fixed resident size plus the bytes the call
    returns."""
    return RESIDENT + sum(t.numel() * t.element_size() for t in _tensors(call()))


@pytest.fixture(scope="module")
def probe():
    params = init_params(CFG, torch.Generator().manual_seed(0), device="cpu")
    return dict(params=params, device="cpu", peak_reader=output_bytes)


KW = dict(max_length=32, tail=9, layer=1, codec="int4_token_select", n_ratios=3,
          dtype=torch.float32)


def test_estimate_grows_with_batch(probe):
    small = estimate_sweep_peak_bytes(CFG, 2, **KW, **probe)
    big = estimate_sweep_peak_bytes(CFG, 8, **KW, **probe)
    assert big["peak"] > small["peak"]
    assert big["hiddens_stack"] == 4 * small["hiddens_stack"]
    for key in ("stats_call", "suffix_call", "base_call", "peak"):
        assert small[key] > 0
    # the linear fit from batches 1 and 2 reads a linear peak exactly
    from edgellm_tpu_torch.eval.harness import _stats_forward

    ids = torch.zeros((8, 32), dtype=torch.long)
    with torch.inference_mode():
        at8 = output_bytes(lambda: _stats_forward(CFG, probe["params"], ids, (1,),
                                                  want_final=True))
    assert big["stats_call"] == pytest.approx(at8, rel=1e-12)


def test_halving_respects_budget(probe):
    est8 = estimate_sweep_peak_bytes(CFG, 8, **KW, **probe)
    est2 = estimate_sweep_peak_bytes(CFG, 2, **KW, **probe)
    budget = (est2["peak"] + est8["peak"]) // 2
    wb, est = largest_fitting_window_batch(CFG, 8, hbm_bytes=budget, budget_frac=1.0,
                                           **KW, **probe)
    assert wb < 8 and est["peak"] <= budget


def test_min_window_batch_floor(probe):
    wb, _ = largest_fitting_window_batch(CFG, 8, hbm_bytes=1, budget_frac=1.0, **KW, **probe)
    assert wb == 1  # nothing fits: floor, never an endless loop


def test_relevance_preflight_halves_to_fit(probe):
    kw = dict(max_length=32, dtype=torch.float32, budget_frac=1.0, **probe)
    assert largest_fitting_relevance_batch(CFG, 8, hbm_bytes=1 << 40, **kw) == 8
    assert largest_fitting_relevance_batch(CFG, 8, hbm_bytes=1, **kw) == 1


def test_token_sweep_preflight_uses_earliest_layer(probe, monkeypatch):
    """The sweep wrapper sizes the longest suffix (earliest layer) and the
    dedup-aware ratio axis; a generous budget keeps the requested batch, and
    ``BENCH_HBM_GB`` sets the card's size."""
    kw = dict(max_length=32, stride=8, layers_of_interest=[2, 1], ratios=[0, 0.5],
              dtype=torch.float32, budget_frac=1.0, **probe)
    seen = []
    real = wb_preflight.probe_sweep_costs

    def spy(cfg, max_length, tail, layer, codec, n_ratios, *a, **k):
        seen.append((layer, n_ratios, tail))
        return real(cfg, max_length, tail, layer, codec, n_ratios, *a, **k)

    monkeypatch.setattr(wb_preflight, "probe_sweep_costs", spy)
    assert preflight_token_sweep_batch(CFG, 4, hbm_bytes=1 << 40, **kw) == 4
    assert seen == [(1, 1, 9)]
    assert preflight_token_sweep_batch(CFG, 4, hbm_bytes=1, **kw) == 1
    monkeypatch.setenv("BENCH_HBM_GB", "0.5")
    assert wb_preflight._budget_bytes(None, 0.5) == 2 ** 28


def test_out_of_memory_probe_is_a_no_fit(probe):
    """A probe that runs out of memory makes every batch above the floor a
    doesn't-fit; any other failure propagates."""
    calls = []

    def oom_at_two(call):
        calls.append(call)
        if len(calls) > 3:  # the three probes at batch 1 fit, those at 2 do not
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return output_bytes(call)

    kw = {**probe, "peak_reader": oom_at_two}
    wb, est = largest_fitting_window_batch(CFG, 8, hbm_bytes=1 << 40, budget_frac=1.0,
                                           **KW, **kw)
    assert wb == 1 and est["peak"] == float("inf") and len(calls) == 6

    def broken(call):
        raise RuntimeError("not a memory error")

    with pytest.raises(RuntimeError, match="not a memory error"):
        estimate_sweep_peak_bytes(CFG, 2, **KW, **{**probe, "peak_reader": broken})


@pytest.fixture(scope="module")
def tokenizer_dir(tmp_path_factory):
    """A byte-level BPE tokenizer trained offline, saved as a local HF
    tokenizer directory."""
    from tokenizers import Tokenizer, models, pre_tokenizers, trainers
    from transformers import PreTrainedTokenizerFast

    tok = Tokenizer(models.BPE(unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.train_from_iterator(["alpha beta gamma\n\n delta = = epsilon ="] * 20,
                            trainers.BpeTrainer(vocab_size=300, special_tokens=["<unk>"]))
    path = tmp_path_factory.mktemp("tok")
    PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="<unk>").save_pretrained(str(path))
    return str(path)


ROWS = [" = Alpha = \n", "", " beta gamma delta \n", " epsilon \n"]


def _source(kind: str, tmp_path) -> str:
    if kind == "jsonl":
        p = tmp_path / "rows.jsonl"
        p.write_text("\n".join(json.dumps({"text": r}) for r in ROWS))
    elif kind == "txt":
        p = tmp_path / "joined.txt"
        p.write_text("\n\n".join(ROWS))
    else:
        from datasets import Dataset, DatasetDict

        p = tmp_path / "ds"
        DatasetDict({"test": Dataset.from_dict({"text": ROWS})}).save_to_disk(str(p))
    return str(p)


@pytest.mark.parametrize("kind", ["jsonl", "txt", "datasets-dir"])
def test_prepare_wikitext_equals_reference(kind, tokenizer_dir, tmp_path, capsys):
    src = _source(kind, tmp_path)
    outs = {}
    for name, tool in (("j", j_prepare), ("t", prepare_wikitext)):
        out = tmp_path / f"{name}.npy"
        assert tool.main(["--input", src, "--tokenizer", tokenizer_dir,
                          "--output", str(out)]) == 0
        outs[name] = (out.read_bytes(), (tmp_path / f"{name}.npy.meta.json").read_bytes(),
                      capsys.readouterr().out)
    assert outs["t"] == outs["j"]
    meta = json.loads(outs["t"][1])
    assert meta["n_tokens"] == np.load(tmp_path / "t.npy").size > 0
    assert meta["n_documents"] == (1 if kind == "txt" else len(ROWS))


def _result(ppl: float, ratios=(0.25,)) -> dict:
    return {"axes": {"methods": ["last_row"], "layers_of_interest": [3],
                     "ratios": list(ratios)},
            "ppl": [[[ppl] * len(ratios)]]}


@pytest.mark.parametrize("case", ["exact", "off", "collapse", "no_cells", "usage"])
def test_check_reproduction_equals_reference(case, tmp_path, capsys):
    """The same rows, output and exit codes: 0 when every anchor holds, 1
    on a miss, 2 with no golden cell or without a file argument."""
    result = {"exact": _result(13.40), "off": _result(13.60),
              "collapse": {"axes": {"methods": ["last_row"], "layers_of_interest": [3],
                                    "ratios": [1.0]}, "ppl": [[[5e6]]]},
              "no_cells": {"axes": {"methods": ["channel"]}, "ppl": []}}.get(case)
    argv = []
    if result is not None:
        path = tmp_path / "r.json"
        path.write_text(json.dumps(result))
        argv = [str(path)]
        assert check_reproduction.check(result) == j_check.check(result)
    got = (check_reproduction.main(argv), capsys.readouterr().out)
    want = (j_check.main(argv), capsys.readouterr().out)
    assert got[0] == want[0] == {"exact": 0, "off": 1, "collapse": 0, "no_cells": 2,
                                 "usage": 2}[case]
    # without a file each prints its own module note
    assert got[1] == (check_reproduction.__doc__ + "\n" if case == "usage" else want[1])
