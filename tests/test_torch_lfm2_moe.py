"""The port's LFM2-MoE hybrid (``lfm2_moe``: gated short convolutions beside
attention, sparse experts on the grouped 3xTF32 GEMM's plain path) against
the plain reference ``tests/plain_lfm2_moe.py``, on the CPU at a tiny size:
6 layers (conv, conv, attn, conv, conv, attn), 2 dense, 8 experts top-2,
hidden 128, heads of 64.

Tolerances: both sides compute in float32 on the CPU; the port's expert
products take the 3xTF32 split (each product within 2^-21 of |a| |b|, the
kernel's arithmetic) and its attention the kernels' plain blocked versions,
so the two differ by fp32 rounding in another order. Logits (|x| up to ~2)
read 6e-7 apart: held to 1e-5 (about 2^-17, far below any mechanism left
out: dropping one expert or one conv tap moves them by ~1e-2). Attention
statistics are probabilities read 1e-7 apart: held to 1e-6.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from edgellm_tpu_torch.eval.harness import run_token_sweep
from edgellm_tpu_torch.eval.split_eval import run_split_eval
from edgellm_tpu_torch.importance.metrics import importance_per_layer
from edgellm_tpu_torch.models import configs, gemm, moe
from edgellm_tpu_torch.models import transformer as tr
from edgellm_tpu_torch.parallel.split import SplitConfig, SplitRuntime
from portbench.reference import lfm2_moe as ref_lfm2
from tests import plain_lfm2_moe as plain

CFG = configs.PORT_PRESETS["tiny-lfm2"]
LOGIT_TOL = 1e-5
STATS_TOL = 1e-6


def _params(cfg=CFG, seed=0):
    """Seeded weights with norms, QK norms and the expert bias moved off
    their defaults, so that each does work."""
    p = tr.init_params(cfg, torch.Generator().manual_seed(seed), device="cpu")
    g = torch.Generator().manual_seed(seed + 1)
    for lp in p["layers"]:
        for k in list(lp):
            if k.endswith("_scale") or k.endswith("_norm"):
                lp[k] = 1 + 0.1 * torch.randn(lp[k].shape, generator=g)
            elif k == "expert_bias":
                lp[k] = 0.02 * torch.randn(lp[k].shape, generator=g)
    p["final_norm_scale"] = 1 + 0.1 * torch.randn(p["final_norm_scale"].shape, generator=g)
    return p


def _ids(b=2, s=64, seed=3):
    return torch.randint(0, CFG.vocab_size, (b, s), generator=torch.Generator().manual_seed(seed))


def test_logits_and_attention_stats_match_plain():
    p, ids = _params(), _ids()
    got, aux = tr.forward(CFG, p, ids, capture_stats=True)
    want, st = plain.forward(plain.config_of(CFG), p, ids, stats=True)
    assert (got - want).abs().max().item() <= LOGIT_TOL
    stats = aux["stats"]
    assert stats.layers == CFG.attention_layers == (2, 5)
    for layer in (2, 5):
        row = stats.row(layer)
        torch.testing.assert_close(stats.col_mean[row], st[layer][0], atol=STATS_TOL, rtol=0)
        torch.testing.assert_close(stats.last_row[row], st[layer][1], atol=STATS_TOL, rtol=0)
    with pytest.raises(ValueError, match="not an attention layer"):
        stats.row(3)


def _ref_cfg(cfg=CFG) -> dict:
    """The benchmark reference's configuration keys for a port config."""
    return {"head_dim": cfg.head_dim, "num_attention_heads": cfg.num_heads,
            "num_key_value_heads": cfg.num_kv_heads, "norm_eps": cfg.norm_eps,
            "rope_theta": cfg.rope_theta, "layer_types": list(cfg.layer_types),
            "num_dense_layers": cfg.num_dense_layers, "num_hidden_layers": cfg.num_layers,
            "num_experts_per_tok": cfg.num_experts_per_tok, "norm_topk_prob": True,
            "routed_scaling_factor": 1.0, "expert_offset": cfg.expert_offset}


def test_token_sweep_table_matches_plain(tmp_path):
    """The sweep's (method, layer, ratio) NLL table, resumed at chunk 1 as
    the benchmark runs it, against the benchmark's plain reference sweep.
    Tolerance: mean NLLs (~5.5 nats) of two fp32 computations, 1e-5."""
    p = _params()
    ids = np.random.default_rng(7).integers(0, CFG.vocab_size, 64 + 6 * 16)
    mix = {"methods": ["regular_importance", "last_row"], "layers_of_interest": [5, 2],
           "ratios": [0, 0.5, 1], "max_length": 64, "stride": 16}
    path = tmp_path / "resume.json"
    shape = (2, 2, 3)
    path.write_text(json.dumps({"next_chunk": 1, "axes": {k: mix[k] for k in (
        "methods", "layers_of_interest", "ratios")}, "chunks": 0, "wall_s": 0.0,
        "total_nll": np.zeros(shape).tolist(), "n_tokens": 0.0}))
    got = run_token_sweep(CFG, p, ids, methods=mix["methods"],
                          layers_of_interest=mix["layers_of_interest"], ratios=mix["ratios"],
                          max_length=64, stride=16, window_batch=3, max_chunks=6,
                          checkpoint_path=str(path), checkpoint_every=1 << 30, device="cpu")
    want, n_tok = ref_lfm2.token_sweep(_ref_cfg(), p, ids, mix, first_chunk=1, chunks=6)
    assert got.chunks == 6 and got.n_tokens == n_tok
    np.testing.assert_allclose(got.total_nll / got.n_tokens, want / n_tok, atol=1e-5, rtol=0)
    # the cuts do work: int4 at ratio 1 moves the table off the baseline
    assert np.abs(want[:, :, 2] - want[:, :, 0]).max() > 1e-3


def test_conv_layer_cut_raises():
    ids = np.random.default_rng(0).integers(0, CFG.vocab_size, 200)
    with pytest.raises(ValueError, match=r"\[3\] are convolution layers.*\[2, 5\]"):
        run_token_sweep(CFG, _params(), ids, methods=["regular_importance"],
                        layers_of_interest=[5, 3], ratios=[0, 0.5], max_length=64, stride=32,
                        device="cpu", max_chunks=2)


def test_expert_share_partition_adds_up():
    """Held ranges [0, 4) and [4, 8) of one layer: their parts add up to the
    uncut layer's, and the uncut layer is the plain reference's. Tolerance:
    sums of fp32 parts in another order, 1e-6 at |y| ~ 0.1."""
    p = _params()
    lp = p["layers"][3]
    x = torch.randn(2, 64, CFG.hidden_size, generator=torch.Generator().manual_seed(5))
    planes = tr.prepared_grouped_planes
    whole = moe.moe_ffn(CFG, lp, x, planes, tr.linear)
    parts = [moe.moe_ffn(dataclasses.replace(CFG, num_experts=4, expert_offset=a),
                         {**lp, "w13": lp["w13"][a:b], "w2": lp["w2"][a:b]}, x, planes, tr.linear)
             for a, b in ((0, 4), (4, 8))]
    torch.testing.assert_close(parts[0] + parts[1], whole, atol=1e-6, rtol=0)
    torch.testing.assert_close(whole, plain.experts(plain.config_of(CFG), lp, x, 0),
                               atol=1e-6, rtol=0)
    assert parts[0].abs().max() > 1e-3 and parts[1].abs().max() > 1e-3


def test_counters_count_rows_and_see_rows_no_product_wrote(monkeypatch):
    """Inside ``moe.counting`` the layer counts the rows routed to its held
    experts and, as dropped, held rows whose result no product wrote: here
    the grouped products are handed offsets that leave out the last held
    expert's rows. Outside it nothing is counted."""
    lp = _params()["layers"][3]
    x = torch.randn(1, 64, CFG.hidden_size, generator=torch.Generator().manual_seed(6))
    moe.read_counters(reset=True)
    moe.moe_ffn(CFG, lp, x, tr.prepared_grouped_planes, tr.linear)
    assert moe.read_counters()["moe_rows_routed"] == 0
    with moe.counting():
        moe.moe_ffn(CFG, lp, x, tr.prepared_grouped_planes, tr.linear)
    c = moe.read_counters(reset=True)
    assert c["moe_rows_routed"] == 64 * CFG.num_experts_per_tok and c["moe_rows_dropped"] == 0
    assert 0 < c["moe_rows_busiest"] < c["moe_rows_routed"]

    real = gemm.grouped_gemm_tf32x3

    def last_expert_left_out(a, planes, offsets, out=None):
        cut = offsets.clone()
        cut[-1] = cut[-2]
        return real(a, planes, cut, out)

    monkeypatch.setattr(gemm, "grouped_gemm_tf32x3", last_expert_left_out)
    with moe.counting():
        moe.moe_ffn(CFG, lp, x, tr.prepared_grouped_planes, tr.linear)
    _, picked = moe.route(CFG, lp, x[0], tr.linear)
    want = int((picked == CFG.num_experts - 1).sum())
    assert want > 0 and moe.read_counters(reset=True)["moe_rows_dropped"] == want


def test_pairs_counter_counts_every_pick():
    """``moe_pairs`` counts every (token, pick) pair, held or not: each of
    the held halves [0, 4) and [4, 8) counts T k pairs, routes part of them
    to its own experts, and the two parts add up to T k."""
    lp = _params()["layers"][3]
    x = torch.randn(1, 64, CFG.hidden_size, generator=torch.Generator().manual_seed(8))
    pairs = 64 * CFG.num_experts_per_tok
    moe.read_counters(reset=True)
    routed = []
    for a, b in ((0, 4), (4, 8)):
        with moe.counting():
            moe.moe_ffn(dataclasses.replace(CFG, num_experts=4, expert_offset=a),
                        {**lp, "w13": lp["w13"][a:b], "w2": lp["w2"][a:b]}, x,
                        tr.prepared_grouped_planes, tr.linear)
        c = moe.read_counters(reset=True)
        assert c["moe_pairs"] == pairs and c["moe_rows_dropped"] == 0
        routed.append(c["moe_rows_routed"])
    assert 0 < routed[0] < pairs and sum(routed) == pairs


@pytest.mark.parametrize("f", [64, 40, 130])
def test_glu_planes_store_silu_gate_times_up(f):
    """Planes prepared with ``glu`` interleave gate and up 64 features a
    tile (F padded to 64): the grouped product over them is silu(gate) * up
    of the unfused product, F features a row, and rows after the last
    expert's stay zero. Tolerance: both sides take the 3xTF32 split; the
    unfused product's columns are summed in another blocking, 1e-6 of
    values up to ~40."""
    g = torch.Generator().manual_seed(f)
    k, counts = 40, [5, 0, 7]
    w = torch.randn(len(counts), k, 2 * f, generator=g)
    offsets = torch.tensor(np.concatenate([[0], np.cumsum(counts)]), dtype=torch.int32)
    a = torch.randn(int(offsets[-1]) + 2, k, generator=g)
    glu = gemm.prepare_grouped_planes(w, glu=True)
    assert glu.rows == f and glu.cols == 2 * -(-f // 64) * 64
    h = gemm.grouped_gemm_tf32x3(a, gemm.prepare_grouped_planes(w), offsets)
    got = gemm.grouped_gemm_tf32x3(a, glu, offsets)
    assert got.shape == (a.shape[0], f)
    end = int(offsets[-1])
    want = torch.nn.functional.silu(h[:, :f]) * h[:, f:]
    torch.testing.assert_close(got[:end], want[:end], atol=1e-6, rtol=1e-6)
    assert torch.equal(got[end:], torch.zeros(2, f))


def test_gather_and_combine_plain_match_the_unfused_passes():
    """The gather copies the held pairs' rows in expert order and records
    -1 for pairs routed elsewhere; the combine equals the index_select /
    where / sum passes it replaces, and a NaN planted in every row past the
    held pairs' never reaches it. Tolerance: the same products summed over
    4 picks, in pick order on one side: 1e-6 at |out| ~ 1."""
    g = torch.Generator().manual_seed(12)
    t, k, d, offset, held = 32, 4, 16, 2, 4
    experts = torch.rand(t, 8, generator=g).topk(k, dim=-1).indices
    x = torch.randn(t, d, generator=g)
    order, offsets = moe.dispatch(experts, offset, held)
    rows, pos = moe.gather_rows(x, order, offsets, k)
    n = int(offsets[-1])
    local = experts.reshape(-1) - offset
    held_mask = (local >= 0) & (local < held)
    assert 0 < n == int(held_mask.sum()) < t * k
    assert torch.equal(rows[:n], x.index_select(0, order[:n] // k))
    old_pos = torch.empty_like(order)
    old_pos[order] = torch.arange(order.numel())
    assert torch.equal(pos.long()[held_mask], old_pos[held_mask])
    assert bool((pos[~held_mask] == -1).all())
    y = torch.randn(t * k, d, generator=g)
    y[n:] = float("nan")
    w = torch.rand(t, k, generator=g)
    got = moe.combine_rows(y, pos, w, torch.float32)
    picked = y.index_select(0, old_pos).reshape(t, k, d)
    want = torch.where(held_mask.reshape(t, k)[..., None], picked * w[..., None], 0.0).sum(dim=1)
    assert not got.isnan().any()
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
    assert torch.equal(moe.combine_rows(y, pos, w, torch.bfloat16), got.to(torch.bfloat16))


def test_router_selects_on_biased_score_and_weights_unbiased():
    cfg = CFG
    d = cfg.hidden_size
    x = torch.eye(d)[:1]                       # one token: logits = row 0 of W_r
    logits = torch.tensor([[2.0, 1.5, 1.0, 0.5, 0.0, -0.5, -1.0, -3.0]])
    w_r = torch.zeros(d, cfg.router_experts)
    w_r[0] = logits[0]
    bias = torch.zeros(cfg.router_experts)
    bias[7] = 2.0                              # lifts the lowest score above the rest
    weights, picked = moe.route(cfg, {"router": w_r, "expert_bias": bias}, x, tr.linear)
    assert sorted(picked[0].tolist()) == [0, 7]
    s = torch.sigmoid(logits[0])
    want = s[picked[0]] / (s[picked[0]].sum() + 1e-6)
    torch.testing.assert_close(weights[0], want, atol=1e-7, rtol=0)


def test_conv_is_causal():
    lp = _params()["layers"][0]
    g = torch.Generator().manual_seed(9)
    x = torch.randn(2, 32, CFG.hidden_size, generator=g)
    y = tr.short_conv(CFG, lp, x)
    for t in (0, 7, 31):
        x2 = x.clone()
        x2[:, t] += torch.randn(2, CFG.hidden_size, generator=g)
        y2 = tr.short_conv(CFG, lp, x2)
        assert torch.equal(y2[:, :t], y[:, :t])
        assert (y2[:, t] - y[:, t]).abs().max() > 1e-4
        if t + 3 < 32:  # three taps: t + 3 on does not see position t
            assert torch.equal(y2[:, t + 3:], y[:, t + 3:])


@pytest.mark.parametrize("counts", [[3, 0, 5, 0], [0, 0, 0, 9], [1, 2, 3, 4]])
def test_grouped_plain_matches_per_expert_matmul(counts):
    """Experts with zero rows included; rows after the last expert's stay
    zero. Tolerance: the 3xTF32 split, 2^-21 of |a| |b| summed over K."""
    g = torch.Generator().manual_seed(sum(counts))
    e, k, n = len(counts), 40, 24
    w = torch.randn(e, k, n, generator=g)
    offsets = torch.tensor(np.concatenate([[0], np.cumsum(counts)]), dtype=torch.int32)
    m = int(offsets[-1]) + 2
    a = torch.randn(m, k, generator=g)
    got = gemm.grouped_gemm_tf32x3(a, gemm.prepare_grouped_planes(w), offsets)
    for i in range(e):
        r0, r1 = int(offsets[i]), int(offsets[i + 1])
        torch.testing.assert_close(got[r0:r1], a[r0:r1] @ w[i], atol=2e-5, rtol=0)
    assert torch.equal(got[int(offsets[-1]):], torch.zeros(2, n))


def test_split_hops_after_conv_and_attention_are_lossless():
    """Cuts after layer 1 (conv) and 2 (attention) with fp32 hops: the split
    forward's logits are the unsplit forward's."""
    p, ids = _params(), _ids()
    rt = SplitRuntime(CFG, SplitConfig(cuts=(1, 2), hop_codecs=("fp32", "fp32")),
                      devices=["cpu"] * 3)
    got = rt.forward(rt.place_params(p), ids)
    want, _ = tr.forward(CFG, p, ids)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
    ids_np = _ids(1, 200, 11)[0].numpy()
    res = run_split_eval(CFG, p, ids_np, cuts=[1, 2], hop_codecs=["fp32", "fp32"],
                         max_length=64, stride=32, time_hops=False, max_chunks=3,
                         device="cpu")
    assert res["n_tokens"] > 0 and np.isfinite(res["ppl"])


@pytest.mark.parametrize("layer_types", [
    CFG.layer_types,
    ("full_attention", "conv", "full_attention", "full_attention", "conv", "full_attention"),
], ids=["no-row-2", "row-2-another-layers"])
def test_split_hop_importance_is_the_cut_layers_row(monkeypatch, layer_types):
    """An importance hop after attention layer 2 carries layer 2's
    importance, the row ``AttnStats.row`` names, not row 2: tiny-lfm2
    (attention at 2 and 5) has no row 2, and with attention at 0, 2, 3 and
    5 row 2 holds layer 3."""
    cfg = dataclasses.replace(CFG, layer_types=layer_types)
    p = _params(cfg)
    handed = []
    real = SplitRuntime.forward

    def spy(self, placed, ids, hop_importance=None, **kw):
        handed.append((ids, hop_importance[0]))
        return real(self, placed, ids, hop_importance=hop_importance, **kw)

    monkeypatch.setattr(SplitRuntime, "forward", spy)
    run_split_eval(cfg, p, _ids(1, 200, 13)[0].numpy(), cuts=[2],
                   hop_codecs=["selective_int4_r0.5_bf16"], importance_method="regular_importance",
                   max_length=64, stride=32, window_batch=2, time_hops=False, max_chunks=3,
                   device="cpu")
    assert [ids.shape[0] for ids, _ in handed] == [2, 1]
    for ids, got in handed:
        _, aux = tr.run_layers_from_ids(cfg, p, ids, capture_stats=True)
        stats = aux["stats"]
        assert stats.row(2) != 2
        want = importance_per_layer(stats, "regular_importance")[stats.row(2)]
        assert torch.equal(got, want if ids.shape[0] > 1 else want[0])


def test_batcher_refuses_the_hybrid():
    from edgellm_tpu_torch.serve.batching import ContinuousBatcher

    with pytest.raises(ValueError, match="conv-state cache"):
        ContinuousBatcher(CFG, _params())


def _refused_entries() -> dict:
    """The paths that run attention at every layer, each called on the
    hybrid's weights and (2, 64) ids."""
    from edgellm_tpu_torch.importance import relevance
    from edgellm_tpu_torch.models import paged_kv
    from edgellm_tpu_torch.parallel import ring
    from edgellm_tpu_torch.serve import speculative
    from edgellm_tpu_torch.serve.batching import ContinuousBatcher

    pool = torch.zeros(CFG.num_layers, 4, 4, CFG.num_kv_heads, CFG.head_dim)
    table, lengths = torch.zeros(2, 2, dtype=torch.int32), torch.ones(2, dtype=torch.int32)
    return {
        "prefill": lambda p, ids: tr.prefill(CFG, p, ids, 80),
        "decode_step": lambda p, ids: tr.decode_step(
            CFG, p, tr.init_cache(CFG, 2, 80, device="cpu"), ids[:, 0]),
        "paged_decode_step": lambda p, ids: paged_kv.paged_decode_step(
            CFG, p, pool, pool.clone(), table, lengths, ids[:, 0]),
        "forward_sp": lambda p, ids: ring.forward_sp(CFG, p, ids, 2, device="cpu"),
        "importance_sp": lambda p, ids: ring.importance_sp(CFG, p, ids, 2, "last_row",
                                                           device="cpu"),
        "ring_runtime": lambda p, ids: ring.SplitRingRuntime(CFG, (2,), ("fp32",), 2, "cpu"),
        "relevance": lambda p, ids: relevance.chunk_relevance(CFG, p, ids),
        "speculative_draft": lambda p, ids: speculative.draft_from_params(
            CFG, p, speculative.SpecConfig()),
        "batcher": lambda p, ids: ContinuousBatcher(CFG, p),
        "tensor_parallel": lambda p, ids: SplitRuntime(
            CFG, SplitConfig((2,), ("fp32",)), ["cpu"] * 2, n_model=2),
    }


@pytest.mark.parametrize("entry", ["prefill", "decode_step", "paged_decode_step", "forward_sp",
                                   "importance_sp", "ring_runtime", "relevance",
                                   "speculative_draft", "batcher", "tensor_parallel"])
def test_uniform_paths_refuse_the_hybrid_by_name(entry):
    """Every path that runs attention at every layer refuses the hybrid in
    words (``ModelConfig.require_uniform``), naming its convolution layers."""
    with pytest.raises(ValueError, match=r"attention at every layer: the convolution "
                                         r"layers \[0, 1, 3, 4\]"):
        _refused_entries()[entry](_params(), _ids())


def test_presets_and_cli_table_axes():
    """The cell's axes (configs/lfm2_hybrid_table.json) cut at attention
    layers of the ep2 preset, which holds 16 of 32 experts; the CLI names
    both LFM2 presets."""
    ep2 = configs.PORT_PRESETS["lfm2-8b-a1b-ep2"]
    whole = configs.PORT_PRESETS["lfm2-8b-a1b"]
    assert (ep2.num_experts, ep2.router_experts, whole.num_experts) == (16, 32, 32)
    assert ep2.attention_layers == (2, 6, 10, 14, 18, 21)
    with open("configs/lfm2_hybrid_table.json") as f:
        axes = json.load(f)
    assert set(axes["layers_of_interest"]) <= set(ep2.attention_layers)
    with pytest.raises(ValueError, match="experts held"):
        dataclasses.replace(CFG, num_experts=4, expert_offset=6)


def test_cli_runs_the_hybrid_sweep(tmp_path):
    from edgellm_tpu_torch import run

    params = {"methods": ["regular_importance", "last_row"], "layers_of_interest": [5, 2],
              "ratios": [0, 0.5], "max_length": 64, "stride": 32}
    run.main(["--params", json.dumps(params), "--model", "tiny-lfm2", "--device", "cpu",
              "--max-chunks", "3", "--output-dir", str(tmp_path)])
    assert any(f.suffix == ".json" for f in tmp_path.iterdir())


def test_moe_contract_runs_clean_on_the_cpu():
    """The ``moe.experts`` graph contract executed over a tiny expert layer:
    no hop and no finding; its host-sync and launch checks are the card's
    (``chip_smoke.py`` runs them there), so the CPU reports them unchecked.
    It declares the two grouped products, the gather and the combine."""
    from edgellm_tpu_torch.lint.entrypoints import run_moe_contract

    findings, detail = run_moe_contract("cpu")
    assert findings == []
    assert detail["hops"] == 0 and detail["host_sync"] == {"checked": False}
    assert detail["launches_declared"] == {"grouped_gemm_tf32x3": 2, "gather_rows": 1,
                                           "combine_rows": 1}
