"""The port's executed graph contracts (``edgellm_tpu_torch.lint.contracts``
+ ``entrypoints``) on the CPU, at the reference's lint geometry: every
contract name the reference checks runs clean (or skips a card-only check
with its reason), each split and link contract's payload leaves, wire
dtypes and wire bytes equal the reference's declaration, each checker
gives exactly one finding of its own rule on a seeded fault, and the
decorator and the wire tap add nothing to a call."""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgellm_tpu.lint import entrypoints as ref_entry
from edgellm_tpu.models.configs import tiny_config as ref_tiny_config
from edgellm_tpu.parallel.split import PipelineConfig as RefPipelineConfig
from edgellm_tpu.parallel.split import SplitConfig as RefSplitConfig
from edgellm_tpu.parallel.split import SplitRuntime as RefSplitRuntime
from edgellm_tpu.parallel.split import make_stage_mesh as ref_stage_mesh
from edgellm_tpu_torch.codecs.wire_format import cross_cut, wire_tap
from edgellm_tpu_torch.lint import GRAPH_CONTRACTS, GraphContract, graph_contract
from edgellm_tpu_torch.lint.contracts import (check_execution, check_identity, execute,
                                              hop_launches)
from edgellm_tpu_torch.lint.entrypoints import (BATCH, CPU_GEOMETRY, K_VERIFY, MS, PBATCH,
                                                PM, SEQ, lint_model, run_graph_checks)
from edgellm_tpu_torch.models import flash_attention as fa
from edgellm_tpu_torch.parallel.split import SplitConfig, SplitRuntime

REPO = Path(__file__).resolve().parent.parent


def _reference_names() -> set:
    """Every contract name the reference's graph layer checks, read from its
    driver's source: its run_one contracts and its identity / executed
    checks."""
    src = (REPO / "edgellm_tpu" / "lint" / "entrypoints.py").read_text()
    runs = set(re.findall(r'run_one\(\s*"([^"]+)"', src))
    checks = set(re.findall(r'checked\.append\(\s*"([^"]+)"\)', src))
    return runs | checks


@pytest.fixture(scope="module")
def graph():
    findings, checked, skipped, details = run_graph_checks("cpu")
    return findings, checked, skipped, details


def test_every_reference_contract_runs_clean(graph):
    findings, checked, skipped, _ = graph
    names = _reference_names()
    assert len(names) == 40
    assert findings == [], [f.format() for f in findings]
    assert set(checked) == names and len(checked) == len(names)
    # the card-only checks are skipped with their reason, never "checked"
    assert any(s.startswith("graph host_sync: not measured on the cpu") for s in skipped)
    assert any(s.startswith("graph launches: counted on the card only") for s in skipped)


def test_cpu_never_reports_host_sync_as_checked(graph):
    _, _, skipped, details = graph
    syncing = [n for n, d in details.items() if "host_sync" in d]
    assert len(syncing) == 19
    assert all(details[n]["host_sync"] == {"checked": False} for n in syncing)
    note = next(s for s in skipped if s.startswith("graph host_sync"))
    assert all(n in note for n in syncing)


@pytest.fixture(scope="module")
def reference():
    """The reference's declared wire facts at its lint geometry (its
    ``_payload_info`` and its runtime's byte accounting)."""
    cfg = ref_tiny_config("qwen2", **CPU_GEOMETRY)
    split = RefSplitConfig(cuts=(2,), hop_codecs=("int8_per_token",))
    rt = RefSplitRuntime(cfg, split, ref_stage_mesh(2))
    rt_pipe = RefSplitRuntime(cfg, split, ref_stage_mesh(2),
                              pipeline=RefPipelineConfig(num_microbatches=PM))
    codec, n = rt.codecs[0], len(rt.codecs)
    d = cfg.hidden_size
    lf, df, bf = ref_entry._payload_info(codec, (BATCH, SEQ, d))
    ls, ds, _ = ref_entry._payload_info(codec, (BATCH, 1, d))
    lp, dp, _ = ref_entry._payload_info(codec, (MS, 1, d))
    lv, dv, _ = ref_entry._payload_info(codec, (BATCH, K_VERIFY, d))
    from edgellm_tpu.codecs.fec import FECConfig

    attempts, routes = 2, 2
    fec = FECConfig(group_size=4, n_groups=4)
    return {
        "split.forward": (n * lf, df, sum(rt.hop_bytes(BATCH, SEQ))),
        "split.decode_step": (n * ls, ds, sum(rt.decode_hop_bytes(BATCH))),
        "split.decode_step_paged": (n * lp, dp, sum(rt.decode_hop_bytes(MS))),
        "split.verify_step": (n * lv, dv, sum(rt.verify_hop_bytes(BATCH, K_VERIFY))),
        "split.forward.pipelined": (PM * n * lf, df,
                                    PM * sum(rt_pipe.hop_bytes(PBATCH // PM, SEQ))),
        "split.decode_step.pipelined": (PM * n * ls, ds,
                                        sum(rt_pipe.pipelined_decode_hop_bytes(PBATCH))),
        "split.decode_step_paged.pipelined": (PM * n * lp, dp,
                                              sum(rt_pipe.pipelined_decode_hop_bytes(MS))),
        "faults.hop": (n * (lf + 2) * attempts, df | {"uint32"},
                       attempts * (bf + 8) * n),
        "fec.hop": (n * 2 * attempts * routes, {"uint8", "uint32"},
                    attempts * routes * fec.wire_nbytes(bf + 8) * n),
        "split.forward.fused": (n, {"uint8"}, sum(rt.hop_bytes(BATCH, SEQ)) + 8 * n),
        "split.decode_step.fused": (n, {"uint8"}, sum(rt.decode_hop_bytes(BATCH)) + 8 * n),
        "split.verify_step.fused": (n, {"uint8"},
                                    sum(rt.verify_hop_bytes(BATCH, K_VERIFY)) + 8 * n),
    }


@pytest.mark.parametrize("name", [
    "split.forward", "split.decode_step", "split.decode_step_paged", "split.verify_step",
    "split.forward.pipelined", "split.decode_step.pipelined",
    "split.decode_step_paged.pipelined", "faults.hop", "fec.hop", "split.forward.fused",
    "split.decode_step.fused", "split.verify_step.fused"])
def test_wire_facts_equal_the_reference(graph, reference, name):
    """Payload leaves crossed, their dtypes and their bytes, measured where
    they crossed, against the reference's declaration. The links walk
    every transmission at the lint's fault step, as the reference's
    unrolled hop does."""
    detail = graph[3][name]
    hops, dtypes, nbytes = reference[name]
    assert detail["hops"] == detail["hops_declared"] == hops
    assert detail["wire_bytes"] == detail["wire_bytes_declared"] == nbytes
    assert set(detail["wire_dtypes"]) == set(dtypes)


@pytest.mark.parametrize("name", ["transformer.prefill", "transformer.decode_step",
                                  "decode.prefill", "decode.step", "decode.prefill_suffix",
                                  "paged.decode_step", "paged.decode_step_quant"])
def test_local_entry_points_cross_nothing(graph, name):
    detail = graph[3][name]
    assert detail["hops"] == detail["hops_declared"] == 0 and detail["wire_bytes"] == 0


def test_declared_launches_follow_the_codec_registry(graph):
    details = graph[3]
    layers = CPU_GEOMETRY["num_layers"]
    assert details["transformer.prefill"]["launches_declared"] == {"causal_attention": layers}
    assert details["paged.decode_step_quant"]["launches_declared"] == {
        "paged_decode_attention_quant": layers}
    assert details["split.forward.pipelined"]["launches_declared"] == {
        "causal_attention": PM * layers, "int8_affine_encode": PM, "int8_affine_decode": PM}
    # the faulty link decodes once a transmission, encodes once a hop
    assert details["faults.hop"]["launches_declared"] == {
        "causal_attention": layers, "int8_affine_encode": 1, "int8_affine_decode": 2}
    assert hop_launches(["int4_per_channel_pallas", "ternary_max"]) == {
        "chan_int4_encode": 1, "int4_decode": 1, "ternary_encode": 1, "ternary_decode": 1}


def _one(findings, rule):
    assert len(findings) == 1 and findings[0].rule == rule, \
        [f.format() for f in findings]


def _check(contract, call, **kw):
    return check_execution(contract, execute(call, "cpu"), on_card=False, **kw)[0]


def test_seeded_extra_hop():
    contract = GraphContract(name="seed.hops", hops=1)
    x = torch.arange(4, dtype=torch.int8)
    assert _check(contract, lambda: cross_cut(x, "cpu")) == []
    _one(_check(contract, lambda: (cross_cut(x, "cpu"), cross_cut(x, "cpu"))), "GC-hops")


def test_seeded_float64_op():
    contract = GraphContract(name="seed.f64")
    x = torch.ones(3)
    assert _check(contract, lambda: x * 2) == []
    _one(_check(contract, lambda: x.double() * 2), "GC-f64")


def test_seeded_bf16_leaf_where_int8_is_declared():
    contract = GraphContract(name="seed.dtype", wire_dtypes=frozenset({"int8", "float32"}))
    assert _check(contract, lambda: cross_cut(torch.zeros(4, dtype=torch.int8), "cpu")) == []
    _one(_check(contract, lambda: cross_cut(torch.zeros(4, dtype=torch.bfloat16), "cpu")),
         "GC-wire-dtype")


def test_seeded_wire_bytes():
    contract = GraphContract(name="seed.bytes", wire_bytes=4)
    _one(_check(contract, lambda: cross_cut(torch.zeros(2, dtype=torch.int32), "cpu")),
         "GC-wire-bytes")


def test_seeded_cache_rebuilt():
    contract = GraphContract(name="seed.in_place", in_place=2)
    k, v = torch.zeros(4), torch.zeros(4)

    def update():
        k.add_(1)
        v.add_(1)
        return k, v

    def rebuild():
        return k + 1, v + 1

    assert _check(contract, update, buffers=[k, v], outputs=[k, v]) == []
    out = execute(rebuild, "cpu")
    _one(check_execution(contract, out, on_card=False, buffers=[k, v],
                         outputs=list(out.result))[0], "GC-in-place")


def test_seeded_disabled_build_flips_one_bit():
    x = torch.linspace(-1, 1, 8)
    flipped = x.clone()
    flipped.view(torch.int32)[3] ^= 1
    assert check_identity("seed.identity", lambda: torch.tanh(x), lambda: torch.tanh(x),
                          "cpu") == []
    _one(check_identity("seed.identity", lambda: torch.tanh(x), lambda: torch.tanh(flipped),
                        "cpu"), "GC-identity")


def test_seeded_disabled_build_adds_one_launch():
    x = torch.ones(4)

    def extra_launch():
        fa.causal_attention.launches += 1  # what a wrapper counts at a launch
        return x + 1

    _one(check_identity("seed.launch", lambda: x + 1, extra_launch, "cpu"), "GC-identity")


def test_seeded_disabled_build_adds_one_op():
    x = torch.ones(4)
    _one(check_identity("seed.ops", lambda: x + 1, lambda: (x + 0) + 1, "cpu", values=False),
         "GC-identity")


def test_graph_contract_adds_nothing_to_a_call():
    def body(x):
        return torch.cumsum(x * 3, 0)

    decorated = graph_contract("seed.decorated", hops=0)(body)
    assert decorated is body and GRAPH_CONTRACTS["seed.decorated"].fn is body
    x = torch.randn(16, generator=torch.Generator().manual_seed(0))
    assert torch.equal(decorated(x), body(x))
    del GRAPH_CONTRACTS["seed.decorated"]
    with pytest.raises(ValueError, match="need a reason"):
        graph_contract("seed.bare", host_syncs={"serve/x.py:f": " "})
    with pytest.raises(ValueError, match="unknown forbid"):
        graph_contract("seed.forbid", forbid=("host_callback",))


def test_armed_wire_tap_equals_unarmed():
    """The recorder the lint arms changes no output bit: the same split
    forward with and without the tap."""
    cfg, params = lint_model("cpu")
    rt = SplitRuntime(cfg, SplitConfig(cuts=(2,), hop_codecs=("int8_per_token",)),
                      ["cpu", "cpu"])
    placed = rt.place_params(params)
    ids = torch.as_tensor(np.arange(SEQ)[None] % cfg.vocab_size)
    plain = rt.forward(placed, ids)
    with wire_tap() as record:
        armed = rt.forward(placed, ids)
    assert torch.equal(plain, armed) and len(record) == 3
    with wire_tap() as record:
        pass
    assert record == []


def test_reference_payload_info_is_jax_shaped():
    """The reference facts above come from an abstract evaluation; the
    port's from its own encode: one codec, one answer."""
    from edgellm_tpu.codecs.packing import get_wire_codec as ref_codec
    from edgellm_tpu_torch.codecs.packing import get_wire_codec
    from edgellm_tpu_torch.lint.entrypoints import payload_info

    shape = (BATCH, SEQ, CPU_GEOMETRY["hidden_size"])
    ref = ref_entry._payload_info(ref_codec("int8_per_token"), shape)
    got = payload_info(get_wire_codec("int8_per_token"), shape, "cpu")
    assert (got[0], got[1], got[2]) == (ref[0], ref[1], ref[2])
    assert jnp.zeros(1).dtype == jnp.float32 and jax.devices()
