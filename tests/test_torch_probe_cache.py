"""The port's probe cache and substitution gate against the TPU package's, on
the CPU.

The cache: both packages' ``probe_cache`` modules get the same rows and a
``tmp_path`` cache (``EDGELLM_PROBE_CACHE``) with the fingerprint passed
explicitly, and must read back the same speedups and verdicts (merge,
``WIN_MARGIN`` at 1.049 / 1.05, a corrupt or absent file, non-finite
ratios, the selective family folded). The gate: ``fused_hop_plan``'s
probe-cache branch, and the codec backend, which takes every kernel twin on
a CUDA device whatever the cache holds, with ``probe_cache.fingerprint``
monkeypatched so that the card's branch runs on the CPU (the gate decides
for a CUDA device; the twins' wrappers take their plain versions on CPU
tensors). The probes' parity rows on the CPU, which record nothing.
"""
import json
import math

import pytest
import torch

from edgellm_tpu.codecs import probe_cache as jcache
from edgellm_tpu_torch.codecs import codec_kernels as ck
from edgellm_tpu_torch.codecs import fused_hop as fh
from edgellm_tpu_torch.codecs import probe_cache as tcache
from edgellm_tpu_torch.codecs.packing import get_wire_codec
from edgellm_tpu_torch.parallel import split as tsplit
from edgellm_tpu_torch.tools import pallas_probe

FP = "cuda:NVIDIA H100 80GB HBM3"


@pytest.fixture
def cache(tmp_path, monkeypatch):
    path = tmp_path / "sub" / "wins.json"
    monkeypatch.setenv("EDGELLM_PROBE_CACHE", str(path))
    return path


def _both(fn, *args, **kw):
    return getattr(jcache, fn)(*args, **kw), getattr(tcache, fn)(*args, **kw)


def test_record_merges_like_reference(cache):
    rows = [{"codec": "int8_per_token", "roundtrip_speedup_vs_jnp_raw": 7.25,
             "roundtrip_speedup_vs_jnp": 7.3},
            {"codec": "selective_int4_r0.25_bf16", "roundtrip_speedup_vs_jnp": 0.97},
            {"codec": "ternary_max", "roundtrip_speedup_vs_jnp_raw": float("nan")},
            {"codec": "int4_per_token"}]
    more = [{"codec": "int8_per_token", "roundtrip_speedup_vs_jnp_raw": 1.049},
            {"codec": "fused_hop:int8_per_token", "roundtrip_speedup_vs_jnp_raw": 1.05}]
    for mod in (jcache, tcache):
        cache.unlink(missing_ok=True)
        assert mod.record(rows, fp=FP) == str(cache)
        assert mod.record(more, fp=FP) == str(cache)
        assert mod.record([{"codec": "x", "roundtrip_speedup_vs_jnp_raw": math.inf}],
                          fp=FP) is None  # nothing finite: nothing written
        data = json.loads(cache.read_text())
        assert data == {FP: {"speedups": {"int8_per_token": 1.049, "selective_int4": 0.97,
                                          "fused_hop:int8_per_token": 1.05}}}
        assert mod.load_speedups(FP) == data[FP]["speedups"]
        assert mod.load_speedups("tpu:TPU v5 lite") is None
    assert _both("measured_win", "int8_per_token", fp=FP) == (False, False)  # 1.049
    assert _both("measured_win", "fused_hop:int8_per_token", fp=FP) == (True, True)  # 1.05
    assert _both("measured_win", "selective_int4_r0.5_fp16", fp=FP) == (False, False)
    assert _both("measured_win", "int4_per_token", fp=FP) == (None, None)
    assert tcache.WIN_MARGIN == jcache.WIN_MARGIN == 1.05


@pytest.mark.parametrize("content", [None, "{not json", '{"cuda:x": 3}',
                                     '{"%s": {"speedups": [1]}}' % FP,
                                     '{"%s": {"speedups": {"a": "fast"}}}' % FP])
def test_corrupt_or_absent_cache_reads_no_data(cache, content):
    if content is not None:
        cache.parent.mkdir(parents=True)
        cache.write_text(content)
    assert _both("load_speedups", FP) == (None, None)
    assert _both("measured_win", "int8_per_token", fp=FP) == (None, None)


def test_base_name_and_fingerprint():
    for name in ("selective_int4_r0.25_bf16", "selective_int4", "int8_per_token",
                 "fused_hop:ternary_max"):
        assert tcache.base_name(name) == jcache.base_name(name)
    assert tcache.fingerprint("cpu") == "cpu:cpu"


def test_unwritable_cache_is_a_no_op(tmp_path, monkeypatch):
    blocker = tmp_path / "file"
    blocker.write_text("")
    monkeypatch.setenv("EDGELLM_PROBE_CACHE", str(blocker / "wins.json"))
    assert tcache.record([{"codec": "int8_per_token", "roundtrip_speedup_vs_jnp_raw": 2.0}],
                         fp=FP) is None


@pytest.fixture
def on_card(cache, monkeypatch):
    """The gate as it decides for the card: the fingerprint is the H100's,
    whatever device the test runs on."""
    monkeypatch.setattr(tcache, "fingerprint", lambda device=None: FP)
    monkeypatch.delenv("EDGELLM_FUSED_HOP", raising=False)
    return cache


TWINS = ["int8_per_token_pallas", "int4_per_channel_pallas", "fp32"]
PLAIN = ["int8_per_token", "int4_per_channel", "fp32"]


@pytest.mark.parametrize("recorded,device,want", [
    (None, "cuda", TWINS), (0.5, "cuda", TWINS), (84.0, "cuda", TWINS),
    (None, "cpu", PLAIN), (0.5, "cpu", PLAIN)])
def test_card_takes_every_twin_whatever_the_cache(on_card, recorded, device, want):
    """On a CUDA device every codec with a kernel twin runs the twin: a
    recorded loss is a finding of the probe, never a plain codec on the
    card. The CPU keeps the plain codecs, and an explicit ``*_pallas`` name
    is honoured on both."""
    if recorded is not None:
        tcache.record([{"codec": "int4_per_channel", "roundtrip_speedup_vs_jnp_raw": recorded},
                       {"codec": "int8_per_token", "roundtrip_speedup_vs_jnp_raw": recorded}],
                      fp=FP)
    got = tsplit.apply_default_codec_backend(PLAIN, device)
    assert [c.name for c in got] == want
    assert tsplit.apply_default_codec_backend(["ternary_mean_pallas"], device)[0].name == \
        "ternary_mean_pallas"


def test_probes_on_the_cpu_check_parity_and_record_nothing(cache):
    """Off the card both probes hold every twin and fused hop to its plain
    path (integer leaves bit for bit, floats within 2 ulp, the fused hop
    equal to the separate one) and skip timing: no cache is written."""
    shape = dict(batch=2, seq=8, dim=64, device="cpu")
    codecs = pallas_probe.probe_all(**shape)["codecs"]
    assert [r["codec"] for r in codecs] == list(pallas_probe.PROBE_CODECS) + ["selective_int4"]
    for row in codecs[:-1]:
        assert row["twin"] == row["codec"] + "_pallas" and "timing_skipped" in row
        assert row["encode_max_ulp"] <= 2 and row["decode_max_ulp"] <= 2
    hops = pallas_probe.probe_fused_hops(**shape)
    assert hops["probe_cache"] is None and not cache.exists()
    assert sorted(h["codec"] for h in hops["hops"]) == sorted(fh.FUSED_CAPABLE)
    for row in hops["hops"]:
        assert row["mode"] == "wire" and row["fused_equals_fallback"]
        assert row["probe_decision"] == {"measured_win": None, "win_margin": 1.05}


@pytest.mark.parametrize("ratio,want", [(None, None), (1.049, None), (1.05, "remote"),
                                        (3.0, "remote")])
def test_fused_hop_plan_follows_the_cache(on_card, ratio, want):
    """Unset ``EDGELLM_FUSED_HOP`` on a CUDA source fuses exactly where the
    recorded ``fused_hop:<base>`` ratio clears WIN_MARGIN: "remote" (K8)
    for int8_per_token, "wire" for the other capable bases."""
    if ratio is not None:
        tcache.record([{"codec": "fused_hop:int8_per_token",
                        "roundtrip_speedup_vs_jnp_raw": ratio},
                       {"codec": "fused_hop:int4_per_token",
                        "roundtrip_speedup_vs_jnp_raw": ratio}], fp=FP)
    for base, mode in (("int8_per_token", "remote"), ("int4_per_token", "wire")):
        codec = get_wire_codec(base + "_pallas")
        plan = fh.fused_hop_plan(codec, device="cuda")
        if want is None:
            assert plan is None
        else:
            assert (plan.mode, plan.base, plan.reason) == (
                mode, base, "probe-cache measured win on this chip")
        # the CPU never fuses by default, and an active link always refuses
        assert fh.fused_hop_plan(codec, device="cpu") is None
        assert fh.fused_hop_plan(codec, device="cuda", link_active=True) is None
    # a base without a recorded ratio stays separate
    assert fh.fused_hop_plan(get_wire_codec("ternary_max"), device="cuda") is None


def test_fused_hop_env_overrides_the_cache(on_card, monkeypatch):
    tcache.record([{"codec": "fused_hop:int8_per_token",
                    "roundtrip_speedup_vs_jnp_raw": 2.0}], fp=FP)
    codec = get_wire_codec("int8_per_token_pallas")
    monkeypatch.setenv("EDGELLM_FUSED_HOP", "0")
    assert fh.fused_hop_plan(codec, device="cuda") is None
    monkeypatch.setenv("EDGELLM_FUSED_HOP", "wire")
    assert fh.fused_hop_plan(codec, device="cuda").reason == "forced: EDGELLM_FUSED_HOP=wire"
    monkeypatch.setenv("EDGELLM_FUSED_HOP", "wire")
    assert fh.fused_hop_plan(codec, device="cuda", link_active=True) is None


def test_split_runtime_under_a_link_refuses_fusion(on_card, monkeypatch):
    """An active faulty link owns the hop: a recorded win and a forced mode
    both leave every plan None; the same runtime without the link fuses."""
    from edgellm_tpu_torch.codecs.faults import FaultConfig
    from edgellm_tpu_torch.models import configs as tcfg

    tcache.record([{"codec": "fused_hop:int8_per_token",
                    "roundtrip_speedup_vs_jnp_raw": 2.0}], fp=FP)
    cfg = tcfg.PRESETS["tiny-qwen2"]
    split = tsplit.SplitConfig((1,), ("int8_per_token",))
    monkeypatch.setenv("EDGELLM_FUSED_HOP", "wire")
    rt = tsplit.SplitRuntime(cfg, split, ["cpu"] * 2, faults=FaultConfig(drop_rate=0.1))
    assert rt.link is not None and rt.fused_plans == [None]
    monkeypatch.delenv("EDGELLM_FUSED_HOP")
    rt = tsplit.SplitRuntime(cfg, split, ["cpu"] * 2, faults=FaultConfig())
    assert rt.link is None and rt.link_counters() is None  # zero rates: no link
    assert rt.fused_plans == [None]  # the CPU: never fused by default
    assert torch.device(rt.devices[0]).type == "cpu"
