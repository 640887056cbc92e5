"""The port's wire format and fused hops against the TPU package's, on the
CPU.

- ``codecs/wire_format.py``: the flat sealed buffer (``to_wire``) and
  ``payload_checksum`` of every registry codec's payload, held BYTE FOR BYTE
  against ``edgellm_tpu/codecs/wire_format.py`` on identical inputs (numpy
  from a seed), and ``verify_payload`` catching a flipped byte anywhere and
  a zeroed canary.
- ``codecs/fused_hop.py``: the gate ladder case by case against the
  reference's (the card in the TPU's place), the fused "wire" hop equal bit
  for bit to the separate hop, K8's plain version (the wire path) giving the
  reference's sealed buffer byte for byte, and ``SplitRuntime`` under
  ``EDGELLM_FUSED_HOP=wire`` against the reference's runtime on the CPU mesh
  (logits rtol 1e-5, atol 1e-5, the split tolerance of test_torch_split),
  with the hidden keeping bf16 across a fused hop.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from edgellm_tpu.codecs import packing as jpk
from edgellm_tpu.codecs import pallas_kernels as jpl
from edgellm_tpu.codecs import probe_cache
from edgellm_tpu.codecs import wire_format as jwf
from edgellm_tpu.models import init_params as j_init
from edgellm_tpu.models.configs import PRESETS as JPRESETS
from edgellm_tpu.parallel import SplitConfig as JSplitConfig
from edgellm_tpu.parallel import SplitRuntime as JSplitRuntime
from edgellm_tpu.parallel import make_stage_mesh
from edgellm_tpu_torch.codecs import codec_kernels as tck
from edgellm_tpu_torch.codecs import fused_hop as tfh
from edgellm_tpu_torch.codecs import packing as tpk
from edgellm_tpu_torch.codecs import wire_format as twf
from edgellm_tpu_torch.models import configs as tcfg
from edgellm_tpu_torch.models.convert import params_from_jax_numpy
from edgellm_tpu_torch.parallel import SplitConfig, SplitRuntime
from edgellm_tpu_torch.parallel import split as tsplit


def _hidden(seed, b=2, s=16, d=64):
    h = (np.random.default_rng(seed).normal(size=(b, s, d)) * 3).astype(np.float32)
    h[0, 1] = 0.0
    h[-1, 2] = 1.5
    h[0, 3, :3] = [np.nan, np.inf, -np.inf]
    return h


def _importance(seed, s=16):
    return np.round(np.random.default_rng(seed).random(s).astype(np.float32) * 8) / 8


def _codec_pair(name):
    if name.startswith("selective"):
        return jpk.selective_int4(0.25, "bf16"), tpk.selective_int4(0.25, "bf16")
    return jpk.get_wire_codec(name), tpk.get_wire_codec(name)


def _payloads(name, dtype):
    """The same hidden through the reference's jitted codec and the port's."""
    b = 1 if name.startswith("ternary_mean") else 2  # bit-exact at batch 1
    h = _hidden(3, b=b)
    jc, tc = _codec_pair(name)
    jh = jnp.asarray(h).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    th = torch.from_numpy(h).to(torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    if jc.needs_importance:
        imp = _importance(4)
        return jc, tc, jh, th, jax.jit(jc.encode)(jh, jnp.asarray(imp)), \
            tc.encode(th, torch.from_numpy(imp))
    return jc, tc, jh, th, jax.jit(jc.encode)(jh), tc.encode(th)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(tpk.WIRE_CODECS) + ["selective_int4"])
def test_sealed_wire_buffer_bit_exact(name, dtype):
    """Every registry codec's sealed flat buffer and checksum equal the
    reference's, byte for byte; WireFormat's byte accounting too."""
    jc, tc, jh, th, jp, tp = _payloads(name, dtype)
    want_crc = int(jwf.payload_checksum(jp))
    assert int(twf.payload_checksum(tp)) == want_crc
    want = np.asarray(jwf.flatten_bytes(jwf.seal_payload(jp)))
    sealed = twf.seal_payload(tp)
    assert sealed["canary"].dtype == torch.uint32 and sealed["crc"].dtype == torch.uint32
    np.testing.assert_array_equal(twf.flatten_bytes(sealed).numpy(), want)
    assert twf.tree_nbytes(sealed) == jwf.tree_nbytes(jwf.seal_payload(jp)) == want.size
    if not jc.needs_importance:
        wf = twf.WireFormat.for_codec(tc, th.shape, th.dtype)
        jf = jwf.WireFormat.for_codec(jc, jh.shape, jh.dtype)
        np.testing.assert_array_equal(wf.to_wire(sealed).numpy(), want)
        assert (wf.wire_nbytes, wf.payload_nbytes) == (jf.wire_nbytes, jf.payload_nbytes)
        assert wf.payload_nbytes == tc.payload_bytes(th.shape, th.dtype)
        back = wf.from_wire(torch.from_numpy(want.copy()))
        assert bool(twf.verify_payload(back))
        for k in tp:
            np.testing.assert_array_equal(back["p"][k].view(torch.uint8).numpy(),
                                          tp[k].contiguous().view(torch.uint8).numpy())


@pytest.mark.parametrize("where", ["canary", "crc", "first", "middle", "last"])
@pytest.mark.parametrize("name", ["int8_per_token", "int4_per_channel", "ternary_max"])
def test_verify_catches_a_flipped_byte_and_a_zeroed_canary(name, where):
    jc, tc, jh, th, jp, tp = _payloads(name, "float32")
    wf = twf.WireFormat.for_codec(tc, th.shape)
    buf = wf.to_wire(twf.seal_payload(tp))
    pos = {"canary": 0, "crc": 5, "first": 8, "middle": buf.numel() // 2,
           "last": buf.numel() - 1}[where]
    bad = buf.clone()
    bad[pos] ^= 0x40
    assert not bool(twf.verify_payload(wf.from_wire(bad)))
    assert not bool(jwf.verify_payload(jwf.WireFormat.for_codec(jc, jh.shape)
                                       .from_wire(jnp.asarray(bad.numpy()))))
    zeroed = buf.clone()
    zeroed[:4] = 0
    assert not bool(twf.verify_payload(wf.from_wire(zeroed)))
    dropped = torch.zeros_like(buf)  # a dropped payload: checksum 0 = crc 0
    assert not bool(twf.verify_payload(wf.from_wire(dropped)))
    assert bool(twf.verify_payload(wf.from_wire(buf)))


def test_checksum_weights_wrap_like_uint32():
    """Positions and salts beyond 2**32 / 2 wrap exactly as the reference's
    uint32 arithmetic (large salts, a long leaf)."""
    leaf = np.random.default_rng(0).integers(0, 256, 70_000).astype(np.uint8)
    for salt in (0, 0x9E3779B1, (5 * 0x9E3779B1) & 0xFFFFFFFF, 0xFFFFFFF0):
        assert int(twf._leaf_crc(torch.from_numpy(leaf), salt)) == \
            int(jwf._leaf_crc(jnp.asarray(leaf), salt))


# ---------- the gate ladder (tests/test_fused_hop.py's cases) ----------

#: (env, codec, link_active, the port's device, the reference's backend)
LADDER = [
    ("", "int8_per_token", False, "cpu", "cpu"),          # default refuses off the card
    ("wire", "int8_per_token", False, "cpu", "cpu"),      # forced wire
    ("remote", "int8_per_token", False, "cpu", "cpu"),    # remote needs the card
    ("remote", "int8_per_token", False, "cuda", "tpu"),
    ("remote", "int4_per_token", False, "cuda", "tpu"),   # remote only where capable
    ("1", "int8_per_token", False, "cpu", "cpu"),         # best mode: wire off the card
    ("1", "int8_per_token", False, "cuda", "tpu"),        # ... remote on it
    ("1", "ternary_mean", False, "cuda", "tpu"),
    ("wire", "int8_per_token", True, "cpu", "cpu"),       # an active link owns the hop
    ("wire", "selective_int4", False, "cpu", "cpu"),      # importance sidecar
    ("wire", "fp32", False, "cpu", "cpu"),                # no kernel twin
    ("wire", "int8_per_token_pallas", False, "cuda", "tpu"),
    ("0", "int8_per_token", False, "cuda", "tpu"),        # hard off
    ("", "int8_per_token", False, "cuda", "tpu"),         # default: no probe data
]


@pytest.mark.parametrize("env,name,link,device,backend", LADDER,
                         ids=[f"{e or 'default'}-{n}-{d}{'-link' if l else ''}"
                              for e, n, l, d, _ in LADDER])
def test_fused_hop_plan_ladder_matches_reference(monkeypatch, env, name, link, device,
                                                 backend):
    monkeypatch.setenv("EDGELLM_FUSED_HOP", env)
    # the reference's default consults its probe cache: give it none, the
    # port's standing (it has no probe cache yet)
    monkeypatch.setattr(probe_cache, "measured_win", lambda key: None)
    jc, tc = _codec_pair(name)
    want = jpl.fused_hop_plan(jc, link_active=link, backend=backend)
    got = tfh.fused_hop_plan(tc, link_active=link, device=device)
    assert (None if got is None else (got.mode, got.base, got.reason)) == \
        (None if want is None else (want.mode, want.base, want.reason))
    assert tfh.FUSED_CAPABLE == jpl.FUSED_CAPABLE and tfh.REMOTE_CAPABLE == jpl.REMOTE_CAPABLE
    assert tfh.fused_hop_plan(None) is None


# ---------- the hops ----------


@pytest.mark.parametrize("base", sorted(tfh.FUSED_CAPABLE))
def test_fused_wire_hop_bit_identical_to_separate_hop(base, monkeypatch):
    """The fused wire hop decodes the same bytes as the separate hop (and
    keeps the hidden's dtype); a corrupted arrival keeps the hidden."""
    codec = tpk.get_wire_codec(base)
    h = torch.from_numpy(_hidden(7, b=1))
    fused = tfh.fused_wire_hop(codec, h, "cpu")
    separate = tsplit._hop(codec, h, None, "cpu")
    torch.testing.assert_close(fused, separate, atol=0, rtol=0)
    assert not torch.equal(fused, h)
    hb = h.to(torch.bfloat16)
    assert tfh.fused_wire_hop(codec, hb, "cpu").dtype == torch.bfloat16

    def corrupt(buf, dst):
        buf = buf.clone()
        buf[buf.numel() // 2] ^= 0x10
        return buf

    monkeypatch.setattr(tfh, "_transport", corrupt)
    torch.testing.assert_close(tfh.fused_wire_hop(codec, h, "cpu"), h, atol=0, rtol=0,
                               equal_nan=True)


@pytest.mark.parametrize("n,d", [(1, 64), (7, 64), (96, 896), (4096, 64), (5, 6)])
def test_remote_hop_plain_is_the_reference_wire_buffer(n, d):
    """K8's plain version: the reference's sealed int8_per_token buffer byte
    for byte, K4's decode of it, ok; the receive half over a flipped byte
    says not ok."""
    rng = np.random.default_rng(n + d)
    x = (rng.normal(size=(n, d)) * 3).astype(np.float32)
    x[0] = 1.25  # a constant row: scale 0
    x = tpk.sanitize_hidden(torch.from_numpy(x))
    out, ok, buf = tfh.remote_hop(x)
    jc = jpk.get_wire_codec("int8_per_token")
    jx = jnp.asarray(x.numpy()).reshape(1, n, d)
    jp = jax.jit(jc.encode)(jx)
    want = np.asarray(jwf.WireFormat.for_codec(jc, jx.shape).to_wire(jwf.seal_payload(jp)))
    np.testing.assert_array_equal(buf.numpy(), want)
    assert buf.numel() == tfh.remote_hop_nbytes(n, d) and bool(ok)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jax.jit(jc.decode)(jp))[0])
    torch.testing.assert_close(out, tck.int8_affine_decode_plain(*tck.int8_affine_encode_plain(x)),
                               atol=0, rtol=0)
    for pos in (0, 6, 8 + n, buf.numel() - 1):
        bad = buf.clone()
        bad[pos] ^= 0x01
        assert not bool(tfh.remote_hop_receive(bad, n, d)[1])
    again, ok2 = tfh.remote_hop_receive(buf, n, d)
    assert bool(ok2) and torch.equal(again, out)


def test_fused_remote_hop_on_the_cpu_and_two_devices():
    """remote never plans off the card; called directly on CPU tensors the
    hop runs its plain version (the same bits as the wire hop), and two
    devices raise: the NVLink peer form is not ported."""
    h = torch.from_numpy(_hidden(8, b=1))
    codec = tpk.get_wire_codec("int8_per_token")
    torch.testing.assert_close(tfh.fused_remote_hop(codec, h, "cpu"),
                               tfh.fused_wire_hop(codec, h, "cpu"), atol=0, rtol=0)
    with pytest.raises(ValueError, match="two-card remote hop not ported"):
        tfh.fused_remote_hop(codec, h, "meta")


# ---------- the split runtime ----------


@pytest.fixture(scope="module")
def qwen():
    jc, tc = JPRESETS["tiny-qwen2"], tcfg.PRESETS["tiny-qwen2"]
    jp = j_init(jc, jax.random.key(5))
    tp = params_from_jax_numpy(tc, jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jc, tc, jp, tp


def _runtimes(monkeypatch, env, cuts, codecs, jcfg, tcfg_):
    monkeypatch.setenv("EDGELLM_FUSED_HOP", env)
    jrt = JSplitRuntime(jcfg, JSplitConfig(cuts, codecs), make_stage_mesh(len(cuts) + 1))
    rt = SplitRuntime(tcfg_, SplitConfig(cuts, codecs), ["cpu"] * (len(cuts) + 1))
    return jrt, rt


@pytest.mark.parametrize("cuts,codecs", [((2,), ("int8_per_token",)),
                                         ((1, 3), ("int4_per_token", "ternary_max")),
                                         ((0, 2), ("int8_per_channel", "int4_per_channel"))])
def test_split_forward_fused_wire_matches_reference(qwen, monkeypatch, cuts, codecs):
    jc, tc, jp, tp = qwen
    jrt, rt = _runtimes(monkeypatch, "wire", cuts, codecs, jc, tc)
    assert [p.mode for p in rt.fused_plans] == [p.mode for p in jrt.fused_plans] == \
        ["wire"] * len(cuts)
    ids = np.random.default_rng(2).integers(0, 256, (2, 32))
    want = np.asarray(jrt.forward(jrt.place_params(jp), jnp.asarray(ids)))
    got = rt.forward(rt.place_params(tp), torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # fused or not, the hops decode the same bytes
    monkeypatch.setenv("EDGELLM_FUSED_HOP", "0")
    plain = SplitRuntime(tc, SplitConfig(cuts, codecs), ["cpu"] * (len(cuts) + 1))
    assert plain.fused_plans == [None] * len(cuts)
    torch.testing.assert_close(plain.forward(plain.place_params(tp), torch.from_numpy(ids)),
                               got, atol=0, rtol=0)


def test_fused_hops_keep_the_stages_in_bf16(monkeypatch):
    """bf16 weights: a fused hop returns the hidden's dtype, so every stage
    behind fused hops computes in bf16 (and holds bf16 weights), as in the
    reference; a separate hop promotes the stages after it to float32."""
    jc, tc = JPRESETS["tiny-qwen2"], tcfg.PRESETS["tiny-qwen2"]
    jp = j_init(jc, jax.random.key(2), dtype=jnp.bfloat16)
    tp = params_from_jax_numpy(tc, jax.tree_util.tree_map(np.asarray, jp), device="cpu",
                               dtype=torch.bfloat16)
    seen = []
    real = tsplit.run_layers

    def spy(cfg, params, hidden, **kw):
        seen.append(hidden.dtype)
        return real(cfg, params, hidden, **kw)

    monkeypatch.setattr(tsplit, "run_layers", spy)
    ids = np.random.default_rng(0).integers(0, 256, (2, 32))
    # int8 hops: an int4 step (max / 7) turns a one-bf16-step difference
    # between the frameworks into a visible one
    codecs = ("int8_per_token", "int8_per_channel")
    jrt, rt = _runtimes(monkeypatch, "wire", (1, 3), codecs, jc, tc)
    placed = rt.place_params(tp)
    assert all(t.dtype == torch.bfloat16 for st in placed["stages"] for t in st.values())
    got = rt.forward(placed, torch.from_numpy(ids))
    assert seen == [torch.bfloat16] * 3
    want = np.asarray(jrt.forward(jrt.place_params(jp), jnp.asarray(ids)))
    # bf16 stages round at other places in the two frameworks: the loose
    # check of test_torch_split's bf16 test (measured 9e-3 here)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-2)
    seen.clear()
    rt.fused_plans[1] = None  # a separate second hop promotes the last stage
    placed = rt.place_params(tp)
    assert placed["stages"][2]["wq"].dtype == torch.float32
    rt.forward(placed, torch.from_numpy(ids))
    assert seen == [torch.bfloat16, torch.bfloat16, torch.float32]
