"""The port's ring selective codec (``codecs/ring_codecs.py``), the dense
codec's ``scale_fn`` hook, the stage x seq split eval and
``tools/ring_mode_gap.py`` against the TPU package's, on the CPU.

The reference encodes a ring payload inside ``shard_map`` (jitted here),
one shard a device; the port encodes the list of shards at once. Every
payload leaf is held to the reference's in-mesh buffer of its shard bit for
bit, ``payload_bytes`` to the buffers' bytes, and the global mode's decode
to the dense ``selective_int4``'s, in both importance formats. The split
eval over 4 shards (a window that needs padding included) holds PPL within
rtol 1e-5 of the reference's, the chunk count, the codec names and the byte
totals exactly. The tool runs tiny; its global-mode NLL equals the dense
selective split's within 1e-4 (the ring and the dense attention differ by
float32 roundoff, and the hop's high tokens round to bf16).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from edgellm_tpu.codecs.packing import selective_int4 as j_selective_int4
from edgellm_tpu.codecs.ring_codecs import ring_selective_int4 as j_ring_selective_int4
from edgellm_tpu.eval.split_eval import run_split_eval as j_split_eval
from edgellm_tpu.models import init_params as j_init
from edgellm_tpu.models.configs import tiny_config as jtiny
from edgellm_tpu.parallel import ring as jring
from edgellm_tpu.utils.jax_compat import shard_map
from edgellm_tpu_torch.codecs.packing import sanitize_hidden, selective_int4
from edgellm_tpu_torch.codecs.ring_codecs import RingWireCodec, ring_selective_int4
from edgellm_tpu_torch.eval.split_eval import run_split_eval
from edgellm_tpu_torch.models import configs as tcfg
from edgellm_tpu_torch.models import nll_from_logits
from edgellm_tpu_torch.models.convert import params_from_jax_numpy
from edgellm_tpu_torch.parallel import SplitConfig, SplitRuntime, importance_sp
from edgellm_tpu_torch.tools.ring_mode_gap import measure

B, S, D, N_SEQ = 2, 32, 32, 4


def _leaf_bytes(x) -> np.ndarray:
    """A leaf's bytes: a JAX / numpy array or a torch tensor (bf16 as words)."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy()
    a = np.asarray(x.view(jnp.uint16) if x.dtype == jnp.bfloat16 else x)
    return a.view(np.uint8)


def _inputs(per_row: bool, dtype=np.float32):
    h = np.random.default_rng(5).normal(size=(B, S, D)).astype(dtype)
    imp = np.random.default_rng(6).random((B, S) if per_row else (S,)).astype(np.float32)
    return h, np.round(imp * 8) / 8  # ties, broken by position


def _split(x: np.ndarray) -> list:
    return [torch.from_numpy(np.ascontiguousarray(p)) for p in np.split(x, N_SEQ, axis=-1)]


def _port_payloads(codec, h, imp):
    shards = [torch.from_numpy(np.ascontiguousarray(p)) for p in np.split(h, N_SEQ, axis=1)]
    return codec.encode(shards, _split(imp))


@pytest.mark.parametrize("per_row", [True, False], ids=["per_row", "shared"])
@pytest.mark.parametrize("mode", ["global", "local"])
def test_ring_payloads_match_reference_buffers(mode, per_row):
    """Every shard's payload leaves, bit for bit, dtype and shape, against
    the reference's in-mesh buffers; ``payload_bytes`` equal to their bytes
    and to the reference's count; each shard's decode the reference's."""
    h, imp = _inputs(per_row)
    jc = j_ring_selective_int4(0.25, "bf16", n_seq=N_SEQ, mode=mode)
    keys = ("low", "scale", "high", "idx" if mode == "global" else "order")
    specs = {k: P("seq") for k in keys}  # each leaf concatenated over the shards
    mesh = jring.make_seq_mesh(N_SEQ)
    jpay = jax.jit(shard_map(jc.encode, mesh=mesh,
                             in_specs=(P(None, "seq"), P(None, "seq") if per_row else P("seq")),
                             out_specs=specs, check_vma=False))(jnp.asarray(h), jnp.asarray(imp))
    jdec = np.asarray(jax.jit(shard_map(jc.decode, mesh=mesh, in_specs=(specs,),
                                        out_specs=P(None, "seq"), check_vma=False))(jpay))
    codec = ring_selective_int4(0.25, "bf16", n_seq=N_SEQ, mode=mode)
    pays = _port_payloads(codec, h, imp)
    assert len(pays) == N_SEQ and all(sorted(p) == sorted(keys) for p in pays)
    for k in keys:
        want = np.split(np.asarray(jpay[k]), N_SEQ, axis=0)
        want_bytes = np.split(_leaf_bytes(jpay[k]), N_SEQ, axis=0)
        for i, p in enumerate(pays):
            assert tuple(p[k].shape) == want[i].shape, (k, i)
            assert str(p[k].dtype).split(".")[-1] == str(jpay[k].dtype), (k, i)
            np.testing.assert_array_equal(_leaf_bytes(p[k]), want_bytes[i], err_msg=f"{k} {i}")
    actual = sum(t.numel() * t.element_size() for p in pays for t in p.values())
    assert actual == codec.payload_bytes((B, S, D), per_row=per_row) \
        == jc.payload_bytes((B, S, D), per_row=per_row)
    np.testing.assert_array_equal(torch.cat([codec.decode(p) for p in pays], dim=1).numpy(),
                                  jdec)


@pytest.mark.parametrize("dtype", [np.float32, "bf16"])
@pytest.mark.parametrize("per_row", [True, False], ids=["per_row", "shared"])
def test_ring_global_decode_equals_dense_selective(per_row, dtype):
    """mode="global" decodes to the dense codec's hidden bit for bit given
    the same importance, at ratios from 0 (no low slot) to 1."""
    h, imp = _inputs(per_row)
    ht = torch.from_numpy(h).to(torch.bfloat16 if dtype == "bf16" else torch.float32)
    for ratio in (0.0, 0.1, 0.25, 0.5, 1.0):
        dense = selective_int4(ratio, "bf16")
        want = dense.decode(dense.encode(ht, torch.from_numpy(imp)))
        ring = ring_selective_int4(ratio, "bf16", n_seq=N_SEQ, mode="global")
        pays = ring.encode(list(torch.chunk(ht, N_SEQ, dim=1)), _split(imp))
        got = torch.cat([ring.decode(p) for p in pays], dim=1)
        assert got.dtype == want.dtype and torch.equal(got, want), ratio


def test_local_mode_is_the_dense_format_on_an_agreed_scale():
    """mode="local": each shard's payload is the dense codec's over that
    shard, with the scale all shards agree on (the max of their maxima), so
    the decode is the dense decode of each shard on one grid."""
    h, imp = _inputs(True)
    pays = _port_payloads(ring_selective_int4(0.5, "bf16", n_seq=N_SEQ, mode="local"), h, imp)
    shards = np.split(h, N_SEQ, axis=1)
    maxima = []
    for p, hs, im in zip(pays, shards, _split(imp)):
        dense = selective_int4(0.5, "bf16").encode(torch.from_numpy(np.ascontiguousarray(hs)), im)
        assert sorted(p) == sorted(dense) and torch.equal(p["order"], dense["order"])
        assert torch.equal(p["high"], dense["high"])
        maxima.append(dense["scale"])
    agreed = torch.stack(maxima).amax(dim=0)
    for p in pays:
        assert torch.equal(p["scale"], agreed)


def test_scale_fn_hook_matches_reference():
    """``selective_int4(scale_fn=)`` swaps the scale reduction as the
    reference's hook does; without it the payload is unchanged."""
    h, imp = _inputs(True)
    for per_row in (True, False):
        im = imp if per_row else imp[0]
        fixed = lambda low, nonempty, per_row: jnp.full(  # noqa: E731
            (low.shape[0],) if per_row else (), 3.0, jnp.float32)
        want = jax.jit(j_selective_int4(0.25, "bf16", scale_fn=fixed).encode)(
            jnp.asarray(h), jnp.asarray(im))
        got = selective_int4(0.25, "bf16", scale_fn=lambda low, nonempty, per_row: torch.full(
            (low.shape[0],) if per_row else (), 3.0)).encode(torch.from_numpy(h),
                                                             torch.from_numpy(im))
        plain = selective_int4(0.25, "bf16").encode(torch.from_numpy(h), torch.from_numpy(im))
        for k in want:
            np.testing.assert_array_equal(_leaf_bytes(got[k]), _leaf_bytes(want[k]), err_msg=k)
        assert float(got["scale"].reshape(-1)[0]) == 3.0 != float(plain["scale"].reshape(-1)[0])


def test_ring_codec_validation_and_saturation():
    """The reference's refusals, and the dense codecs' saturation shard by
    shard."""
    with pytest.raises(ValueError, match="ratio"):
        ring_selective_int4(1.5, n_seq=2)
    with pytest.raises(ValueError, match="mode"):
        ring_selective_int4(0.5, n_seq=2, mode="nope")
    with pytest.raises(ValueError, match="n_seq"):
        ring_selective_int4(0.5, n_seq=0)
    big = ring_selective_int4(0.25, n_seq=2)
    with pytest.raises(ValueError, match="S <= 32767"):
        big.encode([torch.zeros(1, 16384, 2)] * 2, [torch.zeros(16384)] * 2)
    assert isinstance(big, RingWireCodec) and big.needs_importance and not big.batch_invariant
    h, imp = _inputs(False)
    h[0, 3, 5], h[1, 20, 0], h[0, 30, 7] = np.nan, np.inf, -1e38
    for mode in ("global", "local"):
        codec = ring_selective_int4(0.25, "bf16", n_seq=N_SEQ, mode=mode)
        pays = _port_payloads(codec, h, imp)
        clean = _port_payloads(codec, sanitize_hidden(torch.from_numpy(h)).numpy(), imp)
        for p, c in zip(pays, clean):
            assert all(torch.equal(p[k], c[k]) for k in p)
            assert torch.isfinite(codec.decode(p)).all()


@pytest.fixture(scope="module")
def qwen():
    kw = dict(num_layers=4, hidden_size=32, num_heads=4, vocab_size=128)
    jc, tc = jtiny("qwen2", **kw), tcfg.tiny_config("qwen2", **kw)
    jp = j_init(jc, jax.random.key(2))
    return jc, tc, jp, params_from_jax_numpy(tc, jax.tree_util.tree_map(np.asarray, jp),
                                             device="cpu")


def test_split_eval_ring_matches_reference(qwen):
    """run_split_eval over stage 2 x seq 4 with the selective hop (per-row
    importance from the ring at window batch 2) against the reference's: a
    group of two full windows, then the last window of 18 tokens
    (right-padded to 20 with masked targets); PPL, chunks, codec names,
    mesh, the pad accounting and the byte totals."""
    jc, tc, jp, tp = qwen
    corpus = np.random.default_rng(11).integers(0, 128, 32 + 16 + 2)
    kw = dict(cuts=(1,), hop_codecs=("selective_int4:0.25:bf16",), max_length=32, stride=16,
              time_hops=False, importance_method="last_row", n_seq=N_SEQ, window_batch=2)
    want = j_split_eval(jc, jp, corpus, mesh=jring.make_sp_stage_mesh(2, N_SEQ), **kw)
    got = run_split_eval(tc, tp, corpus, device="cpu", **kw)
    np.testing.assert_allclose(got["ppl"], want["ppl"], rtol=1e-5)
    for key in ("chunks", "n_tokens", "hop_codecs", "cuts", "measured_hop_bytes_total",
                "bytes_per_token_per_hop", "real_fwd_tokens", "pad_fraction", "mesh"):
        assert got[key] == want[key], key
    assert got["pad_fraction"] > 0 and got["mesh"] == {"stage": 2, "seq": N_SEQ}


def test_split_eval_ring_refusals(qwen):
    """stage_failure and pipeline need n_seq 1; the local spec only parses
    under the ring, and a ring spec pinned to a kernel has none."""
    _, tc, _, tp = qwen
    corpus = np.random.default_rng(11).integers(0, 128, 64)
    kw = dict(cuts=(1,), hop_codecs=("int8_per_token",), max_length=32, stride=16,
              device="cpu", n_seq=2)
    with pytest.raises(ValueError, match="no failover re-planning"):
        run_split_eval(tc, tp, corpus, stage_failure={"stage": 1, "at_step": 0}, **kw)
    with pytest.raises(ValueError, match="drop pipeline or set n_seq=1"):
        run_split_eval(tc, tp, corpus, pipeline={"num_microbatches": 2}, window_batch=2, **kw)
    with pytest.raises(ValueError, match="no ring"):
        run_split_eval(tc, tp, corpus, **{**kw, "hop_codecs": ("selective_int4_pallas:0.25",)})


def test_ring_mode_gap_tiny(qwen):
    """tools/ring_mode_gap.measure at a tiny shape on the CPU: one record a
    ratio, |dNLL| the difference of the two NLLs and inside the reference
    test's 0.02, and the global mode's NLL that of the dense selective
    split given the same (ring) importance."""
    _, tc, _, tp = qwen
    rows = measure(tc, seq=32, n_seq=N_SEQ, cut=1, ratios=(0.25, 0.5), windows=1, params=tp,
                   device="cpu")
    assert [(r["window"], r["ratio"]) for r in rows] == [(0, 0.25), (0, 0.5)]
    ids = torch.as_tensor(np.random.default_rng(0).integers(0, tc.vocab_size, (1, 32)))
    imp = importance_sp(tc, tp, ids, N_SEQ, "last_row", device="cpu")[1, 0]
    for r in rows:
        assert r["dnll"] == abs(r["nll_local"] - r["nll_global"]) <= 0.02
        rt = SplitRuntime(tc, SplitConfig((1,), (selective_int4(r["ratio"], "bf16"),)),
                          ["cpu"] * 2)
        dense = float(nll_from_logits(rt.forward(rt.place_params(tp), ids,
                                                 hop_importance=[imp]), ids))
        np.testing.assert_allclose(r["nll_global"], dense, rtol=1e-4)
