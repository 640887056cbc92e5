"""The continuous batcher's stream checkpoints and the split-paged batcher
under a faulty link, the port against the JAX package on the CPU:
``checkpoint_stream`` / ``restore_stream`` in both batcher modes and at the
fp, int8 and int4 tiers (a stream snapshotted mid-flight and restored into
another pool geometry continues to its uninterrupted tokens; a quantized
tier's codes and scales come back bit for bit; another tier is refused),
``checkpoint_dir`` snapshotting every eviction, each package restoring the
other's file, and the split batcher's ragged step over the link (each step
keyed by the deepest slot's length) with the reference's tokens and
counters.

One set of weights (the reference's ``init_params``: 6 layers, D = 32, 4
heads, V = 128) crosses with ``params_from_jax_numpy``. Tolerances: tokens
and counters exactly; restored pages bit for bit.
"""
import contextlib
import os

import numpy as np
import pytest
import torch

import jax

from edgellm_tpu.codecs.faults import FaultConfig as JFaultConfig
from edgellm_tpu.codecs.faults import LinkPolicy as JLinkPolicy
from edgellm_tpu.models import init_params as j_init
from edgellm_tpu.models.configs import tiny_config as j_tiny
from edgellm_tpu.parallel import SplitConfig as JSplitConfig
from edgellm_tpu.parallel import SplitRuntime as JSplitRuntime
from edgellm_tpu.parallel import make_stage_mesh
from edgellm_tpu.serve import batching as jb
from edgellm_tpu_torch.codecs.faults import FaultConfig, LinkPolicy
from edgellm_tpu_torch.models import tiny_config as t_tiny
from edgellm_tpu_torch.models.convert import params_from_jax_numpy
from edgellm_tpu_torch.models.paged_kv import KVTierMismatchError
from edgellm_tpu_torch.parallel import SplitConfig, SplitRuntime
from edgellm_tpu_torch.serve import batching as tb
from edgellm_tpu_torch.serve.recovery import CheckpointError, CheckpointTierMismatchError

JCFG = j_tiny("qwen2", num_layers=6, hidden_size=32, num_heads=4, vocab_size=128)
TCFG = t_tiny("qwen2", num_layers=6, hidden_size=32, num_heads=4, vocab_size=128)
GEOM = dict(page_size=4, num_pages=24, max_slots=3, pages_per_slot=5)
OTHER = dict(page_size=8, num_pages=12, max_slots=2, pages_per_slot=3)
NEW = 8


@contextlib.contextmanager
def _separate_hops():
    saved = os.environ.get("EDGELLM_FUSED_HOP")
    os.environ["EDGELLM_FUSED_HOP"] = "0"
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("EDGELLM_FUSED_HOP")
        else:
            os.environ["EDGELLM_FUSED_HOP"] = saved


@pytest.fixture(scope="module")
def weights():
    jp = j_init(JCFG, jax.random.key(1))
    tp = params_from_jax_numpy(TCFG, jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jp, tp


def _prompts():
    rng = np.random.default_rng(6)
    return [rng.integers(1, 128, n).astype(np.int32) for n in (5, 8, 3)]


def _batcher(pkg, weights, mode, kv_codec="fp", link=None, **geom):
    jp, tp = weights
    kw = dict({**GEOM, **geom}, kv_codec=kv_codec)
    if mode == "local":
        return (jb.ContinuousBatcher(JCFG, jp, jb.BatchingConfig(**kw)) if pkg == "ref" else
                tb.ContinuousBatcher(TCFG, tp, tb.BatchingConfig(**kw)))
    cuts, codecs = (1, 3), ("int8_per_token", "fp32")
    with _separate_hops():
        if pkg == "ref":
            rt = JSplitRuntime(JCFG, JSplitConfig(cuts=cuts, hop_codecs=codecs),
                               make_stage_mesh(3),
                               **({} if link is None else dict(
                                   faults=JFaultConfig(**link[0]),
                                   policy=JLinkPolicy(**link[1]))))
            return jb.ContinuousBatcher(JCFG, jp, jb.BatchingConfig(**kw), split_runtime=rt,
                                        placed_params=rt.place_params(jp))
        rt = SplitRuntime(TCFG, SplitConfig(cuts=cuts, hop_codecs=codecs), ["cpu"] * 3,
                          **({} if link is None else dict(faults=FaultConfig(**link[0]),
                                                          policy=LinkPolicy(**link[1]))))
    return tb.ContinuousBatcher(TCFG, tp, tb.BatchingConfig(**kw), split_runtime=rt,
                                placed_params=rt.place_params(tp))


def _submit(b):
    return [b.submit(p, NEW, temperature=0.7 if i % 2 else 0.0, rng_seed=30 + i)
            for i, p in enumerate(_prompts())]


@pytest.mark.parametrize("mode,kv_codec", [("local", "fp"), ("split", "fp"),
                                           ("split", "int8_per_channel"),
                                           ("split", "int4_per_channel")])
def test_stream_checkpoint_restores_to_the_uninterrupted_tokens(weights, tmp_path, mode,
                                                                kv_codec):
    """Stream 1 snapshotted after 3 steps, restored into a batcher of
    another geometry: it finishes with the uninterrupted run's tokens; a
    quantized tier's pages (codes and scales) come back bit for bit; a
    batcher at another tier refuses the file with the tier error."""
    clean = _batcher("port", weights, mode, kv_codec)
    sids = _submit(clean)
    want = clean.run()
    b = _batcher("port", weights, mode, kv_codec)
    _submit(b)
    for _ in range(3):
        b.step()
    path = str(tmp_path / "s1.ckpt")
    before = b._gather_state(b._streams[sids[1]].slot)
    b.checkpoint_stream(sids[1], path)
    other = _batcher("port", weights, mode, kv_codec, **OTHER)
    sid = other.restore_stream(path)
    st = other._streams[sid]
    assert st.tokens == b._streams[sids[1]].tokens
    other.step()  # admits the resume payload, then one step
    if kv_codec != "fp":
        n = int(before["length"])
        idx = other.pool._flat_indices(st.slot, n)
        got = other.rt.gather_paged_packed(other._split_pool, idx)
        for g, w in zip(got, (before[k] for k in ("k_codes", "v_codes", "k_scale", "v_scale"))):
            np.testing.assert_array_equal(g[:, :, :n], w)
    np.testing.assert_array_equal(other.run()[sid], want[sids[1]])
    wrong = "fp" if kv_codec != "fp" else "int8_per_channel"
    for err in (CheckpointTierMismatchError, KVTierMismatchError, CheckpointError):
        with pytest.raises(err, match="restore_stream"):
            _batcher("port", weights, mode, wrong).restore_stream(path)


@pytest.mark.parametrize("mode", ["local", "split"])
def test_stream_checkpoints_cross_load_and_refuse_another_plan(weights, tmp_path, mode):
    """Each package restores the other's stream checkpoint to the
    reference's uninterrupted greedy tokens; a split checkpoint refuses a
    local batcher (mode) and a plan mismatch."""
    prompts = _prompts()
    ref = _batcher("ref", weights, mode)
    sid = ref.submit(prompts[0], NEW, rng_seed=3)
    want = ref.run()[sid]
    paths = {}
    for pkg in ("ref", "port"):
        b = _batcher(pkg, weights, mode)
        s = b.submit(prompts[0], NEW, rng_seed=3)
        for _ in range(4):
            b.step()
        paths[pkg] = b.checkpoint_stream(s, str(tmp_path / f"{pkg}.ckpt"))
    for pkg, path in (("port", paths["ref"]), ("ref", paths["port"])):
        b = _batcher(pkg, weights, mode, **OTHER)
        s = b.restore_stream(path)
        np.testing.assert_array_equal(np.asarray(b.run()[s]), np.asarray(want))
    if mode == "split":
        with pytest.raises(CheckpointError, match="'paged_split' checkpoint"):
            _batcher("port", weights, "local").restore_stream(paths["port"])


def test_checkpoint_dir_snapshots_every_eviction(weights, tmp_path):
    """A pool too small for three streams evicts; with ``checkpoint_dir``
    each eviction leaves ``stream_<sid>.ckpt``, which restores elsewhere."""
    b = _batcher("port", weights, "split", num_pages=9,
                 checkpoint_dir=str(tmp_path))
    sids = _submit(b)
    res = b.run()
    files = sorted(os.listdir(tmp_path))
    assert b.report()["evicted"] > 0 and files
    assert all(f.startswith("stream_") and f.endswith(".ckpt") for f in files)
    sid = int(files[0][len("stream_"):-len(".ckpt")])
    other = _batcher("port", weights, "split")
    s = other.restore_stream(str(tmp_path / files[0]))
    np.testing.assert_array_equal(other.run()[s], res[sid])
    assert sid in sids


def test_split_batcher_over_a_faulty_link_matches_reference(weights):
    """The split-paged batcher with a faulty link inline: the streams and
    the runtime's counters (prefills and ragged steps) are the reference's."""
    link = (dict(drop_rate=0.3, bitflip_rate=1e-3, seed=4), dict(max_retries=1))
    out = {}
    for pkg in ("port", "ref"):
        b = _batcher(pkg, weights, "split", link=link)
        sids = _submit(b)
        res = b.run()
        out[pkg] = ([np.asarray(res[s]) for s in sids],
                    {k: [int(x) for x in v] for k, v in b.rt.link_counters().items()})
    for g, w in zip(out["port"][0], out["ref"][0]):
        np.testing.assert_array_equal(g, w)
    assert out["port"][1] == out["ref"][1]
    assert sum(out["port"][1]["retried"]) > 0
