"""The "model" mesh axis (tensor parallelism) of the port's split runtime
against the TPU package's, on the CPU.

One set of weights (the JAX package's ``init_params``, carried across with
``params_from_jax_numpy``) and one batch of ids (numpy seed) go through
both packages' ``SplitRuntime.forward``: the reference's on the spoofed
8-device CPU mesh of ``tests/conftest.py`` at ("stage", "data", "model") =
(2, 1, n_model), the port's with its shards run in turn on the CPU.

Tolerances: float32 logits atol 1e-5, the reference's own bound for its
tensor-parallel split against the unsplit forward (``tests/test_split.py``).
The port sums its shards' partial products in shard order; XLA's CPU
all-reduce may add four in another order, and both sit within that bound
of each other and of the unsplit forward. The int8_per_token hop is
bit-exact between the packages (``test_torch_codecs``), so a split over it
keeps the same bound.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from edgellm_tpu.models import forward as j_forward
from edgellm_tpu.models import init_params as j_init
from edgellm_tpu.models.configs import tiny_config as jtiny
from edgellm_tpu.parallel import SplitConfig as JSplitConfig
from edgellm_tpu.parallel import SplitRuntime as JSplitRuntime
from edgellm_tpu.parallel import make_stage_mesh as j_mesh
from edgellm_tpu_torch.models import configs as tcfg
from edgellm_tpu_torch.models import forward
from edgellm_tpu_torch.models.convert import params_from_jax_numpy
from edgellm_tpu_torch.parallel import SplitConfig, SplitRuntime, make_stage_mesh

ATOL = 1e-5

#: the two families, with head counts that four shards divide: Qwen2's GQA
#: (8 query heads over 4 KV heads) and GPT-NeoX's MHA
FAMILIES = {"qwen2": dict(num_layers=4, num_heads=8, num_kv_heads=4),
            "gpt_neox": dict(num_layers=4, num_heads=4)}


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def model(request):
    fam = request.param
    jc, tc = jtiny(fam, **FAMILIES[fam]), tcfg.tiny_config(fam, **FAMILIES[fam])
    jp = j_init(jc, jax.random.key(3))
    tp = params_from_jax_numpy(tc, jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    ids = np.random.default_rng(5).integers(0, tc.vocab_size, (2, 32))
    return fam, jc, tc, jp, tp, ids


def _pair(jc, tc, jp, tp, ids, n_model, codecs=("fp32",), cuts=(1,)):
    jrt = JSplitRuntime(jc, JSplitConfig(cuts, codecs), j_mesh(len(cuts) + 1, 1, n_model))
    want = np.asarray(jrt.forward(jrt.place_params(jp), jnp.asarray(ids)))
    rt = SplitRuntime(tc, SplitConfig(cuts, codecs), ["cpu"] * (len(cuts) + 1),
                      n_model=n_model)
    with torch.inference_mode():
        got = rt.forward(rt.place_params(tp), torch.as_tensor(ids)).numpy()
    return rt, got, want


@pytest.mark.parametrize("n_model", [2, 4])
def test_tp_forward_matches_reference_and_unsplit(model, n_model):
    """Port against the reference's tensor-parallel split, and against the
    unsplit forward of either package, within the reference's TP bound."""
    fam, jc, tc, jp, tp, ids = model
    _, got, want = _pair(jc, tc, jp, tp, ids, n_model)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    with torch.inference_mode():
        unsplit = forward(tc, tp, torch.as_tensor(ids))[0].numpy()
    np.testing.assert_allclose(got, unsplit, atol=ATOL, rtol=0)
    np.testing.assert_allclose(unsplit, np.asarray(j_forward(jc, jp, jnp.asarray(ids))[0]),
                               atol=ATOL, rtol=0)


def test_int8_hop_under_tp(model):
    """An int8_per_token hop under two shards: the reference's logits, the
    one-shard port's payload bytes (the hop crosses once, the full hidden),
    and a three-stage split with two hops."""
    fam, jc, tc, jp, tp, ids = model
    rt, got, want = _pair(jc, tc, jp, tp, ids, 2, codecs=("int8_per_token",))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    plain = SplitRuntime(tc, SplitConfig((1,), ("int8_per_token",)), ["cpu"] * 2)
    assert rt.hop_bytes(2, 32) == plain.hop_bytes(2, 32)
    _, got3, want3 = _pair(jc, tc, jp, tp, ids, 2, codecs=("int8_per_token", "int4_per_token"),
                           cuts=(0, 2))
    np.testing.assert_allclose(got3, want3, atol=ATOL, rtol=0)


def test_shard_shapes(model):
    """Each shard holds its head-contiguous columns of q / k / v (``wq``'s
    last axis halved at two shards), its rows of ``wo`` and its F columns /
    rows of the MLP, each a contiguous tensor of its own; norms and output
    biases are shared."""
    fam, jc, tc, jp, tp, ids = model
    rt = SplitRuntime(tc, SplitConfig((1,), ("fp32",)), ["cpu"] * 2, n_model=2)
    placed = rt.place_params(tp)
    hd, f = tc.head_dim, tc.intermediate_size
    for s, (start, stop) in enumerate(rt.bounds):
        shards = placed["stages"][s]
        assert len(shards) == 2
        for m, shard in enumerate(shards):
            assert shard["wq"].shape == (stop - start, tc.hidden_size, tc.num_heads * hd // 2)
            assert shard["wk"].shape[-1] == tc.num_kv_heads * hd // 2
            assert shard["wo"].shape == (stop - start, tc.num_heads * hd // 2, tc.hidden_size)
            up = "w_up" if fam == "qwen2" else "w_in"
            down = "w_down" if fam == "qwen2" else "w_out"
            assert shard[up].shape[-1] == f // 2 and shard[down].shape[1] == f // 2
            assert all(t.is_contiguous() for t in shard.values())
            width = tc.num_heads * hd // 2
            torch.testing.assert_close(
                shard["wq"], tp["layers"]["wq"][start:stop, :, m * width:(m + 1) * width],
                rtol=0, atol=0)
            assert shard["ln1_scale"] is shards[0]["ln1_scale"]


def test_divisibility_message_matches_reference():
    """Four shards do not divide six heads: both runtimes refuse with the
    reference's message."""
    with pytest.raises(ValueError) as want:
        JSplitRuntime(jtiny("qwen2", hidden_size=96, num_heads=6, num_kv_heads=2),
                      JSplitConfig((1,), ("fp32",)), j_mesh(2, 1, 4))
    with pytest.raises(ValueError) as got:
        SplitRuntime(tcfg.tiny_config("qwen2", hidden_size=96, num_heads=6, num_kv_heads=2),
                     SplitConfig((1,), ("fp32",)), ["cpu"] * 2, n_model=4)
    assert str(got.value) == str(want.value)
    assert "requires head/FFN dims divisible" in str(got.value)
    mesh = make_stage_mesh(2, 1, 2, device="cpu")
    assert mesh.shape == {"stage": 2, "data": 1, "model": 2}
    assert SplitRuntime(tcfg.tiny_config("qwen2"), SplitConfig((1,), ("fp32",)),
                        mesh).n_model == 2
