"""The port's transformer against the TPU package's, on the same weights.

Weights come from the JAX package's ``init_params`` and cross over with
``params_from_jax_numpy``; token ids come from a numpy seed. Both run fp32 on
the CPU. Tolerances: logits atol 2e-5 / rtol 1e-4 (fp32 matmuls in another
summation order through a few layers); attention stats atol 1e-6
(probabilities); NLL rtol 1e-5. The HF loader is held against the JAX loader
array for array (both convert the same fp32 state_dict: exact).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from edgellm_tpu.models import hf_loader as jhf
from edgellm_tpu.models import transformer as jtr
from edgellm_tpu.models.configs import tiny_config as jtiny
from edgellm_tpu_torch.models import configs as tcfg
from edgellm_tpu_torch.models import hf_loader as thf
from edgellm_tpu_torch.models import transformer as ttr
from edgellm_tpu_torch.models.convert import params_from_jax_numpy

LOGIT_TOL = dict(atol=2e-5, rtol=1e-4)

#: (family, tiny_config kwargs): hd 16 takes the plain path in both packages;
#: hd 64 is inside the kernels' envelope (the port's wrapper path)
FAMILIES = [
    ("gpt_neox", dict(num_layers=3)),
    ("qwen2", dict(num_layers=3)),
    ("llama", dict(num_layers=3)),
    ("qwen2", dict(num_layers=2, hidden_size=256, num_heads=4)),
    ("gpt_neox", dict(num_layers=2, hidden_size=256, num_heads=4)),
]


def _setup(family, kw, seed=0, s=32, b=2):
    jcfg = jtiny(family, **kw)
    tc = tcfg.tiny_config(family, **kw)
    assert tc == tcfg.ModelConfig(**{f: getattr(jcfg, f) for f in
                                     jcfg.__dataclass_fields__})
    jparams = jtr.init_params(jcfg, jax.random.key(seed))
    tparams = params_from_jax_numpy(tc, jax.tree_util.tree_map(np.asarray, jparams),
                                    device="cpu")
    ids = np.random.default_rng(seed + 1).integers(0, jcfg.vocab_size, size=(b, s))
    return jcfg, tc, jparams, tparams, ids


@pytest.mark.parametrize("family,kw", FAMILIES)
def test_forward_logits_match(family, kw):
    jcfg, tc, jp, tp, ids = _setup(family, kw)
    want, _ = jtr.forward(jcfg, jp, jnp.asarray(ids))
    got, _ = ttr.forward(tc, tp, torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)


@pytest.mark.parametrize("family,kw", FAMILIES)
def test_stats_and_hiddens_match(family, kw):
    jcfg, tc, jp, tp, ids = _setup(family, kw, seed=3)
    _, jaux = jtr.run_layers_from_ids(jcfg, jp, jnp.asarray(ids), capture_stats=True)
    _, taux = ttr.run_layers_from_ids(tc, tp, torch.from_numpy(ids), capture_stats=True)
    np.testing.assert_allclose(taux["stats"].col_mean.numpy(),
                               np.asarray(jaux["stats"].col_mean), atol=1e-6, rtol=0)
    np.testing.assert_allclose(taux["stats"].last_row.numpy(),
                               np.asarray(jaux["stats"].last_row), atol=1e-6, rtol=0)
    np.testing.assert_allclose(taux["hiddens"].numpy(), np.asarray(jaux["hiddens"]),
                               atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("stats_block", [0, 8])
def test_eager_stats_path_matches(stats_block):
    """An explicit ``stats_block`` takes the eager formulation in both packages."""
    jcfg, tc, jp, tp, ids = _setup("qwen2", dict(num_layers=2), seed=5)
    _, jaux = jtr.run_layers_from_ids(jcfg, jp, jnp.asarray(ids), capture_stats=True,
                                      stats_block=stats_block)
    _, taux = ttr.run_layers_from_ids(tc, tp, torch.from_numpy(ids), capture_stats=True,
                                      stats_block=stats_block)
    np.testing.assert_allclose(taux["stats"].col_mean.numpy(),
                               np.asarray(jaux["stats"].col_mean), atol=1e-6, rtol=0)
    np.testing.assert_allclose(taux["stats"].last_row.numpy(),
                               np.asarray(jaux["stats"].last_row), atol=1e-6, rtol=0)


@pytest.mark.parametrize("family,vocab_block", [
    ("qwen2", None), ("qwen2", 0), ("qwen2", 64), ("gpt_neox", 32), ("llama", 128),
])
def test_nll_tail_matches(family, vocab_block):
    """Single-block and vocab-streamed NLL, tied (qwen2/llama) and untied
    (gpt_neox) heads, per example, with -100 masking."""
    jcfg, tc, jp, tp, ids = _setup(family, dict(num_layers=2), seed=7)
    targets = ids.copy()
    targets[:, :20] = -100
    hid, _ = jtr.run_layers(jcfg, jp, jtr.embed(jp, jnp.asarray(ids)))
    want = jtr.nll_tail(jcfg, jp, hid, jnp.asarray(targets), 13, per_example=True,
                        vocab_block=vocab_block)
    got = ttr.nll_tail(tc, tp, torch.from_numpy(np.array(hid)), torch.from_numpy(targets),
                       13, per_example=True, vocab_block=vocab_block)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    full = ttr.nll_from_logits(ttr.unembed(tc, tp, torch.from_numpy(np.array(hid))),
                               torch.from_numpy(targets), per_example=True)
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=1e-5)


def test_rope_tables_match_including_llama3_scaling():
    for cfg_name in ("llama-3.2-1b", "pythia-70m", "qwen2-0.5b"):
        jc = jtr.precompute_rope(__import__("edgellm_tpu.models.configs",
                                            fromlist=["PRESETS"]).PRESETS[cfg_name], 64)
        tc = ttr.precompute_rope(tcfg.PRESETS[cfg_name], 64, device="cpu")
        for a, b in zip(tc, jc):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=1e-6)


def test_presets_match_reference():
    from edgellm_tpu.models.configs import PRESETS as JP

    assert sorted(JP) == sorted(tcfg.PRESETS)
    for name, jc in JP.items():
        tc = tcfg.PRESETS[name]
        assert {f: getattr(tc, f) for f in jc.__dataclass_fields__} == \
            {f: getattr(jc, f) for f in jc.__dataclass_fields__}, name
        assert (tc.head_dim, tc.rotary_dim, tc.qkv_bias) == \
            (jc.head_dim, jc.rotary_dim, jc.qkv_bias)


def test_init_params_shapes_match_reference():
    for name in ("tiny-neox", "tiny-qwen2", "tiny-llama"):
        tc = tcfg.PRESETS[name]
        from edgellm_tpu.models.configs import PRESETS as JP

        jp = jtr.init_params(JP[name], jax.random.key(0))
        tp = ttr.init_params(tc, torch.Generator().manual_seed(0), device="cpu")
        jshapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jp)
        tshapes = {k: ({n: tuple(t.shape) for n, t in v.items()} if isinstance(v, dict)
                       else tuple(v.shape)) for k, v in tp.items()}
        assert tshapes == jshapes
        bf = ttr.init_params(tc, torch.Generator().manual_seed(0), dtype=torch.bfloat16,
                             device="cpu")
        assert bf["embed"].dtype == torch.bfloat16
        torch.testing.assert_close(bf["embed"].float(),
                                   tp["embed"].to(torch.bfloat16).float())


def _hf_models():
    from transformers import (GPTNeoXConfig, GPTNeoXForCausalLM, Qwen2Config,
                              Qwen2ForCausalLM)

    torch.manual_seed(0)
    neox = GPTNeoXForCausalLM(GPTNeoXConfig(
        vocab_size=256, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=256, rotary_pct=0.25, max_position_embeddings=128,
        hidden_act="gelu", layer_norm_eps=1e-5, use_parallel_residual=True,
        attn_implementation="eager")).eval()
    qwen = Qwen2ForCausalLM(Qwen2Config(
        vocab_size=256, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, intermediate_size=128, max_position_embeddings=128,
        rms_norm_eps=1e-6, rope_theta=10000.0, tie_word_embeddings=True,
        attn_implementation="eager")).eval()
    return {"gpt_neox": neox, "qwen2": qwen}


@pytest.mark.parametrize("family", ["gpt_neox", "qwen2"])
def test_params_from_state_dict_matches_reference_loader(family):
    """Same HF state_dict -> identical arrays (incl. the fused-QKV split of
    GPT-NeoX), and the port's logits match HF's own forward."""
    model = _hf_models()[family]
    cfg = thf.config_from_hf(model.config)
    assert cfg == tcfg.ModelConfig(**{f: getattr(jhf.config_from_hf(model.config), f)
                                      for f in cfg.__dataclass_fields__})
    sd = model.state_dict()
    jp = jhf.params_from_state_dict(jhf.config_from_hf(model.config), sd)
    tp = thf.params_from_state_dict(cfg, sd, device="cpu")
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    assert len(flat_j) == sum(len(v) if isinstance(v, dict) else 1 for v in tp.values())
    for path, leaf in flat_j:
        keys = [p.key for p in path]
        t = tp[keys[0]] if len(keys) == 1 else tp[keys[0]][keys[1]]
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf), err_msg=str(keys))
    ids = np.random.default_rng(1).integers(0, 256, size=(1, 40))
    with torch.no_grad():
        want = model(torch.from_numpy(ids)).logits.numpy()
    got, _ = ttr.forward(cfg, tp, torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def test_safetensors_checkpoint_roundtrip(tmp_path):
    """load_checkpoint reads a directory of safetensors + config.json into the
    same parameters as the state_dict route, and verifies integrity first."""
    from safetensors.torch import save_file

    from edgellm_tpu_torch.models.safetensors_io import (load_checkpoint,
                                                         verify_safetensors_integrity)

    model = _hf_models()["qwen2"]
    model.config.to_json_file(str(tmp_path / "config.json"))
    sd = {k: v.contiguous() for k, v in model.state_dict().items()
          if k != "lm_head.weight"}
    save_file(sd, str(tmp_path / "model.safetensors"))
    assert verify_safetensors_integrity(str(tmp_path / "model.safetensors"))["tensors"] == len(sd)
    cfg, params = load_checkpoint(str(tmp_path), device="cpu")
    want = thf.params_from_state_dict(cfg, model.state_dict(), device="cpu")
    torch.testing.assert_close(params["layers"]["wq"], want["layers"]["wq"], atol=0, rtol=0)
    torch.testing.assert_close(params["embed"], want["embed"], atol=0, rtol=0)
    blob = (tmp_path / "model.safetensors").read_bytes()
    (tmp_path / "bad.safetensors").write_bytes(blob[: len(blob) // 2])
    with pytest.raises(ValueError, match="truncated|outside"):
        verify_safetensors_integrity(str(tmp_path / "bad.safetensors"))
