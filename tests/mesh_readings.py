"""Readings behind the mesh axes' stated tolerances, on the CPU (not a test:
``python tests/mesh_readings.py [--split4]``).

1. The tensor-parallel reduce: tiny Qwen2 (8 heads over 4) and GPT-NeoX
   configs at 2 and 4 shards, an fp32 hop at cut 1, one batch of ids: the
   largest |logit| difference of the port's split against the reference's
   (the JAX package on the 8-device CPU mesh of ``tests/conftest.py``),
   of the port against its unsplit forward, and of the reference against
   its own.
2. ``--split4``: Qwen2-1.5B at split4's cuts (9, 18), random fp32 weights
   from seed 0, 2 chunks of window 512: the PPL at ``n_model`` 2 against
   the plain split, over fp32 hops and over split4's int8 + int4 hops
   (about 2 minutes and 7 GB).
"""
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import conftest  # noqa: E402,F401  (the CPU mesh, before JAX initializes)
import numpy as np  # noqa: E402
import torch  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from edgellm_tpu.models import forward as j_forward  # noqa: E402
from edgellm_tpu.models import init_params as j_init  # noqa: E402
from edgellm_tpu.models.configs import tiny_config as jtiny  # noqa: E402
from edgellm_tpu.parallel import SplitConfig as JSplitConfig  # noqa: E402
from edgellm_tpu.parallel import SplitRuntime as JSplitRuntime  # noqa: E402
from edgellm_tpu.parallel import make_stage_mesh as j_mesh  # noqa: E402
from edgellm_tpu_torch.models import configs as tcfg, forward  # noqa: E402
from edgellm_tpu_torch.models.convert import params_from_jax_numpy  # noqa: E402
from edgellm_tpu_torch.parallel import SplitConfig, SplitRuntime  # noqa: E402

FAMILIES = {"qwen2": dict(num_layers=4, num_heads=8, num_kv_heads=4),
            "gpt_neox": dict(num_layers=4, num_heads=4)}


def reduce_readings():
    for fam, kw in FAMILIES.items():
        jc, tc = jtiny(fam, **kw), tcfg.tiny_config(fam, **kw)
        jp = j_init(jc, jax.random.key(3))
        tp = params_from_jax_numpy(tc, jax.tree_util.tree_map(np.asarray, jp), device="cpu")
        ids = np.random.default_rng(5).integers(0, tc.vocab_size, (2, 32))
        ref_unsplit = np.asarray(j_forward(jc, jp, jnp.asarray(ids))[0])
        with torch.inference_mode():
            port_unsplit = forward(tc, tp, torch.as_tensor(ids))[0].numpy()
        for m in (2, 4):
            jrt = JSplitRuntime(jc, JSplitConfig((1,), ("fp32",)), j_mesh(2, 1, m))
            ref = np.asarray(jrt.forward(jrt.place_params(jp), jnp.asarray(ids)))
            rt = SplitRuntime(tc, SplitConfig((1,), ("fp32",)), ["cpu"] * 2, n_model=m)
            with torch.inference_mode():
                port = rt.forward(rt.place_params(tp), torch.as_tensor(ids)).numpy()
            print(f"{fam} n_model {m}: port-reference {np.abs(port - ref).max():.3e}, "
                  f"port-unsplit {np.abs(port - port_unsplit).max():.3e}, "
                  f"reference-unsplit {np.abs(ref - ref_unsplit).max():.3e}", flush=True)


def split4_readings():
    from edgellm_tpu_torch.eval import run_split_eval
    from edgellm_tpu_torch.models import PRESETS, init_params
    from edgellm_tpu_torch.parallel import make_stage_mesh

    cfg = PRESETS["qwen2-1.5b"]
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    corpus = np.random.default_rng(0).integers(0, cfg.vocab_size, 4096)
    for codecs in (["fp32", "fp32"], ["int8_per_token", "int4_per_token"]):
        ppl = [run_split_eval(cfg, params, corpus, cuts=[9, 18], hop_codecs=codecs,
                              max_length=512, stride=32, window_batch=8, max_chunks=2,
                              time_hops=False, device="cpu",
                              mesh=make_stage_mesh(3, 1, m, device="cpu"))["ppl"]
               for m in (1, 2)]
        print(f"split4 {codecs}: PPL {ppl[0]} plain, {ppl[1]} at n_model 2, relative "
              f"{abs(ppl[1] - ppl[0]) / ppl[0]:.3e}", flush=True)


if __name__ == "__main__":
    reduce_readings()
    if "--split4" in sys.argv:
        split4_readings()
