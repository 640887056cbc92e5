"""One rank of the port's two-process split eval (``test_torch_distributed``).

    python tests/torch_dist_worker.py <rank> <nprocs> <port> <out_dir> [max_chunks]

Joins a gloo process group on localhost through the port's own
``initialize_distributed`` (the ``env://`` rendezvous ``--distributed``
uses), lays the split's data axis over the processes
(``make_multihost_stage_mesh``) and runs a tiny split eval: each rank runs
its own data group, the per-example NLLs are all-gathered, and only rank 0
writes the checkpoint and the metrics stream (``metrics_<rank>.jsonl``).
Every rank writes its result to ``out_dir/result_<rank>.json``. Imports no
JAX: the parent test holds the ranks to each other and to one process.
"""
import json
import os
import sys

import numpy as np
import torch


def workload():
    """The shared tiny workload: (preset, corpus seed and length, split
    eval keywords), one definition for the ranks and the parent's oracle."""
    return "tiny-qwen2", (7, 32 + 8 * 12), dict(
        cuts=[2], hop_codecs=["int8_per_token"], max_length=32, stride=8,
        window_batch=2, time_hops=False)


def model():
    from edgellm_tpu_torch.models import PRESETS, init_params

    preset, (seed, length), kw = workload()
    cfg = PRESETS[preset]
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    corpus = np.random.default_rng(seed).integers(0, cfg.vocab_size, length)
    return cfg, params, corpus, kw


def main():
    rank, nprocs, port, out_dir = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                   sys.argv[4])
    max_chunks = int(sys.argv[5]) if len(sys.argv) > 5 else None
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=port, WORLD_SIZE=str(nprocs),
                      RANK=str(rank))
    from edgellm_tpu_torch.eval import run_split_eval
    from edgellm_tpu_torch.parallel import initialize_distributed, make_multihost_stage_mesh
    from edgellm_tpu_torch.parallel.distributed import process_index, shutdown

    assert initialize_distributed() == nprocs and process_index() == rank
    mesh = make_multihost_stage_mesh(2, n_data=nprocs, device="cpu")
    assert {slot.process_index for slot in mesh.devices[:, rank].ravel()} == {rank}
    cfg, params, corpus, kw = model()
    result = run_split_eval(cfg, params, corpus, device="cpu", mesh=mesh, max_chunks=max_chunks,
                            checkpoint_path=os.path.join(out_dir, "ckpt.json"),
                            checkpoint_every=1,
                            metrics_path=os.path.join(out_dir, f"metrics_{rank}.jsonl"), **kw)
    with open(os.path.join(out_dir, f"result_{rank}.json"), "w") as f:
        json.dump({k: v for k, v in result.items() if k != "wall_s"
                   and isinstance(v, (int, float, str, list, dict))}, f)
    shutdown()


if __name__ == "__main__":
    main()
