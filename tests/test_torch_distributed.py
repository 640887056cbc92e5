"""The port's multi-process layer (``parallel/distributed.py``) against the
TPU package's, on the CPU.

``build_stage_grid`` is held to the reference's grid for every case of the
reference's own mocked-device tests (one shuffled fake pod list fed to
both); the mesh builders agree with the plain builder on one process, as
the reference's do; ``initialize_distributed`` degrades to one process
with nothing configured and raises under explicit arguments or a cluster
launch; and two REAL gloo processes (``tests/torch_dist_worker.py``, each
with a timeout of its own) run a tiny split eval at n_data 2, through a
kill and a resume, and ``run.main --distributed`` over two processes: the
ranks' results equal each other and the one-process run (PPL rtol 1e-6:
the same forwards, the NLLs gathered in group order), and only rank 0
writes the checkpoint and the metrics.
"""
import dataclasses
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from edgellm_tpu.parallel import build_stage_grid as j_build_stage_grid
from edgellm_tpu_torch.eval import run_split_eval
from edgellm_tpu_torch.parallel import distributed as dist
from edgellm_tpu_torch.parallel import (SplitConfig, SplitRuntime, build_stage_grid,
                                        make_multihost_sp_stage_mesh,
                                        make_multihost_stage_mesh, make_stage_mesh)

TESTS = os.path.dirname(os.path.abspath(__file__))
#: every subprocess's own limit: a rendezvous that never completes fails
WORKER_TIMEOUT = 300


@dataclasses.dataclass(frozen=True)
class FakeDevice:
    id: int
    process_index: int
    slice_index: int


def pod(n_slices: int, hosts_per_slice: int, chips_per_host: int):
    """A fake multi-slice pod device list, deliberately shuffled (the
    reference test's)."""
    devs, i = [], 0
    for s in range(n_slices):
        for h in range(hosts_per_slice):
            for _ in range(chips_per_host):
                devs.append(FakeDevice(id=i, process_index=s * hosts_per_slice + h,
                                       slice_index=s))
                i += 1
    rng = np.random.default_rng(0)
    return [devs[j] for j in rng.permutation(len(devs))]


#: (pod geometry, build_stage_grid args) of the reference's grid tests
GRID_CASES = {
    "groups_never_span_slices": ((2, 2, 4), (4, None, 1)),
    "data_crosses_slices": ((2, 1, 8), (2, None, 2)),
    "intra_slice_multi_host": ((1, 2, 2), (4, 1, 1)),
    "group_spanning_slice": ((2, 1, 3), (2, None, 1)),
    "wrong_n_data": ((1, 1, 8), (2, 3, 1)),
    "seq_inner": ((2, 1, 4), (2, None, 2, "seq")),
}


@pytest.mark.parametrize("case", sorted(GRID_CASES))
def test_build_stage_grid_equals_reference(case):
    geometry, args = GRID_CASES[case]
    devs = pod(*geometry)
    try:
        want = j_build_stage_grid(devs, *args)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            build_stage_grid(devs, *args)
        assert str(got.value) == str(e)
        return
    got = build_stage_grid(devs, *args)
    assert got.shape == want.shape and (got == want).all()
    for d in range(got.shape[1]):  # a group never spans slices
        assert len({dev.slice_index for dev in got[:, d, :].ravel()}) == 1


def test_grid_ordering_is_deterministic():
    """Every process must build the same grid whatever order its device
    list comes in."""
    devs = pod(2, 2, 2)
    grids = [build_stage_grid(list(perm), 2, None, 1)
             for perm in (devs, devs[::-1], sorted(devs, key=lambda d: -d.id))]
    for g in grids[1:]:
        assert (g == grids[0]).all() and (g == j_build_stage_grid(devs, 2, None, 1)).all()


def test_multihost_meshes_on_one_process_agree_with_plain():
    """On one process the slice-aware mesh has the plain mesh's axes and
    drives the split runtime to the same logits, bit for bit; the stage x
    seq builder takes one group and refuses an ambiguous device list."""
    from edgellm_tpu_torch.models import init_params, tiny_config

    mesh = make_multihost_stage_mesh(2, n_data=2, n_model=2, device="cpu")
    plain = make_stage_mesh(2, n_data=2, n_model=2, device="cpu")
    assert mesh.shape == plain.shape == {"stage": 2, "data": 2, "model": 2}
    assert {d.process_index for d in mesh.devices.ravel()} == {0}
    cfg = tiny_config("qwen2", num_layers=4, hidden_size=32, num_heads=4, vocab_size=128)
    params = init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    ids = torch.as_tensor(np.random.default_rng(2).integers(0, 128, (2, 16)))
    split = SplitConfig((1,), ("int8_per_token",))
    runtimes = [SplitRuntime(cfg, split, m) for m in (mesh, plain)]
    logits = [rt.forward(rt.place_params(params), ids) for rt in runtimes]
    assert torch.equal(logits[0], logits[1])
    assert make_multihost_sp_stage_mesh(2, 4, device="cpu").shape == {"stage": 2, "seq": 4}
    with pytest.raises(ValueError, match="exactly"):
        make_multihost_sp_stage_mesh(2, 2, devices=pod(2, 1, 4))


def _clean_env(monkeypatch):
    monkeypatch.setattr(dist, "_initialized", False)
    for k in ("SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE", "PMI_SIZE", "WORLD_SIZE", "RANK",
              "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)


def test_initialize_distributed_degrades_without_a_coordinator(monkeypatch):
    """Nothing configured: the env:// rendezvous finds no variables, and the
    call warns and carries on as one process; it is idempotent."""
    _clean_env(monkeypatch)
    with pytest.warns(UserWarning, match="no coordinator configured; continuing as a "
                                         "single process"):
        assert dist.initialize_distributed() == 1
    assert dist.initialize_distributed() == 1
    assert not dist.is_initialized() and dist.process_index() == 0


def test_initialize_distributed_explicit_args_and_raises(monkeypatch):
    """Explicit arguments rendezvous at tcp:// over gloo; a failure there
    raises, as does a failed auto-detect under a cluster launch's
    variables (a world size above 1, a rendezvous address)."""
    _clean_env(monkeypatch)
    calls = []
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    dist.initialize_distributed("host:1234", num_processes=4, process_id=1)
    assert calls[0][0] == "gloo"
    assert {k: calls[0][1][k] for k in ("init_method", "world_size", "rank")} == {
        "init_method": "tcp://host:1234", "world_size": 4, "rank": 1}
    dist.initialize_distributed()  # idempotent: no second call
    assert len(calls) == 1

    def refuse(backend, **kw):
        raise RuntimeError("connection refused")

    monkeypatch.setattr(torch.distributed, "init_process_group", refuse)
    monkeypatch.setattr(dist, "_initialized", False)
    with pytest.raises(RuntimeError, match="connection refused"):
        dist.initialize_distributed("host:1", num_processes=2, process_id=0)
    monkeypatch.undo()
    for var, value in (("WORLD_SIZE", "2"), ("SLURM_NTASKS", "4"), ("PMI_SIZE", "2"),
                       ("OMPI_COMM_WORLD_SIZE", "2"), ("MASTER_ADDR", "localhost")):
        _clean_env(monkeypatch)
        monkeypatch.setenv(var, value)
        with pytest.raises(ValueError, match="expected, but not set"):
            dist.initialize_distributed()
    _clean_env(monkeypatch)
    monkeypatch.setenv("WORLD_SIZE", "1")  # a world of one is no cluster
    with pytest.warns(UserWarning, match="single process"):
        assert dist.initialize_distributed() == 1


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(argv_of, out_dir, nprocs=2, port=None):
    """Start one process per rank (``argv_of(rank)``; with ``port`` the
    env:// rendezvous variables of each rank), output to files (a rank that
    fills a pipe while its peer waits in a collective would hang the pair);
    every rank waits at most :data:`WORKER_TIMEOUT` seconds and a rank still
    running is killed. -> [(returncode, output)]."""
    env = {**os.environ, "PYTHONPATH": os.path.dirname(TESTS) + os.pathsep
           + os.environ.get("PYTHONPATH", ""), "OMP_NUM_THREADS": "1"}
    rendezvous = (lambda r: {} if port is None else {  # noqa: E731
        "MASTER_ADDR": "localhost", "MASTER_PORT": str(port), "WORLD_SIZE": str(nprocs),
        "RANK": str(r)})
    logs = [open(os.path.join(out_dir, f"log_{r}.txt"), "a+") for r in range(nprocs)]
    procs = [subprocess.Popen(argv_of(r), env={**env, **rendezvous(r)}, stdout=logs[r],
                              stderr=subprocess.STDOUT, text=True)
             for r in range(nprocs)]
    done = []
    try:
        for p in procs:
            p.wait(timeout=WORKER_TIMEOUT)
    finally:
        for p in procs:  # never orphan a peer
            if p.poll() is None:
                p.kill()
                p.wait()
        for p, log in zip(procs, logs):
            log.seek(0)
            done.append((p.returncode, log.read()))
            log.close()
    for rc, out in done:
        assert rc == 0, f"rank failed (rc={rc}):\n{out[-4000:]}"
    return done


STABLE = ("ppl", "total_nll", "n_tokens", "chunks", "measured_hop_bytes_total",
          "real_fwd_tokens", "mesh", "cuts", "hop_codecs")


def test_two_process_split_eval_matches_one_process(tmp_path):
    """Two gloo processes at n_data 2, killed after two chunks and resumed
    through the shared checkpoint: the ranks agree, and equal the one-process
    run on the same mesh sizes; only rank 0 wrote the checkpoint and the
    metrics."""
    sys.path.insert(0, TESTS)
    import torch_dist_worker as worker

    worker_py = os.path.join(TESTS, "torch_dist_worker.py")
    for max_chunks in (["2"], []):
        port = str(_free_port())
        _spawn(lambda r: [sys.executable, worker_py, str(r), "2", port, str(tmp_path)]
               + max_chunks, str(tmp_path))
        if max_chunks:
            assert json.loads((tmp_path / "ckpt.json").read_text())["chunks"] == 2
    results = [json.loads((tmp_path / f"result_{r}.json").read_text()) for r in (0, 1)]
    assert {k: results[0][k] for k in STABLE} == {k: results[1][k] for k in STABLE}
    assert results[0]["mesh"] == {"stage": 2, "data": 2, "model": 1}
    assert not (tmp_path / "metrics_1.jsonl").exists()
    finals = [json.loads(line) for line in (tmp_path / "metrics_0.jsonl").read_text().split("\n")
              if line and json.loads(line).get("final")]
    cfg, params, corpus, kw = worker.model()
    single = run_split_eval(cfg, params, corpus, device="cpu",
                            mesh=make_stage_mesh(2, 2, 1, device="cpu"), **kw)
    assert results[0]["chunks"] == single["chunks"]
    assert results[0]["n_tokens"] == single["n_tokens"]
    np.testing.assert_allclose(results[0]["ppl"], single["ppl"], rtol=1e-6)
    np.testing.assert_allclose(finals[-1]["ppl"], single["ppl"], rtol=1e-6)


def test_two_process_cli_distributed(tmp_path):
    """``run.main --distributed`` in two processes (env:// rendezvous over
    gloo), a split at n_data 2, each rank its own output directory: both
    print ``distributed: process R of 2`` and the same result line, and
    only rank 0's directory holds the checkpoint and the metrics."""
    params = json.dumps({"experiment": "split", "cuts": [2], "hop_codecs": ["int8_per_token"],
                         "max_length": 32, "stride": 16, "n_data": 2})
    argv = lambda r: [sys.executable, "-m", "edgellm_tpu_torch.run", "--distributed",  # noqa
                      "--device", "cpu", "--model", "tiny-qwen2", "--params", params,
                      "--max-chunks", "4", "--window-batch", "2",
                      "--output-dir", str(tmp_path / f"r{r}")]
    done = _spawn(argv, str(tmp_path), port=_free_port())
    lines = []
    for r, (_, out) in enumerate(done):
        assert f"distributed: process {r} of 2" in out
        lines.append(json.loads([ln for ln in out.splitlines() if ln.startswith("{")][-1]))
    assert {k: lines[0][k] for k in STABLE} == {k: lines[1][k] for k in STABLE}
    assert lines[0]["mesh"] == {"stage": 2, "data": 2, "model": 1}
    assert (tmp_path / "r0" / "split_checkpoint.json").exists()
    assert (tmp_path / "r0" / "split_metrics.jsonl").exists()
    assert not (tmp_path / "r1" / "split_checkpoint.json").exists()
    assert not (tmp_path / "r1" / "split_metrics.jsonl").exists()
