"""Several processes over one split mesh (PyTorch counterpart of
``edgellm_tpu/parallel/distributed.py``).

The reference joins hosts with ``jax.distributed.initialize()``, after which
``jax.devices()`` spans every host's chips and one SPMD program runs over a
global mesh. Here :func:`initialize_distributed` joins a
``torch.distributed`` process group over gloo, and each process runs the
slots of the global mesh that are its own: a split eval's data groups are
spread over the processes, each runs its groups on its own card, and the
per-example NLLs are all-gathered on the host (:func:`all_gather_rows`, the
reference's ``fetch_global``); only process 0 writes the checkpoint and the
metrics stream. NCCL refuses two ranks on one card, and what crosses the
processes is host numbers, so the group is gloo's on the card too.

The axis layout is the reference's: ``build_stage_grid`` (pure device-list
bookkeeping) keeps every stage x model group within one slice and lets only
the "data" axis cross slices. :class:`DeviceSlot` carries a slot's process
and slice, and the torch device that process runs it on.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import warnings
from typing import Optional, Sequence

import numpy as np
import torch

_initialized = False

#: how long a rendezvous or a collective waits before it fails
TIMEOUT = datetime.timedelta(seconds=300)


@dataclasses.dataclass(frozen=True)
class DeviceSlot:
    """One slot of a global mesh: its global ``id``, the process that runs
    it, its slice (one host of cards here: slice 0), and the torch device
    the owning process runs it on."""

    id: int
    process_index: int
    slice_index: int = 0
    device: str = "cuda"


def is_initialized() -> bool:
    return torch.distributed.is_available() and torch.distributed.is_initialized()


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return torch.distributed.get_rank() if is_initialized() else 0


def process_count() -> int:
    """The number of processes (1 without a process group)."""
    return torch.distributed.get_world_size() if is_initialized() else 1


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> int:
    """Join this process to the process group -> number of processes.

    Explicit arguments rendezvous at ``tcp://coordinator_address``; without
    them the ``env://`` rendezvous reads ``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE`` and ``RANK``. Idempotent: repeated calls are no-ops.
    With nothing configured (no arguments, no rendezvous variables, no
    cluster launch in the environment) it warns and carries on as one
    process, as the reference does; explicit arguments, or the signs of a
    cluster launch (:func:`_in_cluster_env`), make a failed rendezvous
    raise, so N workers never run as N independent process-0 runs. The
    group is gloo's (host collectives), with :data:`TIMEOUT`."""
    global _initialized
    if _initialized or is_initialized():
        _initialized = True
        return process_count()
    explicit = any(a is not None for a in (coordinator_address, num_processes, process_id))
    try:
        if explicit:
            torch.distributed.init_process_group(
                "gloo", init_method=f"tcp://{coordinator_address}",
                world_size=num_processes, rank=process_id, timeout=TIMEOUT)
        else:
            torch.distributed.init_process_group("gloo", init_method="env://",
                                                 timeout=TIMEOUT)
    except (ValueError, RuntimeError) as e:
        if explicit or not _is_missing_coordinator(e) or _in_cluster_env():
            raise
        warnings.warn("initialize_distributed: no coordinator configured; "
                      "continuing as a single process")
        _initialized = True
        return 1
    _initialized = True
    return process_count()


def _is_missing_coordinator(e: BaseException) -> bool:
    """True when the ``env://`` rendezvous failed because a variable it
    needs is not set (the benign one-host case), as opposed to a
    configured coordinator that could not be reached."""
    msg = str(e).lower()
    return "environment variable" in msg and "not set" in msg


def _in_cluster_env() -> bool:
    """Signs this process is one of a multi-process launch although the
    rendezvous found no coordinator: a world-size variable above 1 of
    slurm, mpirun / OpenMPI, PMI or torchrun, or a rendezvous address."""
    for var in ("SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE", "PMI_SIZE", "WORLD_SIZE"):
        try:
            if int(os.environ.get(var, "1") or 1) > 1:
                return True
        except ValueError:
            pass
    return any(os.environ.get(k) for k in ("MASTER_ADDR", "MASTER_PORT"))


def shutdown() -> None:
    """Leave the process group (a no-op without one)."""
    global _initialized
    if is_initialized():
        torch.distributed.destroy_process_group()
    _initialized = False


def all_gather_rows(x) -> np.ndarray:
    """The reference's ``fetch_global``: a per-row host array whose rows are
    spread over the processes in rank order -> every process's rows joined
    (each process gives the same number of rows). One process: the array
    as it is."""
    x = np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)
    if process_count() == 1:
        return x
    local = torch.from_numpy(np.ascontiguousarray(x))
    parts = [torch.empty_like(local) for _ in range(process_count())]
    torch.distributed.all_gather(parts, local)
    return torch.cat(parts).numpy()


def _slice_of(d) -> int:
    """A slot's slice: ``slice_index`` where the device has one, else 0."""
    return getattr(d, "slice_index", 0) or 0


def build_stage_grid(devices: Sequence, n_stages: int, n_data: Optional[int],
                     n_model: int = 1, inner: str = "stage") -> np.ndarray:
    """Arrange ``devices`` into an (n_stages, n_data, n_model) object grid such
    that every (stage x model) group lives within ONE slice and the data axis
    enumerates groups across slices.

    ``n_data=None`` infers the data extent from the device count (every slice
    must hold a whole number of groups). ``inner`` names the second axis only
    for error messages ("stage" or "seq": the ring layout is the same math).
    """
    group = n_stages * n_model
    by_slice: dict = {}
    for d in devices:
        by_slice.setdefault(_slice_of(d), []).append(d)
    for s in by_slice:
        by_slice[s].sort(key=lambda d: (d.process_index, d.id))
        if len(by_slice[s]) % group:
            raise ValueError(
                f"slice {s} holds {len(by_slice[s])} devices, not a multiple "
                f"of the {inner} x model group size {group} — a group may not "
                f"span slices (its hops must stay on ICI)")
    total_groups = sum(len(v) // group for v in by_slice.values())
    if n_data is None:
        n_data = total_groups
    if total_groups != n_data:
        raise ValueError(f"device list yields {total_groups} ({inner} x model) "
                         f"groups, but n_data={n_data} requested")
    groups = []
    for s in sorted(by_slice):
        devs = by_slice[s]
        for i in range(len(devs) // group):
            flat = devs[i * group:(i + 1) * group]
            groups.append(np.asarray(flat, object).reshape(n_stages, n_model))
    # (n_data, n_stages, n_model) -> (n_stages, n_data, n_model)
    return np.stack(groups, axis=0).transpose(1, 0, 2)


def global_slots(per_process: int, device="cuda") -> list:
    """Every process's ``per_process`` slots, each process's on its own
    ``device``: the device list a multi-process mesh is laid over."""
    return [DeviceSlot(id=p * per_process + i, process_index=p, device=str(device))
            for p in range(process_count()) for i in range(per_process)]


def make_multihost_stage_mesh(n_stages: int, n_data: Optional[int] = None,
                              n_model: int = 1, devices=None, device="cuda"):
    """Slice-aware ("stage", "data", "model") mesh over every process's
    slots. Without ``devices`` each process offers n_stages x n_model x
    (n_data / processes) slots of its own card (``n_data`` None: one data
    group a process). On one process it agrees with
    :func:`~.split.make_stage_mesh`."""
    from .split import Mesh

    if devices is None:
        n_proc = process_count()
        groups = n_proc if n_data is None else n_data
        if groups % n_proc:
            raise ValueError(f"n_data={groups} does not spread over {n_proc} processes")
        devices = global_slots(n_stages * n_model * (groups // n_proc), device)
    grid = build_stage_grid(list(devices), n_stages, n_data, n_model)
    return Mesh(grid, ("stage", "data", "model"))


def make_multihost_sp_stage_mesh(n_stages: int, n_seq: int, devices=None, device="cuda"):
    """Slice-aware ("stage", "seq") mesh for the stage x seq ring runtime:
    each stage x seq group is pinned within a slice. Without ``devices``
    each process offers n_stages x n_seq slots of its own card."""
    from .split import Mesh

    if devices is None:
        devices = global_slots(n_stages * n_seq, device)
    grid = build_stage_grid(list(devices), n_stages, None, n_seq, inner="seq")
    if grid.shape[1] != 1:
        raise ValueError(
            f"stage x seq mesh needs exactly n_stages*n_seq={n_stages * n_seq} "
            f"devices, got {grid.shape[1]} groups; shrink the device list or "
            f"run data-parallel ring groups as separate processes")
    return Mesh(grid[:, 0, :], ("stage", "seq"))
