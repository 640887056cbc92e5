"""Survivable decode: checkpointed generation state, failover, watchdogs
(PyTorch counterpart of ``edgellm_tpu/serve/recovery.py``).

- :class:`DecodeCheckpoint`: a versioned, atomic on-disk snapshot of
  everything an in-flight decode needs to resume token for token (the KV
  caches with their fill level in ``cache/length``, the caller's key as
  JAX's ``key_data`` words, the sampled prefix, the link counters). The
  file is the reference's byte for byte: the EDGERECV frame ``<8sIQI``
  (magic, version, payload length, CRC32 of the payload), a u32 header
  length, the JSON header (``sort_keys=True``) and the raw leaves in sorted
  name order. A damaged file raises a typed :class:`CheckpointError`.
  bfloat16 leaves are written and read as raw 16-bit words under the dtype
  name ``"bfloat16"`` (no ``ml_dtypes``): a loaded bf16 leaf is a CPU
  ``torch.bfloat16`` tensor, every other leaf a numpy array.
- :class:`StageFailure` / :class:`StageLostError`: whole-stage loss at a
  decode step (the chunk index in the eval); every call into the runtime
  raises until the caller fails over.
- :class:`Watchdog`: a host-side monotonic deadline for decode and eval
  loops. Its :class:`DecodeTimeout`, and a checkpoint load refused with a
  :class:`CheckpointError`, are dumped by the armed flight recorder at the
  raise site (``obs/flight.py``, once an exception instance).
- :class:`LocalRuntime`: a single-device runtime with ``SplitRuntime``'s
  decode surface on the port's ``prefill`` / ``decode_step``, the failover
  target when one stage survives and the recovery path of ``generate``.

Nothing here imports ``..parallel``: the split runtime imports
:class:`StageLostError` from here.
"""
from __future__ import annotations

import dataclasses
import json
import os
import struct
import zlib
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..obs.flight import flight_dump_for
from ..obs.tracing import span as obs_span
from ..models.paged_kv import KVTierMismatchError
from ..models.transformer import KVCache, decode_step, prefill
from ..utils.clock import MONOTONIC, Clock

__all__ = ["CheckpointError", "CheckpointTierMismatchError", "DecodeCheckpoint",
           "DecodeTimeout", "LocalRuntime", "RecoveryConfig", "RecoveryCounters",
           "StageFailure", "StageLostError", "Watchdog", "runtime_plan_meta"]


class CheckpointError(RuntimeError):
    """A decode checkpoint could not be written or restored (missing file,
    bad magic, truncation, checksum mismatch, or a plan / model signature
    that does not match the resuming runtime)."""


class CheckpointTierMismatchError(KVTierMismatchError, CheckpointError):
    """A checkpoint's KV pages are at another ``kv_codec`` tier than the
    restoring pool (both audiences catch it; restore never transcodes)."""


class DecodeTimeout(TimeoutError):
    """The host-side watchdog deadline expired mid-loop."""


class StageLostError(RuntimeError):
    """A pipeline stage is dark: every call into the runtime fails until the
    caller fails over."""

    def __init__(self, stage: int):
        super().__init__(
            f"pipeline stage {stage} is dark (marked lost); fail over to a "
            f"re-planned runtime or restore from a checkpoint")
        self.stage = int(stage)


@dataclasses.dataclass(frozen=True)
class StageFailure:
    """Whole-stage loss injection: ``stage`` goes dark at decode step
    ``at_step`` (step 0 = the prefill; in the eval harness the chunk
    index). No retry recovers a dead device; only failover does."""

    stage: int
    at_step: int

    def __post_init__(self):
        if self.stage < 0:
            raise ValueError(f"stage must be >= 0, got {self.stage}")
        if self.at_step < 0:
            raise ValueError(f"at_step must be >= 0, got {self.at_step}")


@dataclasses.dataclass(frozen=True)
class RecoveryConfig:
    """The survivable loop's knobs (the reference's fields): checkpoints to
    ``checkpoint_path`` every ``checkpoint_every`` steps (atomic ``.part`` +
    rename), a per-step ``deadline_s`` watchdog on ``clock``, an injected
    ``stage_failure``, ``replan`` onto the survivors (else a lost stage is
    fatal) at most ``max_failovers`` times, and ``halt_at_step``: write a
    checkpoint after that step and return the partial generation."""

    checkpoint_path: Optional[str] = None
    checkpoint_every: int = 0
    deadline_s: Optional[float] = None
    stage_failure: Optional[StageFailure] = None
    replan: bool = True
    max_failovers: int = 1
    halt_at_step: Optional[int] = None
    clock: Clock = MONOTONIC

    def __post_init__(self):
        if self.checkpoint_every < 0:
            raise ValueError("checkpoint_every must be >= 0")
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {self.deadline_s}")
        if self.max_failovers < 1:
            raise ValueError("max_failovers must be >= 1")
        if ((self.checkpoint_every or self.halt_at_step is not None)
                and not self.checkpoint_path):
            raise ValueError("checkpoint_every/halt_at_step require checkpoint_path")


@dataclasses.dataclass
class RecoveryCounters:
    """Recovery bookkeeping, reported beside the link counters."""

    failovers: int = 0
    replans: int = 0
    recompute_tokens: int = 0
    resume_ok: int = 0
    checkpoints_written: int = 0
    watchdog_fires: int = 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class Watchdog:
    """Per-step deadline on a monotonic clock. ``check`` at loop boundaries
    re-arms within the deadline; past it, it runs ``checkpoint_fn`` (errors
    swallowed) and raises :class:`DecodeTimeout`."""

    def __init__(self, deadline_s: float, clock: Clock = MONOTONIC):
        if deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        self.deadline_s = float(deadline_s)
        self._clock = clock
        self._armed_at: Optional[float] = None

    def arm(self) -> None:
        self._armed_at = self._clock()

    def expired(self) -> bool:
        return (self._armed_at is not None
                and self._clock() - self._armed_at > self.deadline_s)

    def check(self, checkpoint_fn: Optional[Callable[[], None]] = None,
              what: str = "decode step") -> None:
        if self._armed_at is None:
            self.arm()
            return
        elapsed = self._clock() - self._armed_at
        if elapsed <= self.deadline_s:
            self.arm()
            return
        if checkpoint_fn is not None:
            try:
                checkpoint_fn()
            except Exception:  # noqa: BLE001 — best-effort by contract
                pass
        exc = DecodeTimeout(
            f"{what} exceeded the {self.deadline_s:g}s deadline "
            f"(elapsed {elapsed:.3f}s); a best-effort checkpoint was "
            f"attempted — resume from it instead of re-running")
        # the post-mortem at the raise site, once per exception instance
        # however many catch sites also dump
        flight_dump_for(exc, what=what, deadline_s=self.deadline_s,
                        elapsed_s=round(elapsed, 3))
        raise exc


# ---------------------------------------------------------------------------
# the checkpoint container and its binary format
# ---------------------------------------------------------------------------

_MAGIC = b"EDGERECV"
_VERSION = 1
# magic(8) | u32 version | u64 payload_len | u32 crc32(payload)
_HEADER = struct.Struct("<8sIQI")
_BF16 = "bfloat16"


def _leaf(v: Any):
    """A leaf as stored: a bf16 tensor stays a CPU bf16 tensor (its raw
    words are written), anything else becomes a numpy array."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        return v.contiguous() if v.dtype == torch.bfloat16 else v.numpy()
    return np.asarray(v)


def _dtype_name(v) -> str:
    return _BF16 if isinstance(v, torch.Tensor) else str(v.dtype)


def _raw_bytes(v) -> bytes:
    if isinstance(v, torch.Tensor):  # bf16: its 16-bit words, little-endian
        return v.view(torch.int16).numpy().tobytes()
    return np.ascontiguousarray(v).tobytes()


def _from_raw(raw: bytes, name: str, shape: tuple, path: str):
    if name == _BF16:
        words = np.frombuffer(raw, np.int16).reshape(shape).copy()
        return torch.from_numpy(words).view(torch.bfloat16)
    try:
        dt = np.dtype(name)
    except TypeError as e:
        raise CheckpointError(f"checkpoint {path} leaf has unknown dtype {name!r}") from e
    return np.frombuffer(raw, dt).reshape(shape).copy()


def _itemsize(name: str, path: str) -> int:
    if name == _BF16:
        return 2
    try:
        return np.dtype(name).itemsize
    except TypeError as e:
        raise CheckpointError(f"checkpoint {path} leaf has unknown dtype {name!r}") from e


class DecodeCheckpoint:
    """A flat ``{name: array}`` dict plus a JSON-able ``meta`` dict, with the
    reference's self-verifying binary serialization: leaves as raw bytes
    with their dtype name and shape, framed by magic, version, length and
    CRC32, so a restore never reads a damaged file. Stream snapshots
    (``ContinuousBatcher.checkpoint_stream``) store the contiguous KV
    prefix, never pages."""

    def __init__(self, arrays: dict, meta: dict):
        self.arrays = {k: _leaf(v) for k, v in arrays.items()}
        self.meta = dict(meta)

    def to_bytes(self) -> bytes:
        """The file's bytes."""
        names = sorted(self.arrays)
        leaves = [{"name": n, "dtype": _dtype_name(self.arrays[n]),
                   "shape": list(self.arrays[n].shape)} for n in names]
        header = json.dumps({"meta": self.meta, "leaves": leaves}, sort_keys=True).encode()
        body = b"".join(_raw_bytes(self.arrays[n]) for n in names)
        payload = struct.pack("<I", len(header)) + header + body
        return _HEADER.pack(_MAGIC, _VERSION, len(payload), zlib.crc32(payload)) + payload

    def save(self, path: str) -> str:
        """Atomic write: ``path + ".part"``, fsync, rename (in a
        ``recovery.checkpoint_save`` span carrying the byte count)."""
        with obs_span("recovery.checkpoint_save", path=path) as sp:
            blob = self.to_bytes()
            if sp is not None:
                sp.args["bytes"] = len(blob)
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            tmp = path + ".part"
            with open(tmp, "wb") as f:
                f.write(blob)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        return path

    @classmethod
    def load(cls, path: str) -> "DecodeCheckpoint":
        with obs_span("recovery.checkpoint_load", path=path):
            try:
                return cls._load_impl(path)
            except CheckpointError as e:
                # a refused restore is a post-mortem moment (once an instance)
                flight_dump_for(e, path=path)
                raise

    @classmethod
    def _load_impl(cls, path: str) -> "DecodeCheckpoint":
        try:
            with open(path, "rb") as f:
                blob = f.read()
        except OSError as e:
            raise CheckpointError(f"cannot read checkpoint {path}: {e}") from e
        if len(blob) < _HEADER.size:
            raise CheckpointError(f"checkpoint {path} is truncated ({len(blob)} bytes < "
                                  f"{_HEADER.size}-byte header)")
        magic, version, length, crc = _HEADER.unpack_from(blob)
        if magic != _MAGIC:
            raise CheckpointError(f"{path} is not a decode checkpoint (bad magic {magic!r})")
        if version > _VERSION:
            raise CheckpointError(f"checkpoint {path} has version {version}, this build "
                                  f"reads <= {_VERSION}; upgrade before resuming")
        payload = blob[_HEADER.size:]
        if len(payload) != length:
            raise CheckpointError(f"checkpoint {path} is truncated: header promises {length} "
                                  f"payload bytes, file has {len(payload)}")
        if zlib.crc32(payload) != crc:
            raise CheckpointError(f"checkpoint {path} is corrupted (CRC32 mismatch); restore "
                                  f"refused — delete it and resume from an older snapshot")
        try:
            (hlen,) = struct.unpack_from("<I", payload)
            header = json.loads(payload[4:4 + hlen].decode())
            meta, leaves = header["meta"], header["leaves"]
        except (struct.error, ValueError, KeyError, UnicodeDecodeError) as e:
            raise CheckpointError(f"checkpoint {path} has an unreadable header: {e}") from e
        arrays, off = {}, 4 + hlen
        for leaf in leaves:
            shape = tuple(leaf["shape"])
            n = _itemsize(leaf["dtype"], path) * int(np.prod(shape, dtype=np.int64))
            raw = payload[off:off + n]
            if len(raw) != n:
                raise CheckpointError(f"checkpoint {path} leaf {leaf['name']!r} is short "
                                      f"({len(raw)} of {n} bytes)")
            arrays[leaf["name"]] = _from_raw(raw, leaf["dtype"], shape, path)
            off += n
        return cls(arrays, meta)


def runtime_plan_meta(rt: Any) -> dict:
    """The plan / model signature a checkpoint records and resume validates
    (the reference's keys): a split runtime adds its cuts, the hop codecs as
    they run (``*_pallas`` twins on the card) and the µ-batch count (1 for
    the sequential schedule)."""
    cfg = rt.cfg
    meta = {"mode": "split" if hasattr(rt, "split") else "local",
            "model": {"family": cfg.family, "num_layers": cfg.num_layers,
                      "hidden_size": cfg.hidden_size, "num_heads": cfg.num_heads,
                      "vocab_size": cfg.vocab_size}}
    if hasattr(rt, "split"):
        meta["cuts"] = [int(c) for c in rt.split.cuts]
        meta["hop_codecs"] = [c.name for c in rt.codecs]
        pipe = getattr(rt, "pipeline", None)
        meta["num_microbatches"] = int(pipe.num_microbatches) if pipe else 1
    return meta


def _host(t: torch.Tensor):
    """A cache tensor on the host: bf16 stays bf16 (raw words in the file)."""
    t = t.detach().cpu()
    return t if t.dtype == torch.bfloat16 else t.numpy()


def _device(a, device) -> torch.Tensor:
    return (a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))).to(device)


class LocalRuntime:
    """Single-device decode runtime with ``SplitRuntime``'s decode surface
    (``place_params`` / ``prefill_decode`` / ``decode_step``) on the port's
    ``prefill`` and ``decode_step``: the failover target when one stage
    survives, and the recovery path of ``generate``. Its cache is the same
    ``{"k", "v", "length"}`` dict, (L, B, capacity, KV, hd) K and V. No
    hops, no codecs, no counters."""

    def __init__(self, cfg, compute_dtype=None):
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.codecs: list = []
        self.faults = None

    def place_params(self, params: dict) -> dict:
        return params  # one device: nothing to place

    def prefill_decode(self, params: dict, input_ids: torch.Tensor, capacity: int,
                       fault_step: int = 0) -> tuple:
        logits, kv = prefill(self.cfg, params, input_ids.to(params["embed"].device),
                             int(capacity), compute_dtype=self.compute_dtype)
        return logits, {"k": kv.k, "v": kv.v, "length": int(kv.length)}

    def decode_step(self, params: dict, cache: dict, token_ids: torch.Tensor) -> tuple:
        logits, kv = decode_step(self.cfg, params,
                                 KVCache(cache["k"], cache["v"], int(cache["length"])),
                                 token_ids.to(params["embed"].device),
                                 compute_dtype=self.compute_dtype)
        return logits, {"k": kv.k, "v": kv.v, "length": int(kv.length)}

    def mark_stage_lost(self, stage: int) -> None:
        raise ValueError("LocalRuntime runs on a single device — there is no pipeline "
                         "stage to lose; stage_failure injection needs a split runtime")

    def link_counters(self, reset: bool = False) -> Optional[dict]:
        return None

    def decode_hop_bytes(self, batch: int) -> list:
        return []  # nothing crosses a wire

    def cache_state(self, cache: dict) -> dict:
        """The cache as host arrays: ``k`` / ``v`` (L, B, capacity, KV, hd)
        in the cache dtype, ``length`` int32."""
        return {"k": _host(cache["k"]), "v": _host(cache["v"]),
                "length": np.asarray(int(cache["length"]), np.int32)}

    def load_cache_state(self, state: dict, params: dict) -> dict:
        """:meth:`cache_state` output back on the weights' device."""
        dev = params["embed"].device
        return {"k": _device(state["k"], dev), "v": _device(state["v"], dev),
                "length": int(np.asarray(state["length"]))}
