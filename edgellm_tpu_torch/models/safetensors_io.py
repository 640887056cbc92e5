"""Direct safetensors -> parameter-dict loading with numpy, no ``transformers``
(PyTorch counterpart of ``edgellm_tpu/models/safetensors_io.py``).

Checkpoints load straight from the safetensors container into the
stacked-layer parameter dict: the format is an
8-byte little-endian header length, a JSON header mapping tensor names to
``{dtype, shape, data_offsets}``, then one flat data buffer — trivially
readable with numpy alone. bf16 tensors (no numpy dtype) are upcast to fp32 by
bit-shifting into the float32 mantissa layout.

Entry points:
- :func:`read_safetensors` — one ``.safetensors`` file -> dict of np arrays;
- :func:`load_checkpoint` — a file or an HF model directory (handles the
  multi-shard ``model.safetensors.index.json`` layout and builds the
  :class:`ModelConfig` from the directory's ``config.json``) -> (cfg, params).
"""
from __future__ import annotations

import json
import os
import struct
from types import SimpleNamespace
from typing import Optional

import numpy as np

from .configs import ModelConfig
from .hf_loader import config_from_hf, params_from_state_dict

_DTYPES = {
    "F64": np.float64,
    "F32": np.float32,
    "F16": np.float16,
    "I64": np.int64,
    "I32": np.int32,
    "I16": np.int16,
    "I8": np.int8,
    "U8": np.uint8,
    "BOOL": np.bool_,
    # BF16 handled specially (no numpy dtype)
}


def _bf16_to_f32(raw: np.ndarray) -> np.ndarray:
    """uint16 bf16 bit patterns -> float32 (shift into the high mantissa half)."""
    return (raw.astype(np.uint32) << 16).view(np.float32)


_DTYPE_BYTES = {"F64": 8, "F32": 4, "F16": 2, "BF16": 2, "I64": 8, "I32": 4,
                "I16": 2, "I8": 1, "U8": 1, "BOOL": 1}


def _parse_header(f, path: str):
    """(header dict, data-section byte length), or ValueError saying exactly
    what is malformed — a truncated download dies here, not in numpy."""
    size = os.fstat(f.fileno()).st_size
    head = f.read(8)
    if len(head) < 8:
        raise ValueError(f"{path}: not a safetensors file — only {size} bytes "
                         f"(needs an 8-byte header length); re-download it")
    (header_len,) = struct.unpack("<Q", head)
    if header_len == 0 or 8 + header_len > size:
        raise ValueError(
            f"{path}: corrupt safetensors — header claims {header_len} bytes "
            f"but the file holds {size}; the download is likely truncated, "
            f"re-fetch it")
    try:
        header = json.loads(f.read(header_len))
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise ValueError(f"{path}: corrupt safetensors — header is not valid "
                         f"JSON ({e}); re-download the file") from e
    if not isinstance(header, dict):
        raise ValueError(f"{path}: corrupt safetensors — header must be a "
                         f"JSON object, got {type(header).__name__}")
    return header, size - 8 - header_len


def verify_safetensors_integrity(path: str) -> dict:
    """Structural integrity check of one ``.safetensors`` file, BEFORE any
    tensor is materialized: the header parses, every tensor's dtype is known,
    its ``data_offsets`` lie inside the data section in order, and the byte
    span matches ``prod(shape) * itemsize`` exactly. Returns
    ``{"tensors": n, "data_bytes": n}``; raises ValueError with an actionable
    message (which tensor, what mismatch) on the first inconsistency.
    :func:`read_safetensors` runs this on every load."""
    with open(path, "rb") as f:
        header, data_bytes = _parse_header(f, path)
    n = 0
    end_prev = 0
    entries = [(name, meta) for name, meta in header.items()
               if name != "__metadata__"]
    # safetensors stores tensors contiguously in offset order; validate in
    # that order so overlaps and gaps are caught, not just bounds
    for name, meta in sorted(entries, key=lambda kv: kv[1]["data_offsets"][0]):
        itemsize = _DTYPE_BYTES.get(meta.get("dtype"))
        if itemsize is None:
            raise ValueError(f"{path}: tensor {name!r} has unsupported dtype "
                             f"{meta.get('dtype')!r}")
        start, end = meta["data_offsets"]
        want = int(np.prod(meta["shape"], dtype=np.int64)) * itemsize
        if not 0 <= start <= end <= data_bytes:
            raise ValueError(
                f"{path}: tensor {name!r} data_offsets [{start}, {end}) fall "
                f"outside the {data_bytes}-byte data section — truncated or "
                f"corrupt download, re-fetch the file")
        if end - start != want:
            raise ValueError(
                f"{path}: tensor {name!r} spans {end - start} bytes but shape "
                f"{meta['shape']} x {meta['dtype']} needs {want} — header and "
                f"data disagree, the file is corrupt")
        if start < end_prev:
            raise ValueError(f"{path}: tensor {name!r} overlaps the previous "
                             f"tensor's bytes — the file is corrupt")
        end_prev = end
        n += 1
    return {"tensors": n, "data_bytes": data_bytes}


def read_safetensors(path: str) -> dict:
    """Parse one ``.safetensors`` file into {name: np.ndarray} (bf16 -> fp32).
    The structural integrity check runs first, so a truncated or bit-rotted
    checkpoint raises an actionable error instead of loading garbage."""
    verify_safetensors_integrity(path)
    with open(path, "rb") as f:
        (header_len,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(header_len))
        data = f.read()
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        start, end = meta["data_offsets"]
        buf = data[start:end]
        shape = tuple(meta["shape"])
        if meta["dtype"] == "BF16":
            out[name] = _bf16_to_f32(np.frombuffer(buf, np.uint16)).reshape(shape)
        else:
            dt = _DTYPES.get(meta["dtype"])
            if dt is None:
                raise ValueError(f"unsupported safetensors dtype {meta['dtype']!r} "
                                 f"for tensor {name!r}")
            out[name] = np.frombuffer(buf, dt).reshape(shape)
    return out


def _read_dir_tensors(model_dir: str) -> dict:
    """All tensors of an HF model directory (single- or multi-shard layout)."""
    index_path = os.path.join(model_dir, "model.safetensors.index.json")
    if os.path.exists(index_path):
        with open(index_path) as f:
            index = json.load(f)
        tensors = {}
        for shard in sorted(set(index["weight_map"].values())):
            tensors.update(read_safetensors(os.path.join(model_dir, shard)))
        return tensors
    single = os.path.join(model_dir, "model.safetensors")
    if os.path.exists(single):
        return read_safetensors(single)
    candidates = [f for f in os.listdir(model_dir) if f.endswith(".safetensors")]
    if len(candidates) == 1:
        return read_safetensors(os.path.join(model_dir, candidates[0]))
    raise FileNotFoundError(
        f"no model.safetensors(.index.json) in {model_dir!r} (found: {candidates})")


def config_from_dir(model_dir: str) -> ModelConfig:
    """Build the ModelConfig from a directory's ``config.json`` (no transformers
    import — the JSON keys are read through the same mapping as
    :func:`config_from_hf`)."""
    with open(os.path.join(model_dir, "config.json")) as f:
        raw = json.load(f)
    return config_from_hf(SimpleNamespace(**raw))


def load_checkpoint(path: str, cfg: Optional[ModelConfig] = None, device="cuda"):
    """(cfg, params) from a ``.safetensors`` file or an HF model directory,
    params on ``device``.

    For a bare file, ``cfg`` must be supplied (e.g. a preset); for a directory
    it is read from ``config.json`` unless overridden. This is the path that
    makes ``run.py --weights model.safetensors`` work the moment a checkpoint
    artifact appears.
    """
    if os.path.isdir(path):
        cfg = cfg or config_from_dir(path)
        sd = _read_dir_tensors(path)
    else:
        if cfg is None:
            raise ValueError("loading a bare .safetensors file requires a ModelConfig "
                             "(pass --model <preset>)")
        sd = read_safetensors(path)
    if cfg.tie_word_embeddings and "lm_head.weight" in sd and \
            "model.embed_tokens.weight" not in sd:
        # some exports store only the tied head; the loader expects the embed key
        sd["model.embed_tokens.weight"] = sd["lm_head.weight"]
    return cfg, params_from_state_dict(cfg, sd, device=device)
