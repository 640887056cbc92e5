"""Persisted, card-keyed measurements of the fused hop against the separate
hop (PyTorch counterpart of ``edgellm_tpu/codecs/probe_cache.py``).

``tools/pallas_probe.probe_fused_hops`` records each fused hop's measured
speedup over the separate hop (``fused_hop:<base>``) into a small JSON
cache keyed by the card's fingerprint; ``codecs/fused_hop.fused_hop_plan``
reads it for the CURRENT card, and by default fuses a hop only where the
card measured a win. A new card re-derives its verdicts on its first probe,
and a fused hop that stops winning stops being taken on the next.

The cache chooses only between hand-written paths (K8 against K3 / K4).
On a card every codec with a kernel twin runs the twin
(``parallel/split.apply_default_codec_backend``), whatever a probe read:
the reference's per-codec demotion to a plain codec is not ported.

Cache location: ``EDGELLM_PROBE_CACHE`` or
``~/.cache/edgellm_tpu_torch/pallas_wins.json``. Writes are atomic
(tmp + rename); a corrupt or unreadable cache gives "no data", never an
error. The keys are this package's fingerprints (``cuda:<card name>``,
``cpu:cpu``): an entry written for another backend is never read.
"""
from __future__ import annotations

import json
import math
import os
import tempfile
from typing import Optional


def _cache_path() -> str:
    return os.environ.get(
        "EDGELLM_PROBE_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "edgellm_tpu_torch",
                     "pallas_wins.json"))


def fingerprint(device=None) -> str:
    """The cache key of the device a run would use: ``cuda:<card name>``
    (``torch.cuda.get_device_name``) for a CUDA device, or the default card
    when ``device`` is None and a card exists; ``cpu:cpu`` otherwise."""
    import torch

    dev = torch.device(device) if device is not None else (
        torch.device("cuda") if torch.cuda.is_available() else torch.device("cpu"))
    if dev.type == "cuda":
        return f"cuda:{torch.cuda.get_device_name(dev)}"
    return f"{dev.type}:{dev.type}"


def base_name(codec_name: str) -> str:
    """Probe result names -> policy keys: the selective family probes as
    ``selective_int4_r<ratio>_<high>`` but is one substitution decision."""
    if codec_name.startswith("selective_int4"):
        return "selective_int4"
    return codec_name


def load_speedups(fp: Optional[str] = None) -> Optional[dict]:
    """``{name: measured roundtrip speedup}`` for this card, or None when the
    cache holds no data for it."""
    try:
        with open(_cache_path()) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(data, dict):
        return None
    entry = data.get(fp or fingerprint())
    if not isinstance(entry, dict):
        return None
    speedups = entry.get("speedups")
    if not isinstance(speedups, dict):
        return None
    out = {k: float(v) for k, v in speedups.items()
           if isinstance(v, (int, float)) and math.isfinite(v)}
    return out or None


def record(results, fp: Optional[str] = None) -> Optional[str]:
    """Merge one probe run's rows into the cache under this card's
    fingerprint; returns the cache path written, or None when the rows carry
    no finite speedups (parity-only probes on the CPU). An unwritable
    location is a no-op, not an error."""
    speedups = {}
    for r in results:
        # the unrounded ratio: WIN_MARGIN must never see a 1.045 reading
        # rounded up to 1.05
        s = r.get("roundtrip_speedup_vs_jnp_raw", r.get("roundtrip_speedup_vs_jnp"))
        if isinstance(s, (int, float)) and math.isfinite(s):
            speedups[base_name(r["codec"])] = float(s)
    if not speedups:
        return None
    path = _cache_path()
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        try:
            with open(path) as f:
                data = json.load(f)
            if not isinstance(data, dict):
                data = {}
        except (OSError, ValueError):
            data = {}
        key = fp or fingerprint()
        entry = data.get(key) if isinstance(data.get(key), dict) else {}
        merged = dict(entry.get("speedups") or {})
        merged.update(speedups)
        data[key] = {"speedups": merged}
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".", suffix=".tmp")
        with os.fdopen(fd, "w") as f:
            json.dump(data, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
        return path
    except OSError:
        return None


#: a win requires the measured speedup to clear this margin, not just 1.0: a
#: median of interleaved pairs still swings a few percent from run to run,
#: and a path oscillating around break-even must not flap into the default
#: on one 1.02x reading
WIN_MARGIN = 1.05


def measured_win(codec_name: str, fp: Optional[str] = None) -> Optional[bool]:
    """True/False when this card has a measurement for the codec (win =
    speedup >= WIN_MARGIN), None when there is no data (never probed)."""
    speedups = load_speedups(fp)
    if speedups is None:
        return None
    s = speedups.get(base_name(codec_name))
    if s is None:
        return None
    return s >= WIN_MARGIN


__all__ = ["fingerprint", "base_name", "load_speedups", "record", "WIN_MARGIN",
           "measured_win"]
