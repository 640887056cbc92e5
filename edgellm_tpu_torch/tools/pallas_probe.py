"""The codec kernels and fused hops on the card, against their plain
versions: parity, speed, and the probe cache the fused-hop gate reads
(PyTorch counterpart of ``edgellm_tpu/tools/pallas_probe.py`` and of
``bench.py``'s ``wire_main``).

    python -m edgellm_tpu_torch.tools.pallas_probe [--device cuda] [--no-fused]

- :func:`probe_codec` / :func:`probe_all`: every kernel twin
  (``codec_kernels._PALLAS_FACTORIES``) against its plain codec on one
  (batch, seq, dim) float32 hidden: integer payload leaves bit for bit,
  float leaves and the decode within 2 ulp, and the encode -> decode
  roundtrip's speedup. These rows are a report: on the card every codec
  with a twin runs the twin whatever it reads, so a measured loss
  (``measured_win`` False) is a finding, not a demotion, and nothing is
  recorded.
- :func:`probe_fused_hops`: for each ``FUSED_CAPABLE`` base codec, the
  fused hop the gate would run on the card ("remote", K8, for a
  ``REMOTE_CAPABLE`` base, "wire" otherwise) against the separate hop with
  the same codec, ``fused_equals_fallback`` bit for bit, the unrounded
  ratio separate / fused (``roundtrip_speedup_vs_jnp_raw``) recorded into
  ``codecs/probe_cache.py``'s cache as ``fused_hop:<base>`` under this
  card's fingerprint, with each row's ``probe_decision``.

The estimator is the reference's: interleaved (fast path, plain path)
pairs, each timed by CUDA events after a synchronize around back-to-back
calls, and the median of the per-pair ratios (a slow phase of the card
hits both halves of a pair). The events see what a split forward sees of a
hop on this host-bound path: the host's launches where they outlast the
card's work. The card's time alone (a sleep kernel queued first keeps the
host ahead of the events) is reported beside it as ``device_speedup``.
Off the card the probes check parity only: rows carry ``timing_skipped``
and nothing is recorded. ``selective_int4`` has no twin
(``SELECTIVE_EXCLUSION``) and is listed as excluded.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
from typing import Optional

import numpy as np
import torch

#: every codec with a kernel twin
PROBE_CODECS = ("int4_per_token", "int8_per_token", "int8_per_channel", "int4_per_channel",
                "ternary_mean", "ternary_max")


def _ulp_diff(got: np.ndarray, want: np.ndarray) -> int:
    """Max distance in representable steps between two same-dtype float arrays."""
    if got.size == 0:
        return 0
    kind = {2: np.int16, 4: np.int32, 8: np.int64}[got.dtype.itemsize]
    lowest = np.int64(np.iinfo(kind).min)  # the bit pattern of -0.0
    gi = got.view(kind).astype(np.int64)
    wi = want.view(kind).astype(np.int64)
    # the sign-magnitude encoding onto a monotone integer line, -0.0 -> 0
    gi = np.where(gi < 0, lowest - gi, gi)
    wi = np.where(wi < 0, lowest - wi, wi)
    return int(np.abs(gi - wi).max())


def _host(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.detach().cpu().view(torch.int16).numpy().view(np.uint16)
    return t.detach().cpu().numpy()


def _compare_payloads(got: dict, want: dict, max_ulp: int) -> tuple:
    """(integer leaves bit for bit, worst float-leaf ulp); raises on a
    mismatch."""
    if set(got) != set(want):
        raise AssertionError(f"payload keys differ: {sorted(got)} vs {sorted(want)}")
    n_int, worst = 0, 0
    for key in sorted(want):
        g, w = got[key], want[key]
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"{key}: {g.dtype}{tuple(g.shape)} vs {w.dtype}{tuple(w.shape)}")
        if g.is_floating_point():
            ulp = _ulp_diff(_host(g), _host(w))
            if ulp > max_ulp:
                raise AssertionError(f"{key}: {ulp} ulp > {max_ulp}")
            worst = max(worst, ulp)
        else:
            if not torch.equal(g.cpu(), w.cpu()):
                raise AssertionError(f"{key}: integer leaves differ")
            n_int += 1
    return n_int, worst


#: the sleep queued ahead of a timed run, in card cycles (≈ 10 ms on an
#: H100)
_SLEEP_CYCLES = 20_000_000


def _event_ms(fn, xs: list, iters: int, ahead: bool = False) -> float:
    """Mean ms of ``fn`` over ``iters`` calls cycling ``xs``, by CUDA events
    after a synchronize. With ``ahead`` a sleep kernel is queued first, and
    the start event must still be pending when the host has enqueued the
    last call (else the run is repeated with half the calls, the launch
    queue having filled, then with a longer sleep): the events then time the
    card's work alone. Without it they time the host-bound wall."""
    cycles = _SLEEP_CYCLES
    for _ in range(10):
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        if ahead:
            torch.cuda._sleep(cycles)
        start.record()
        for i in range(iters):
            fn(xs[i % len(xs)])
        end.record()
        host_behind = ahead and start.query()
        end.synchronize()
        if not host_behind:
            return start.elapsed_time(end) / iters
        if iters > 2:
            iters //= 2
        else:
            cycles *= 2
    raise RuntimeError("the host never got ahead of the card: does the timed call "
                       "synchronize?")


def paired_medians(fn_k, fn_p, xs: list, *, reps: int = 5, iters: int = 20,
                   ahead: bool = False) -> tuple:
    """(median fast-path ms, median plain ms, median of per-pair plain / fast
    ratios) over ``reps`` interleaved pairs, both warmed first; ``ahead``:
    the card's time alone (:func:`_event_ms`)."""
    fn_k(xs[0])
    fn_p(xs[0])
    tk, tp, ratios = [], [], []
    for _ in range(reps):
        k = _event_ms(fn_k, xs, iters, ahead)
        p = _event_ms(fn_p, xs, iters, ahead)
        tk.append(k)
        tp.append(p)
        if k > 0:
            ratios.append(p / k)
    return (statistics.median(tk), statistics.median(tp),
            statistics.median(ratios) if ratios else float("nan"))


def _timed(row: dict, fast, plain, xs: list, fast_key: str, plain_key: str, reps: int,
           iters: int) -> float:
    """Fill ``row`` with the estimator's pair (µs and ratio) and the card's
    time beside it; returns the unrounded ratio plain / fast."""
    from ..codecs.probe_cache import WIN_MARGIN

    f_ms, p_ms, ratio = paired_medians(fast, plain, xs, reps=reps, iters=iters)
    dev = paired_medians(fast, plain, xs, reps=reps, iters=iters, ahead=True)
    row.update({f"{fast_key}_us": round(f_ms * 1e3, 2), f"{plain_key}_us": round(p_ms * 1e3, 2),
                f"{fast_key}_device_us": round(dev[0] * 1e3, 2),
                f"{plain_key}_device_us": round(dev[1] * 1e3, 2),
                "device_speedup": round(dev[2], 3)})
    if math.isfinite(ratio):
        row["roundtrip_speedup_vs_jnp"] = round(ratio, 2)
        # the UNROUNDED ratio is what the cache keeps: WIN_MARGIN must never
        # see a 1.045 reading rounded to 1.05
        row["roundtrip_speedup_vs_jnp_raw"] = ratio
        row["measured_win"] = ratio >= WIN_MARGIN
    return ratio


def probe_codec(name: str, *, batch: int = 8, seq: int = 512, dim: int = 896,
                pool: int = 4, timing: bool = True, reps: int = 5, iters: int = 20,
                max_ulp: int = 2, seed: int = 0, device="cuda") -> dict:
    """Parity (and, with ``timing``, the roundtrip speedup) of one codec's
    kernel twin against its plain codec on ``device``."""
    from ..codecs.codec_kernels import pallas_variant
    from ..codecs.packing import get_wire_codec

    plain = get_wire_codec(name)
    twin = pallas_variant(plain)
    gen = np.random.default_rng(seed)
    xs = [torch.from_numpy(gen.standard_normal((batch, seq, dim)).astype(np.float32)).to(device)
          for _ in range(pool if timing else 1)]
    want, got = plain.encode(xs[0]), twin.encode(xs[0])
    n_int, enc_ulp = _compare_payloads(got, want, max_ulp)
    dec_ulp = _ulp_diff(_host(twin.decode(got)), _host(plain.decode(want)))
    if dec_ulp > max_ulp:
        raise AssertionError(f"{name} decode: {dec_ulp} ulp > {max_ulp}")
    payload_bytes = int(sum(t.numel() * t.element_size() for t in want.values()))
    row = {"codec": name, "twin": twin.name, "device": str(device), "shape": [batch, seq, dim],
           "int_leaves_bit_identical": n_int, "encode_max_ulp": enc_ulp,
           "decode_max_ulp": dec_ulp, "payload_bytes": payload_bytes}
    if not timing:
        row["timing_skipped"] = f"device {device}: kernel timing is only meaningful on the card"
        return row

    def roundtrip(codec):
        return lambda x: codec.decode(codec.encode(x))

    _timed(row, roundtrip(twin), roundtrip(plain), xs, "roundtrip", "plain_roundtrip", reps,
           iters)
    moved = 2 * (batch * seq * dim * 4 + payload_bytes)  # encode + decode, read + write
    row["roundtrip_gbps"] = round(moved / (row["roundtrip_device_us"] * 1e-6) / 1e9, 2)
    return row


def probe_all(*, timing: Optional[bool] = None, batch: int = 8, seq: int = 512,
              dim: int = 896, device="cuda", **kw) -> dict:
    """Every twin's parity, and on the card its speedup: a report, recorded
    nowhere (the twins run on the card whatever they read)."""
    from ..codecs.codec_kernels import SELECTIVE_EXCLUSION

    if timing is None:
        timing = torch.device(device).type == "cuda"
    rows = [probe_codec(n, batch=batch, seq=seq, dim=dim, timing=timing, device=device, **kw)
            for n in PROBE_CODECS]
    rows.append({"codec": "selective_int4", "excluded": SELECTIVE_EXCLUSION})
    return {"device": str(device), "shape": [batch, seq, dim],
            "parity": "int leaves bit-identical; float leaves and decode <= 2 ulp",
            "timing": "roundtrip per codec, interleaved pairs" if timing else None,
            "codecs": rows}


def probe_fused_hops(*, batch: int = 8, seq: int = 512, dim: int = 896, reps: int = 5,
                     iters: int = 20, timing: Optional[bool] = None, seed: int = 0,
                     device="cuda") -> dict:
    """Each fused-capable base codec's fused hop against its separate hop on
    ``device``: bit-for-bit parity, and on the card the ratio separate /
    fused recorded as ``fused_hop:<base>``."""
    from ..codecs import probe_cache
    from ..codecs.fused_hop import FUSED_CAPABLE, REMOTE_CAPABLE, FusedHopPlan, fused_hop
    from ..codecs.wire_format import WireFormat
    from ..parallel.split import _hop, apply_default_codec_backend

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if timing is None:
        timing = on_card
    fp = probe_cache.fingerprint(dev)
    gen = np.random.default_rng(seed)
    hidden = torch.from_numpy(gen.standard_normal((batch, seq, dim)).astype(np.float32)).to(dev)
    rows, cache_rows = [], []
    for base in sorted(FUSED_CAPABLE):
        codec = apply_default_codec_backend([base], dev)[0]
        mode = "remote" if on_card and base in REMOTE_CAPABLE else "wire"
        plan = FusedHopPlan(mode, base, "probe")

        def fused(h, codec=codec, plan=plan):
            return fused_hop(plan, codec, h, dev)

        def separate(h, codec=codec):
            return _hop(codec, h, None, dev)

        out_f, out_s = fused(hidden), separate(hidden)
        wf = WireFormat.for_codec(codec, hidden.shape, hidden.dtype)
        row = {"codec": base, "hop_codec": codec.name, "mode": mode, "device": str(dev),
               "shape": [batch, seq, dim], "wire_bytes": wf.wire_nbytes,
               "payload_bytes": wf.payload_nbytes, "remote_capable": base in REMOTE_CAPABLE,
               "fused_equals_fallback": bool(out_f.dtype == out_s.dtype
                                             and torch.equal(out_f, out_s))}
        if timing:
            ratio = _timed(row, fused, separate, [hidden], "fused", "fallback", reps, iters)
            cache_rows.append({"codec": f"fused_hop:{base}",
                               "roundtrip_speedup_vs_jnp_raw": ratio})
        else:
            row["timing_skipped"] = f"device {dev}: hop timing is only meaningful on the card"
        rows.append(row)
    cache_path = probe_cache.record(cache_rows, fp=fp) if cache_rows else None
    for row in rows:
        row["probe_decision"] = {
            "measured_win": probe_cache.measured_win(f"fused_hop:{row['codec']}", fp),
            "win_margin": probe_cache.WIN_MARGIN}
    return {"device": str(dev), "fingerprint": fp, "probe_cache": cache_path, "hops": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--dim", type=int, default=896)
    ap.add_argument("--no-fused", action="store_true", help="skip the fused-hop probe")
    args = ap.parse_args(argv)
    shape = dict(batch=args.batch, seq=args.seq, dim=args.dim, device=args.device)
    for row in probe_all(**shape)["codecs"]:
        print(json.dumps(row), flush=True)
    if not args.no_fused:
        hops = probe_fused_hops(**shape)
        for row in hops["hops"]:
            print(json.dumps(row), flush=True)
        print(json.dumps({"probe_cache": hops["probe_cache"],
                          "fingerprint": hops["fingerprint"]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
