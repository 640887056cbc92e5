"""Layer 4: latticelint, the config-lattice verifier (the reference's
``edgellm_tpu/lint/lattice.py``: the same rule ids, oracle, fuzz blocks and
matrix schema).

The other layers check code; this one checks the CONFIG lattice. Every
``configs/*.json`` must (1) pass the port CLI's params validator, (2) run
its serve / eval entry points once at lint geometry (``LL-lower``: torch
has no ahead-of-time lowering, so "lowers" means "runs once"), (3) keep its
KV/pool buffers in place across those calls (``LL-donate``, the
``in_place`` check of the graph contracts), (4) hold its measured footprint
under its own ``"budget"`` block on the card (``LL-budget``), and (5) have a
``configs/README.md`` table row.

On top of the shipped configs, the feature lattice is fuzzed pairwise:
every two-block combination of the serve/split feature set must either
validate AND run, or be refused with the exact message :data:`PAIR_ORACLE`
pins (the reference's, word for word), so a validator rule cannot drift
from what the builders accept, in either direction. The sweep shares one
cache keyed by plan geometry, so the 27 configs and ~90 combos resolve to
a couple dozen distinct calls.

The footprint rule (``LL-budget``). The reference's ``aot_peak_bytes`` are
XLA's argument + output + temp bytes of the lowered entry points at the
reference's lint geometry. The card's absolute allocator peak holds
everything resident (the cuBLAS workspace alone is tens of MiB on an
H100), so the port measures, on a warm second call of each entry point:
the increment of ``torch.cuda.max_memory_allocated`` over
``memory_allocated`` just before the call
(:func:`~..analysis.aot.cuda_increment_bytes`), plus the bytes of the
call's tensor arguments (weights, ids, caches, pools). The footprint is
measured at the REFERENCE's geometry (hidden 32), where the budget is
defined, on the lint's device; the other checks run at the graph layer's
geometry (:func:`~.entrypoints.lint_geometry`: on the card hd 64, so the
kernels launch). A CPU run has no device allocator: it records a skip note
unless a ``peak_reader`` is injected (the tests).

The side product is ``capability_matrix.json`` (:data:`MATRIX_SCHEMA`): per
config its features, its entry points with the kernels they launched and
the port's byte columns, the in-place map and the refusal reasons.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import re
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

from .report import Finding

#: schema tag stamped into capability_matrix.json: bump on layout change
MATRIX_SCHEMA = "edgellm.capability_matrix/v1"

RULE_VALIDATE = "LL-validate"   # configs/*.json fails the CLI's validation
RULE_README = "LL-readme"       # configs/README.md drift (row <-> file)
RULE_LOWER = "LL-lower"         # an entry point fails to run once
RULE_BUDGET = "LL-budget"       # missing budget block or footprint over it
RULE_DONATE = "LL-donate"       # a KV/pool buffer was not kept in place
RULE_COMPAT = "LL-compat"       # pairwise fuzz: validator/builder drift

#: lint-scale geometry, identical to the graph layer's (entrypoints.py)
BATCH, SEQ, CAPACITY = 1, 8, 16
SPEC_K = 4                      # speculative verify window
SWEEP_W, SWEEP_S, SWEEP_TAIL = 2, 32, 9  # eval-sweep window batch/len/tail
MAX_TINY_PAGES = 64             # pool-page cap at lint scale (note on clamp)

# ---------------------------------------------------------------------------
# pairwise feature-composition oracle (the reference's, word for word)
# ---------------------------------------------------------------------------

_MSG_SPEC_BATCH = (
    "speculative runs the one-stream spec loop; the batcher's ragged step "
    "verifies one token per slot — drop 'speculative' or 'batching'")
_MSG_FUSED_LINK = (
    "fused_hops: an active faults/fec/hedge link owns the hop protocol — "
    "fusion is refused at runtime; set fused_hops: 'off' or drop the link "
    "config")
_MSG_PIPE_SPEC = (
    "pipeline + speculative: the spec loop verifies one stream at a time "
    "(B == 1), leaving nothing to micro-batch — drop one of the two blocks")
_MSG_KVQ_PIPE = (
    "kv_at_rest + pipeline: quantized paged decode composes with the "
    "unpipelined split runtime only — drop 'pipeline' or use codec 'fp'")

#: every pair of feature blocks the CLI REFUSES, with the exact message its
#: validator gives (``params.json: `` prefix stripped). Absent pairs must
#: validate AND run.
PAIR_ORACLE: Dict[Tuple[str, str], str] = {
    ("batching", "speculative"): _MSG_SPEC_BATCH,
    ("cluster", "speculative"): _MSG_SPEC_BATCH,
    ("disagg", "speculative"): _MSG_SPEC_BATCH,
    ("gray", "speculative"): _MSG_SPEC_BATCH,
    ("kv_at_rest", "speculative"): _MSG_SPEC_BATCH,
    ("prefix_cache", "speculative"): _MSG_SPEC_BATCH,
    ("faults", "fused_hops"): _MSG_FUSED_LINK,
    ("fec", "fused_hops"): _MSG_FUSED_LINK,
    ("fused_hops", "hedge"): _MSG_FUSED_LINK,
    ("pipeline", "speculative"): _MSG_PIPE_SPEC,
    ("kv_at_rest", "pipeline"): _MSG_KVQ_PIPE,
}

#: minimal valid params block per feature, composed onto a bare serve config
FUZZ_BLOCKS: Dict[str, dict] = {
    "cuts": {"cuts": [2], "hop_codecs": ["int8_per_token"]},
    "faults": {"faults": {"drop_rate": 0.05, "seed": 0}},
    "fec": {"fec": {"enabled": True}},
    "hedge": {"hedge": {"routes": 2}},
    "fused_hops": {"fused_hops": "wire"},
    "pipeline": {"pipeline": {"num_microbatches": 2}},
    "speculative": {"speculative": {"k": 4}},
    "batching": {"batching": {"page_size": 8, "num_pages": 10,
                              "max_slots": 2, "pages_per_slot": 2}},
    "prefix_cache": {"prefix_cache": {"enabled": True}},
    "kv_at_rest": {"kv_at_rest": {"codec": "int8_per_channel"}},
    "cluster": {"cluster": {"num_replicas": 2}},
    "disagg": {"disagg": {"num_prefill_workers": 1}},
    "gray": {"gray": {"p95_multiple": 3.0}},
}

#: structural prerequisites a feature block cannot validate without,
#: pulled in silently when composing a combo
FUZZ_DEPS: Dict[str, Tuple[str, ...]] = {
    "fec": ("faults",), "hedge": ("faults",),
    "pipeline": ("cuts",), "speculative": ("cuts",), "fused_hops": ("cuts",),
    "prefix_cache": ("batching",), "kv_at_rest": ("batching",),
    "cluster": ("batching",), "disagg": ("batching",),
    # dep expansion is one level deep, so gray names cluster's own
    # scaffolding explicitly
    "gray": ("cluster", "batching"),
}

FUZZ_BASE = {"experiment": "serve", "serving": {}}

#: params keys that count as composable features in the matrix
FEATURE_KEYS = (
    "cuts", "faults", "link_policy", "fec", "hedge", "link_health",
    "fused_hops", "pipeline", "speculative", "serving", "batching",
    "prefix_cache", "kv_at_rest", "cluster", "disagg", "gray", "deadline",
    "stage_failure", "recovery", "n_seq")


def compose_combo(names: Tuple[str, ...]) -> dict:
    """Minimal serve params exercising exactly the feature blocks in
    ``names`` (plus their :data:`FUZZ_DEPS` scaffolding)."""
    p = dict(FUZZ_BASE)
    want = list(names)
    for n in names:
        for d in FUZZ_DEPS.get(n, ()):
            if d not in want:
                want.append(d)
    for n in want:
        for k, v in FUZZ_BLOCKS[n].items():
            p.setdefault(k, v)
    return p


def default_configs_dir() -> Path:
    """``<repo>/configs`` beside the package."""
    return Path(__file__).resolve().parents[2] / "configs"


def config_features(p: dict) -> List[str]:
    """The feature blocks a params dict composes, for the matrix."""
    return sorted(k for k in FEATURE_KEYS if k in p)


def _validate(p: dict, device="cpu") -> Optional[str]:
    """The port CLI's params validation -> None (ok) or the refusal message
    with the ``params.json: `` prefix stripped."""
    from ..run import _validate_params_json

    try:
        _validate_params_json(p, device=device)
        return None
    except SystemExit as e:
        msg = str(e)
        return msg[len("params.json: "):] if msg.startswith(
            "params.json: ") else msg


# ---------------------------------------------------------------------------
# README parity
# ---------------------------------------------------------------------------

def readme_parity_findings(configs_dir: Path) -> List[Finding]:
    """Every ``configs/*.json`` needs a README table row and vice versa."""
    readme = configs_dir / "README.md"
    where = str(readme)
    if not readme.exists():
        return [Finding(layer="lattice", rule=RULE_README, where=where,
                        line=0, message="configs/README.md is missing")]
    text = readme.read_text(encoding="utf-8")
    # only the first column of a TABLE row registers a config: prose and
    # description cells may mention produced artifacts or upstream files
    cells = [ln.split("|")[1] for ln in text.splitlines()
             if ln.lstrip().startswith("|") and ln.count("|") >= 2]
    mentioned = set(re.findall(r"`([\w.\-]+\.json)`", "\n".join(cells)))
    present = {f.name for f in configs_dir.glob("*.json")}
    findings = []
    for name in sorted(present - mentioned):
        findings.append(Finding(
            layer="lattice", rule=RULE_README, where=where, line=0,
            message=f"configs/{name} has no README table row"))
    for name in sorted(mentioned - present):
        findings.append(Finding(
            layer="lattice", rule=RULE_README, where=where, line=0,
            message=f"README mentions `{name}` but configs/{name} does not "
                    f"exist"))
    return findings


# ---------------------------------------------------------------------------
# in place (the reference's donation)
# ---------------------------------------------------------------------------

def aliased_count(buffers: list, outputs: list) -> int:
    """How many of ``outputs`` hold the storage of one of ``buffers``."""
    kept = {t.untyped_storage().data_ptr() for t in buffers}
    return sum(1 for t in outputs if t.untyped_storage().data_ptr() in kept)


def donation_findings(buffers: list, outputs: list, required: int,
                      where: str) -> List[Finding]:
    """LL-donate findings for one executed entry point: its outputs must
    hold at least ``required`` of its KV / page-pool buffers in the same
    storage. Unit-tested directly against a call that rebuilds its cache
    (the seeded missing-donation fixture)."""
    kept = aliased_count(buffers, outputs)
    if kept >= required:
        return []
    return [Finding(
        layer="lattice", rule=RULE_DONATE, where=where, line=0,
        message=f"entry point keeps {kept} KV/pool buffer(s) in place, needs "
                f">= {required} (a cache rebuilt every step doubles its "
                f"memory)")]


# ---------------------------------------------------------------------------
# entry-point planning + one run each
# ---------------------------------------------------------------------------

class _Prepared:
    """One entry point ready to run: ``call()``, its tensor arguments (for
    the footprint), and its in-place buffers with the outputs that must
    hold them."""

    def __init__(self, call: Callable[[], Any], args: list, required: int = 0,
                 buffers: Optional[list] = None,
                 outputs_of: Optional[Callable] = None):
        self.call, self.args, self.required = call, args, required
        self.buffers, self.outputs_of = buffers or [], outputs_of


class _Entry:
    """One entry point of a config's plan."""

    def __init__(self, name: str, key: str, build: Callable[[], _Prepared]):
        self.name = name
        self.key = key      # cache key (plan geometry signature)
        self.build = build


def _tensor_bytes(tensors) -> int:
    """Bytes of distinct tensors (one per data pointer)."""
    seen: Dict[int, int] = {}
    for t in tensors:
        seen.setdefault(t.data_ptr(), t.numel() * t.element_size())
    return sum(seen.values())


class _Lattice:
    """A lint-geometry world + the cache of its entries' results."""

    def __init__(self, device, geometry: dict,
                 peak_reader: Optional[Callable] = None) -> None:
        import torch

        from ..models.configs import tiny_config
        from ..models.transformer import init_params

        self.torch = torch
        self.device = torch.device(device)
        self.geometry = geometry
        self.cfg = tiny_config("qwen2", **geometry)
        gen = torch.Generator(device=self.device).manual_seed(0)
        self.params = init_params(self.cfg, gen, device=self.device)
        #: reads one call's bytes above what was resident; None: not measured
        self.peak_reader = peak_reader
        self.cache: Dict[str, dict] = {}

    # -- cache -------------------------------------------------------------

    def evaluate(self, entry: _Entry) -> dict:
        """Run (or fetch) one entry: its launches and in-place count, and
        with a ``peak_reader`` its footprint on a warm second call. Errors
        are captured per entry: one broken config must not abort the
        sweep."""
        if entry.key in self.cache:
            return self.cache[entry.key]
        from ..analysis.aot import call_total_bytes
        from .contracts import execute

        try:
            prep = entry.build()
            ex = execute(prep.call, self.device)
            if ex.error is not None:
                raise ex.error
            res: Dict[str, Any] = {"launches": ex.launches,
                                   "required": prep.required}
            if prep.required:
                res["donated"] = aliased_count(prep.buffers,
                                               prep.outputs_of(ex.result))
            del ex
            if self.peak_reader is not None:
                inc = call_total_bytes(prep.call, self.device, self.peak_reader)
                args = _tensor_bytes(prep.args)
                res["bytes"] = None if inc is None else {
                    "argument_bytes": args, "increment_bytes": inc,
                    "total_bytes": args + inc}
        except Exception as e:  # noqa: BLE001 — surfaced as LL-lower
            res = {"error": f"{type(e).__name__}: {e}"}
        self.cache[entry.key] = res
        return res

    # -- tiny-geometry mapping ----------------------------------------------

    def tiny_cuts(self, n: int) -> Tuple[int, ...]:
        """Map a config's cut count onto the 4-layer lint model (valid cut
        positions 0..2): the stage COUNT is what shapes the call."""
        return {1: (2,), 2: (1, 2)}.get(min(n, 3), (0, 1, 2))

    def tiny_layers(self, layers: Any) -> Tuple[int, ...]:
        """Clamp real-model layer indices into the tiny model's range."""
        out = sorted({min(max(int(l), 0), self.cfg.num_layers - 1)
                      for l in layers
                      if isinstance(l, int) and not isinstance(l, bool)})
        return tuple(out) or (1,)

    def _zeros(self, shape, dtype=None):
        return self.torch.zeros(shape, dtype=dtype or self.torch.float32,
                                device=self.device)

    def _ids(self, *shape):
        return self._zeros(shape, self.torch.long)

    def _param_tensors(self, params=None) -> list:
        from .contracts import _tensors

        return _tensors(self.params if params is None else params)

    # -- local (single-device) serve entries ---------------------------------

    def entry_decode(self) -> List[_Entry]:
        cfg, params = self.cfg, self.params

        def build_prefill():
            from ..serve import decode as serve_decode

            ids = self._ids(BATCH, SEQ)
            return _Prepared(lambda: serve_decode._prefill_impl(
                cfg, params, ids, CAPACITY, None), self._param_tensors() + [ids])

        def build_step():
            from ..models import transformer
            from ..serve import decode as serve_decode
            from ..utils import prng

            cache = transformer.init_cache(cfg, BATCH, CAPACITY, device=self.device)
            tok = self._ids(BATCH)
            return _Prepared(
                lambda: serve_decode._step_impl(cfg, params, cache, tok, prng.key(0),
                                                0.0, None),
                self._param_tensors() + [cache.k, cache.v, tok], 2,
                [cache.k, cache.v], lambda r: [r[1].k, r[1].v])

        return [_Entry("decode.prefill", "local:prefill", build_prefill),
                _Entry("decode.step", "local:step", build_step)]

    def entry_prefill_suffix(self) -> List[_Entry]:
        cfg, params = self.cfg, self.params

        def build():
            from ..models import transformer
            from ..serve import decode as serve_decode

            cache = transformer.init_cache(cfg, BATCH, CAPACITY, device=self.device)
            suffix = self._ids(BATCH, 4)
            return _Prepared(
                lambda: serve_decode._prefill_suffix_impl(cfg, params, suffix, cache,
                                                          None),
                self._param_tensors() + [cache.k, cache.v, suffix], 2,
                [cache.k, cache.v], lambda r: [r[1].k, r[1].v])

        return [_Entry("decode.prefill_suffix", "local:prefill_suffix", build)]

    def _pool_geom(self, p: dict, notes: List[str]) -> Tuple[int, int, int,
                                                             int, str]:
        """(max_slots, pages_per_slot, page_size, num_pages, kv_codec) at
        lint scale, derived the way the CLI derives them (the
        ``kv_at_rest.pool_bytes`` -> page-count conversion included), then
        clamped."""
        b = p.get("batching", {})
        ms = int(b.get("max_slots", 4))
        pps = int(b.get("pages_per_slot", 8))
        pgs = int(b.get("page_size", 16))
        npg = int(b.get("num_pages", 65))
        kq = p.get("kv_at_rest", {})
        codec = kq.get("codec", "fp")
        if "pool_bytes" in kq:
            from ..models.paged_kv import num_pages_for_bytes

            npg = num_pages_for_bytes(self.cfg, kq["pool_bytes"], pgs,
                                      kv_codec=codec)
        if npg > MAX_TINY_PAGES:
            notes.append(f"pool clamped to {MAX_TINY_PAGES} pages at lint "
                         f"geometry (config asks for {npg})")
            npg = MAX_TINY_PAGES
        ms, pps, pgs = min(ms, 8), min(pps, 8), min(pgs, 16)
        return ms, pps, pgs, max(npg, 2), codec

    def _ragged_inputs(self, ms: int, pps: int) -> tuple:
        torch = self.torch
        return (self._zeros((ms, pps), torch.int32), self._zeros((ms,), torch.int32),
                self._ids(ms))

    def entry_batched(self, p: dict, notes: List[str]) -> List[_Entry]:
        """The batcher's ragged step: the paged decode step and the per-slot
        sampler, as ``ContinuousBatcher.step`` runs them."""
        import numpy as np

        cfg, params = self.cfg, self.params
        ms, pps, pgs, npg, codec = self._pool_geom(p, notes)
        key = f"batched:{ms}:{pps}:{pgs}:{npg}:{codec}"

        def build():
            from ..models import paged_kv
            from ..serve.batching import _batched_sample

            tab, lens, toks = self._ragged_inputs(ms, pps)
            keys = np.zeros((ms, 2), np.int64)
            steps = np.zeros((ms,), np.int64)
            temps = np.zeros((ms,), np.float32)
            if codec == "fp":
                pool = list(paged_kv.init_pool(cfg, npg, pgs, device=self.device))
                step = paged_kv.paged_decode_step
                kw: dict = {}
            else:
                pool = list(paged_kv.init_quant_pool(cfg, npg, pgs, codec,
                                                     device=self.device))
                step = paged_kv.paged_decode_step_quant
                kw = {"kv_codec": codec}

            def call():
                out = step(cfg, params, *pool, tab, lens, toks, **kw)
                return _batched_sample(out[0], keys, steps, temps), out[1:]

            return _Prepared(call, self._param_tensors() + pool + [tab, lens, toks],
                             len(pool), pool, lambda r: list(r[1]))

        name = "batched.step" if codec == "fp" else "batched.step_quant"
        return [_Entry(name, key, build)]

    # -- split runtime entries ----------------------------------------------

    def _split_notes(self, p: dict, notes: List[str]) -> None:
        """Plan-time notes about how a split config maps to lint geometry
        (the builders run behind the cache, so notes cannot come from
        them)."""
        from ..eval.split_eval import parse_hop_codec

        cuts = self.tiny_cuts(len(p["cuts"]))
        for spec in list(p["hop_codecs"])[:len(cuts)]:
            try:
                parse_hop_codec(spec, 1)
            except (ValueError, KeyError):
                notes.append(f"hop codec {spec!r} has no n_seq=1 form at "
                             f"lint geometry; run as int8_per_token")
        if p.get("n_seq", 1) > 1:
            notes.append(f"stage x seq ring (n_seq={p['n_seq']}) run as its "
                         f"n_seq=1 twin")
        if p.get("fused_hops") == "remote":
            notes.append("fused_hops 'remote' run as 'wire' (the reference's "
                         "lint lowers it so)")
        elif p.get("fused_hops") == "auto":
            notes.append("fused_hops 'auto' resolved off at lint time "
                         "(plan probes would execute)")

    def _split_runtime(self, p: dict):
        """Lint-geometry :class:`SplitRuntime` mirroring the config's plan:
        same stage count, codec family, link ladder and µ-batch schedule."""
        from ..codecs.faults import FaultConfig, LinkPolicy
        from ..eval.split_eval import parse_hop_codec
        from ..parallel.split import PipelineConfig, SplitConfig, SplitRuntime
        from .entrypoints import fused_hop_env

        cuts = self.tiny_cuts(len(p["cuts"]))
        codecs = []
        for spec in list(p["hop_codecs"])[:len(cuts)]:
            try:
                codecs.append(parse_hop_codec(spec, 1))
            except (ValueError, KeyError):
                codecs.append("int8_per_token")
        while len(codecs) < len(cuts):
            codecs.append(codecs[-1] if codecs else "int8_per_token")
        lp = p.get("link_policy")
        n_micro = 0
        if "pipeline" in p:
            n_micro = min(int(p["pipeline"].get("num_microbatches", 2)), 2)
        fused = p.get("fused_hops", "off")
        env = {"wire": "wire", "remote": "wire", "auto": "0"}.get(fused)
        with fused_hop_env(env) if env is not None else contextlib.nullcontext():
            rt = SplitRuntime(
                self.cfg, SplitConfig(cuts=cuts, hop_codecs=tuple(codecs)),
                [self.device] * (len(cuts) + 1),
                faults=(FaultConfig(**p["faults"]) if "faults" in p else None),
                policy=(LinkPolicy(**{**lp, "tiers": tuple(lp.get("tiers", ()))})
                        if lp else None),
                fec=(self._fec(p) if "fec" in p else None),
                hedge=(self._hedge(p) if "hedge" in p else None),
                pipeline=(PipelineConfig(num_microbatches=n_micro)
                          if n_micro else None))
        return rt, n_micro

    def _fec(self, p: dict):
        from ..codecs.fec import FECConfig

        return FECConfig(**p["fec"])

    def _hedge(self, p: dict):
        from ..codecs.fec import HedgeConfig

        return HedgeConfig(**p["hedge"])

    def _split_key(self, p: dict, what: str) -> str:
        sig = {k: p[k] for k in ("cuts", "hop_codecs", "faults",
                                 "link_policy", "fec", "hedge", "pipeline",
                                 "fused_hops", "n_seq", "batching",
                                 "kv_at_rest", "speculative") if k in p}
        return f"split:{what}:{json.dumps(sig, sort_keys=True)}"

    def _imps(self, rt, batch: int) -> list:
        return [self._zeros((batch, SEQ)) if c.needs_importance else None
                for c in rt.codecs]

    def entry_split_eval(self, p: dict, notes: List[str]) -> List[_Entry]:
        """experiment "split": the boundary-sweep forward."""
        def build():
            rt, n_micro = self._split_runtime(p)
            bat = max(BATCH, n_micro)
            ids = self._ids(bat, SEQ)
            placed = rt.place_params(self.params)
            imps = self._imps(rt, bat)
            return _Prepared(lambda: rt.forward(placed, ids, imps, fault_step=0),
                             self._param_tensors(placed) + [ids])

        return [_Entry("split.forward", self._split_key(p, "forward"), build)]

    def _split_cache(self, rt, batch: int) -> dict:
        cfg = self.cfg
        kv = (batch, CAPACITY, cfg.num_kv_heads, cfg.head_dim)
        return {"k": [self._zeros((b - a,) + kv) for a, b in rt.bounds],
                "v": [self._zeros((b - a,) + kv) for a, b in rt.bounds],
                "length": SEQ, "capacity": CAPACITY}

    def entry_split_decode(self, p: dict, notes: List[str],
                           speculative: bool) -> List[_Entry]:
        """Serve-path split pipeline: prefill + the in-place decode step,
        plus the k-token verify burst when the config speculates."""
        def stage_kv(c: dict) -> list:
            return list(c["k"]) + list(c["v"])

        def build_prefill():
            rt, n_micro = self._split_runtime(p)
            ids = self._ids(max(BATCH, n_micro), SEQ)
            placed = rt.place_params(self.params)
            return _Prepared(lambda: rt.prefill_decode(placed, ids, CAPACITY),
                             self._param_tensors(placed) + [ids])

        def build_step():
            rt, n_micro = self._split_runtime(p)
            bat = max(BATCH, n_micro)
            placed = rt.place_params(self.params)
            cache, tok = self._split_cache(rt, bat), self._ids(bat)
            return _Prepared(lambda: rt.decode_step(placed, cache, tok),
                             self._param_tensors(placed) + stage_kv(cache) + [tok], 2,
                             stage_kv(cache), lambda r: stage_kv(r[1]))

        entries = [_Entry("split.prefill", self._split_key(p, "prefill"), build_prefill),
                   _Entry("split.decode_step", self._split_key(p, "step"), build_step)]
        if speculative:
            def build_verify():
                rt, _ = self._split_runtime(p)
                placed = rt.place_params(self.params)
                cache, vtoks = self._split_cache(rt, BATCH), self._ids(BATCH, SPEC_K)
                return _Prepared(lambda: rt.verify_step(placed, cache, vtoks),
                                 self._param_tensors(placed) + stage_kv(cache) + [vtoks],
                                 2, stage_kv(cache), lambda r: stage_kv(r[1]))

            entries.append(_Entry("split.verify_step", self._split_key(p, "verify"),
                                  build_verify))
        return entries

    def entry_split_paged(self, p: dict, notes: List[str]) -> List[_Entry]:
        """Serve-path split pipeline behind the continuous batcher: the
        ragged paged decode step over per-stage pools."""
        ms, pps, pgs, npg, codec = self._pool_geom(p, notes)

        def build():
            rt, _ = self._split_runtime(p)
            pool = rt.init_paged_pool(npg, pgs, kv_codec=codec)
            placed = rt.place_params(self.params)
            tab, lens, toks = self._ragged_inputs(ms, pps)
            arrays = [t for name in ("k", "v", "k_scale", "v_scale")
                      for t in pool.get(name, ())]
            return _Prepared(
                lambda: rt.decode_step_paged(placed, pool, tab, lens, toks),
                self._param_tensors(placed) + arrays + [tab, lens, toks],
                2 if codec == "fp" else 4, arrays,
                lambda r: [t for name in ("k", "v", "k_scale", "v_scale")
                           for t in r[1].get(name, ())])

        return [_Entry("split.decode_step_paged",
                       self._split_key(p, f"paged:{ms}:{pps}:{pgs}:{npg}"), build)]

    # -- eval-sweep entries ---------------------------------------------------

    def entry_sweep(self, p: dict, notes: List[str]) -> List[_Entry]:
        """Token/channel/initial/last_row sweeps: the stats forward + the
        ratio-batched suffix sweep, the two calls the window-batch
        preflight sizes, at lint geometry."""
        torch = self.torch
        cfg, params = self.cfg, self.params
        layers = self.tiny_layers(p.get("layers_of_interest", (1,)))
        ratios = [r for r in p.get("ratios", []) or [0.25]]
        codec = "int4_token_select"
        key_base = f"sweep:{layers}:{len(ratios)}"

        def build_stats():
            from ..eval.harness import DEDUP_ZERO_CODECS, _stats_forward

            ids = self._ids(SWEEP_W, SWEEP_S)

            def call():  # as the sweep runs it: no autograd graph
                with torch.inference_mode():
                    return _stats_forward(cfg, params, ids, layers,
                                          want_final=codec in DEDUP_ZERO_CODECS)

            return _Prepared(call, self._param_tensors() + [ids])

        def build_suffix():
            from ..eval.harness import DEDUP_ZERO_CODECS, _suffix_sweep

            n_ratios = (max(1, sum(1 for r in ratios if float(r) != 0.0))
                        if codec in DEDUP_ZERO_CODECS else max(1, len(ratios)))
            hidden = self._zeros((SWEEP_W, SWEEP_S, cfg.hidden_size))
            targets = self._ids(SWEEP_W, SWEEP_S)
            imp = self._zeros((SWEEP_W, SWEEP_S))
            rr = torch.linspace(0.25, 0.75, n_ratios, device=self.device)
            ks = [int(float(r) * SWEEP_S) for r in rr.tolist()]

            def call():
                with torch.inference_mode():
                    return _suffix_sweep(cfg, params, min(layers), codec, SWEEP_TAIL,
                                         hidden, targets, imp, rr, ks)

            return _Prepared(call, self._param_tensors() + [hidden, targets, imp, rr])

        return [_Entry("eval.stats_forward", key_base + ":stats", build_stats),
                _Entry("eval.suffix_sweep", key_base + ":suffix", build_suffix)]

    def entry_relevance(self) -> List[_Entry]:
        cfg, params = self.cfg, self.params

        def build():
            from ..importance.relevance import chunk_relevance

            ids = self._ids(SWEEP_W, SWEEP_S)
            return _Prepared(lambda: chunk_relevance(cfg, params, ids),
                             self._param_tensors() + [ids])

        return [_Entry("eval.relevance", "relevance", build)]

    # -- the plan -------------------------------------------------------------

    def plan(self, p: dict) -> Tuple[List[_Entry], List[str]]:
        """Entry points a validated params dict would run, at lint geometry.
        Mirrors the CLI's serve/eval dispatch."""
        notes: List[str] = []
        exp = p.get("experiment", "")
        if exp == "serve":
            entries: List[_Entry] = []
            has_cuts, has_batch = "cuts" in p, "batching" in p
            spec = "speculative" in p and p["speculative"].get("enabled", True)
            if "faults" in p and not has_cuts:
                notes.append("faults/link config without cuts: the local "
                             "decode path has no boundary link to fault")
            if has_cuts:
                self._split_notes(p, notes)
            if has_cuts and has_batch:
                entries += self.entry_split_paged(p, notes)
            elif has_cuts:
                entries += self.entry_split_decode(p, notes, spec)
            elif has_batch:
                entries += self.entry_batched(p, notes)
                entries += self.entry_decode()
                if "prefix_cache" in p:
                    entries += self.entry_prefill_suffix()
            else:
                entries += self.entry_decode()
            for host_side in ("cluster", "disagg", "gray"):
                if host_side in p:
                    notes.append(f"{host_side} is host-side orchestration: "
                                 f"its replicas/workers run the entry points "
                                 f"above")
            return entries, notes
        if exp == "split":
            self._split_notes(p, notes)
            return self.entry_split_eval(p, notes), notes
        if exp == "relevance":
            return self.entry_relevance(), notes
        if exp == "distances":
            notes.append("distances sweeps run per replan candidate; no "
                         "fixed entry point to pin at lint geometry")
            return [], notes
        # "", "initial", "last_row": the token/channel sweep family
        return self.entry_sweep(p, notes), notes


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------

def _config_record(world: _Lattice, budget_world: Optional[_Lattice], p: dict,
                   findings: List[Finding], where: str,
                   budget_required: bool) -> dict:
    """Verify one config (run once + in place + budget) and build its matrix
    row, appending findings in place."""
    record: Dict[str, Any] = {
        "features": config_features(p),
        "experiment": p.get("experiment", "") or "token_sweep",
        "valid": True, "refusal": None,
        "entrypoints": {}, "donation": {}, "notes": [],
        "peak_bytes": None, "budget_bytes": None,
    }
    entries, notes = world.plan(p)
    record["notes"] = notes
    for entry in entries:
        res = world.evaluate(entry)
        if "error" in res:
            findings.append(Finding(
                layer="lattice", rule=RULE_LOWER, where=where, line=0,
                message=f"{entry.name}: failed to run at lint geometry: "
                        f"{res['error']}"))
            record["entrypoints"][entry.name] = {"error": res["error"]}
            continue
        record["entrypoints"][entry.name] = {"launches": res["launches"]}
        if res["required"]:
            record["donation"][entry.name] = {
                "donated": res["donated"], "required": res["required"]}
            if res["donated"] < res["required"]:
                findings.append(Finding(
                    layer="lattice", rule=RULE_DONATE, where=where, line=0,
                    message=f"{entry.name}: keeps {res['donated']} KV/pool "
                            f"buffer(s) in place, needs >= {res['required']}"))
    peak = None
    if budget_world is not None and entries:
        peak = 0
        for entry in budget_world.plan(p)[0]:
            res = budget_world.evaluate(entry)
            if "error" in res:
                findings.append(Finding(
                    layer="lattice", rule=RULE_LOWER, where=where, line=0,
                    message=f"{entry.name}: failed to run at the budget's "
                            f"geometry: {res['error']}"))
                continue
            if res.get("bytes") is None:
                findings.append(Finding(
                    layer="lattice", rule=RULE_LOWER, where=where, line=0,
                    message=f"{entry.name}: ran out of device memory at the "
                            f"budget's geometry"))
                continue
            record["entrypoints"].setdefault(entry.name, {}).update(res["bytes"])
            peak = max(peak, res["bytes"]["total_bytes"])
    record["peak_bytes"] = peak
    budget = p.get("budget")
    if budget is None:
        if budget_required:
            findings.append(Finding(
                layer="lattice", rule=RULE_BUDGET, where=where, line=0,
                message='missing "budget" block: every shipped config pins '
                        'its lint-geometry footprint ({"aot_peak_bytes": N})'))
    else:
        record["budget_bytes"] = budget["aot_peak_bytes"]
        if peak is not None and peak > budget["aot_peak_bytes"]:
            findings.append(Finding(
                layer="lattice", rule=RULE_BUDGET, where=where, line=0,
                message=f"measured footprint {peak} bytes (increment + "
                        f"arguments) exceeds the config's budget of "
                        f"{budget['aot_peak_bytes']} bytes at lint geometry"))
    return record


def _pair_sweep(world: _Lattice, findings: List[Finding],
                pair_oracle: Dict[Tuple[str, str], str], device) -> dict:
    """Pairwise feature-composition fuzz against :data:`PAIR_ORACLE`."""
    names = sorted(FUZZ_BLOCKS)
    combos = ([(n,) for n in names]
              + list(itertools.combinations(names, 2)))
    pairs: Dict[str, Any] = {}
    where = "lint/lattice.py:pairwise"
    for combo in combos:
        label = "+".join(combo)
        p = compose_combo(combo)
        got = _validate(p, device)
        want = pair_oracle.get(tuple(combo))
        pairs[label] = {"ok": got is None, "refusal": got}
        if got != want:
            if want is None:
                msg = (f"combo {label} should validate but the CLI refuses "
                       f"it: {got}")
            elif got is None:
                msg = (f"combo {label} should be refused ({want!r}) but "
                       f"the CLI accepts it")
            else:
                msg = (f"combo {label} is refused with a different message "
                       f"than the oracle pins: got {got!r}, want {want!r}")
            findings.append(Finding(layer="lattice", rule=RULE_COMPAT,
                                    where=where, line=0, message=msg))
            continue
        if got is not None:
            continue
        # accepted combos must also BUILD and RUN: the builder half of
        # validator/builder drift
        entries, _ = world.plan(p)
        for entry in entries:
            res = world.evaluate(entry)
            if "error" in res:
                findings.append(Finding(
                    layer="lattice", rule=RULE_COMPAT, where=where, line=0,
                    message=f"combo {label} validates but {entry.name} "
                            f"refuses to build/run: {res['error']}"))
                pairs[label]["ok"] = False
                pairs[label]["build_error"] = res["error"]
                break
    return pairs


def run_lattice_checks(
        configs_dir: Optional[Path] = None,
        pair_oracle: Optional[Dict[Tuple[str, str], str]] = None,
        budget_required: bool = True,
        pairwise: bool = True,
        device: str = "cuda",
        peak_reader: Optional[Callable] = None,
) -> Tuple[List[Finding], List[str], List[str], dict]:
    """Run the whole lattice sweep on ``device``.

    Returns ``(findings, checked, skipped, capability_matrix)``: the first
    three in the shape the other layers use, the fourth the
    :data:`MATRIX_SCHEMA` document for ``capability_matrix.json``.

    ``peak_reader(call) -> bytes`` reads one call's bytes above what was
    resident; the card's default is
    :func:`~..analysis.aot.cuda_increment_bytes`, and a CPU run without one
    measures no footprint (a skip note). ``configs_dir`` / ``pair_oracle``
    / ``budget_required`` / ``peak_reader`` exist for the seeded-fixture
    tests; production callers take the defaults.
    """
    import torch

    from ..analysis.aot import cuda_increment_bytes
    from .entrypoints import CPU_GEOMETRY, check_device, lint_geometry

    check_device(device)
    dev = torch.device(device)
    configs_dir = Path(configs_dir) if configs_dir else default_configs_dir()
    pair_oracle = PAIR_ORACLE if pair_oracle is None else pair_oracle
    findings: List[Finding] = []
    checked: List[str] = []
    skipped: List[str] = []

    if peak_reader is None and dev.type == "cuda":
        peak_reader = lambda call: cuda_increment_bytes(call, dev)  # noqa: E731
    world = _Lattice(dev, lint_geometry(dev))
    budget_world = None
    if peak_reader is not None:
        budget_world = (_Lattice(dev, CPU_GEOMETRY, peak_reader)
                        if world.geometry != CPU_GEOMETRY else world)
        world.peak_reader = peak_reader if budget_world is world else None
    else:
        skipped.append(f"lattice budget: the footprint is measured on the card "
                       f"(the {dev.type} has no device allocator to read)")

    readme = readme_parity_findings(configs_dir)
    findings.extend(readme)
    if not readme:
        checked.append("lattice.readme-parity")

    g = world.cfg
    matrix: Dict[str, Any] = {
        "schema": MATRIX_SCHEMA,
        "device": dev.type,
        "tiny_geometry": {
            "model": "qwen2-tiny", "num_layers": g.num_layers,
            "hidden_size": g.hidden_size, "num_heads": g.num_heads,
            "num_kv_heads": g.num_kv_heads, "vocab_size": g.vocab_size,
            "batch": BATCH, "seq": SEQ, "capacity": CAPACITY,
            "sweep_window": [SWEEP_W, SWEEP_S],
        },
        "budget_geometry": (dict(CPU_GEOMETRY) if budget_world is not None
                            else None),
        "configs": {}, "pairs": {},
    }

    for path in sorted(configs_dir.glob("*.json")):
        where = str(path)
        try:
            p = json.loads(path.read_text(encoding="utf-8"))
        except (OSError, ValueError) as e:
            findings.append(Finding(
                layer="lattice", rule=RULE_VALIDATE, where=where, line=0,
                message=f"unreadable config: {e}"))
            continue
        refusal = _validate(p, dev.type)
        if refusal is not None:
            findings.append(Finding(
                layer="lattice", rule=RULE_VALIDATE, where=where, line=0,
                message=f"the CLI refuses this config: {refusal}"))
            matrix["configs"][path.stem] = {
                "features": config_features(p), "valid": False,
                "refusal": refusal, "entrypoints": {}, "donation": {},
                "notes": [], "peak_bytes": None, "budget_bytes": None,
                "experiment": p.get("experiment", "") or "token_sweep",
            }
            continue
        before = len(findings)
        matrix["configs"][path.stem] = _config_record(
            world, budget_world, p, findings, where, budget_required)
        if len(findings) == before:
            checked.append(f"lattice.config:{path.stem}")

    if pairwise:
        before = len(findings)
        matrix["pairs"] = _pair_sweep(world, findings, pair_oracle, dev.type)
        if len(findings) == before:
            checked.append("lattice.pairwise-compat")

    return findings, checked, skipped, matrix


def write_matrix(matrix: dict, path: str) -> None:
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(matrix, f, indent=1, sort_keys=True)
        f.write("\n")
