"""CLI sweep driver of the PyTorch port, compatible with the reference's
``params.json`` convention (the same keys as ``python -m edgellm_tpu.run``):

    python -m edgellm_tpu_torch.run --params params.json --model qwen2-0.5b \\
        [--corpus corpus.npy] [--weights ckpt.safetensors] [--head-weights hw.json] \\
        [--output-dir out] [--device cuda]

Dispatch mirrors the reference:
- ``experiment: "initial"``   -> Pythia initial sweep (affine-int8 rank / top-rho)
- ``experiment: "last_row"``  -> token-selective int4 sweep
- methods containing "channel" -> per-channel codec sweep
- ``experiment: "split"``     -> the real split eval (``run_split_eval``): the
  model cut at ``cuts``, each cut crossed as a packed ``hop_codecs`` payload;
  with ``faults`` (and ``link_policy``, ``fec``, ``hedge``, ``link_health``)
  over the faulty link, whose counters, tier trail and recovery counters
  ``--fault-report`` prints; ``deadline`` (or ``--deadline-s``) arms the
  per-chunk watchdog, ``stage_failure`` kills a stage at a chunk and
  ``recovery`` tunes the re-plan onto the survivors
- ``experiment: "relevance"`` -> LRP head-relevance extraction
  (``attention_head_weights.json``, the ``--head-weights`` input of
  ``weighted_importance``)
- ``experiment: "distances"`` -> the layer-pair JS-divergence matrix
  (``layer_distances.json``) and its heatmap where matplotlib imports
- otherwise                   -> the Qwen-style token sweep

- ``experiment: "serve"`` with a ``batching`` block -> the continuous batcher
  behind the serving front (``prefix_cache`` and ``kv_at_rest`` too): seeded
  arrivals on a fake clock, ``serve_report.json`` and one JSON line; with
  ``cuts`` / ``hop_codecs`` beside it the batcher's ragged step runs through
  a ``SplitRuntime`` (the split-paged batcher, mode "batched_split"); with
  ``disagg`` the front drains a ``DisaggServer`` (prefill workers, verified
  KV-page migration, a decode pool: mode "disagg_batched" or
  "disagg_batched_split", ``disagg_migrations`` / ``disagg_degraded`` on
  the line)
- ``experiment: "serve"`` with ``batching`` and a ``cluster`` block -> the
  replica router (``ClusterFront``): ``num_replicas`` serve fronts, each
  over its own batcher (split-paged with ``cuts``, a ``DisaggServer`` with
  ``disagg``), prefix-affine placement, the same seeded arrivals,
  ``cluster_report.json`` and one JSON line (mode "cluster_batched",
  "cluster_batched_split" or their "disagg_" forms); ``gray`` arms the
  router's straggler demotion and hedging. The replicas share the card
  and drain in turn
- ``experiment: "serve"`` without ``batching`` -> the front's per-request
  route through ``run_soak``: with ``cuts`` / ``hop_codecs`` every request
  on a ``SplitRuntime`` (``generate_split``; ``speculative``: the draft /
  verify burst loop), else on the single-device ``generate``; the identity
  audit, ``serve_report.json`` and one JSON line; ``serving.soak.kill_stage``
  kills a stage mid-soak (the front re-plans onto the survivors)

Under ``serve`` the link keys build the runtime's faulty link (both
routes; ``link_health`` a tracker on the soak's clock for the per-request
route), and ``serving.checkpoint_dir`` / ``step_deadline_s`` (per request)
and ``batching.checkpoint_dir`` (per evicted stream) arm the checkpoints.
``--serve-report`` prints the front's report after the JSON line.

``pipeline`` (``{"num_microbatches": M}``) runs the split and serve
runtimes' µ-batch schedule (split12), with the reference's checks.

Observability: ``--metrics-out PATH`` (Prometheus text for ``.prom`` /
``.txt``, JSON otherwise), ``--trace-out PATH`` (Chrome trace-event JSON),
``--trace-report`` (per-request span trees after the run) and ``--profile
DIR`` (a torch.profiler Chrome trace of the run; the spans appear in any
``torch.profiler`` capture as CPU ranges on the capture's clock) arm the
``obs`` package; a params.json
``observability`` block picks the pillars, ``flight_recorder: true`` writes
post-mortem artifacts under ``<output-dir>/flight_recorder`` and
``obs_port`` (or ``--obs-port PORT``, 0 for any free port) serves the live
endpoint on 127.0.0.1 for the run (its URL printed, ``/healthz`` the serve
front's health).

``n_seq`` (split5, split5b) runs the split's stage x seq runtime: the
sequence ring-sharded within every stage, the shards in turn on the one
device. ``n_data`` / ``n_model`` add the data and model mesh axes (the
window batch cut into data groups, each stage in tensor-parallel shards;
on one card the groups and shards run in turn). ``--distributed`` joins a
``torch.distributed`` process group first (gloo; ``env://`` rendezvous, one
process without one) and the split's mesh spreads its data axis over the
processes. On the card a token sweep with ``--window-batch`` above 1 first
shrinks the batch to what the memory preflight says fits
(``tools/wb_preflight.py``). ``fused_hops`` maps onto the ``EDGELLM_FUSED_HOP``
gate as in the reference ("auto" fuses a hop only where this card's probe cache
recorded a win, ``codecs/probe_cache.py``).

``--lint`` runs the port's graphlint gate instead of an experiment (``python
-m edgellm_tpu_torch.lint --no-mypy``, on the card unless ``--device cpu``)
and exits with its code.

Corpus input is a ``.npy``/``.npz`` of token ids, or a raw ``.txt`` plus
``--tokenizer`` (a local HF tokenizer path). Weights: ``--weights`` (a
``.safetensors`` file or directory, a state_dict ``.pt``, or an HF directory),
else random fp32 init from ``--seed`` (smoke/benchmark mode). Runs on the
card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import Optional

import numpy as np
import torch

#: experiments of the reference CLI that this package has not ported yet
NOT_PORTED = ()
#: the faulty link's keys
LINK_KEYS = ("faults", "link_policy", "fec", "hedge", "link_health")
#: the fused_hops key's values onto the EDGELLM_FUSED_HOP gate ("auto" clears it)
FUSED_HOP_ENV = {"off": "0", "wire": "wire", "remote": "remote"}


def _load_corpus(args, vocab_size: int) -> np.ndarray:
    if args.corpus is None:
        rng = np.random.default_rng(args.seed)
        return rng.integers(0, vocab_size, args.synthetic_corpus_len)
    if args.corpus.endswith((".npy", ".npz")):
        data = np.load(args.corpus)
        if hasattr(data, "files"):
            data = data[data.files[0]]
        return np.asarray(data).reshape(-1)
    # raw text: documents already joined with "\n\n" (Qwen2-0.5B/main.py:122-124)
    if args.tokenizer is None:
        raise SystemExit("--tokenizer is required for raw-text corpora")
    from transformers import AutoTokenizer

    tok = AutoTokenizer.from_pretrained(args.tokenizer)
    with open(args.corpus) as f:
        text = f.read()
    return np.asarray(tok(text, return_tensors="np").input_ids).reshape(-1)


def _load_model(args, device):
    from .models import (PORT_PRESETS, PRESETS, config_from_hf, init_params,
                         params_from_state_dict)

    if args.weights:
        from .models.safetensors_io import load_checkpoint

        if args.weights.endswith(".safetensors"):
            if args.model not in PRESETS:
                raise SystemExit(f"--model must be one of {sorted(PRESETS)} with a "
                                 f"bare .safetensors file")
            return load_checkpoint(args.weights, PRESETS[args.model], device=device)
        if os.path.isdir(args.weights) and any(
                f.endswith(".safetensors") for f in os.listdir(args.weights)):
            return load_checkpoint(args.weights, device=device)
        if os.path.isdir(args.weights):
            from transformers import AutoConfig, AutoModelForCausalLM

            cfg = config_from_hf(AutoConfig.from_pretrained(args.weights))
            sd = AutoModelForCausalLM.from_pretrained(args.weights).state_dict()
        else:
            if args.model not in PRESETS:
                raise SystemExit(f"--model must be one of {sorted(PRESETS)} with --weights file")
            cfg = PRESETS[args.model]
            sd = torch.load(args.weights, map_location="cpu")
        return cfg, params_from_state_dict(cfg, sd, device=device)
    cfg = {**PRESETS, **PORT_PRESETS}[args.model]
    gen = torch.Generator(device=device).manual_seed(args.seed)
    return cfg, init_params(cfg, gen, device=device)


#: every key any experiment of the reference CLI reads, with its consumers —
#: unknown keys fail fast instead of being silently ignored
_PARAM_KEYS = {
    "experiment": "all",
    "max_length": "all", "stride": "all",
    "methods": "token/channel sweeps",
    "layers_of_interest": "initial/token/channel sweeps",
    "ratios": "initial/token sweeps",
    "cuts": "split/serve", "hop_codecs": "split/serve",
    "fused_hops": "split/serve",
    "importance_method": "split",
    "n_seq": "split", "n_data": "split", "n_model": "split",
    "faults": "split/serve", "link_policy": "split/serve",
    "fec": "split/serve", "hedge": "split/serve",
    "link_health": "split/serve",
    "deadline": "split", "stage_failure": "split", "recovery": "split",
    "pipeline": "split/serve",
    "serving": "serve",
    "batching": "serve",
    "prefix_cache": "serve",
    "kv_at_rest": "serve",
    "speculative": "serve",
    "cluster": "serve",
    "disagg": "serve",
    "gray": "serve",
    "max_compiles": "distances",
    "observability": "all",
    "budget": "all (latticelint AOT peak)",
}
_EXPERIMENTS = ("", "initial", "last_row", "relevance", "split", "distances",
                "serve")
_REQUIRED = {"split": ("cuts", "hop_codecs"),
             "serve": ("serving",),
             "initial": ("layers_of_interest", "ratios")}
#: params blocks that belong to one experiment of the reference CLI, with the
#: reference's message when they appear elsewhere
_ONLY_FOR = (
    ("prefix_cache", "prefix_cache only applies to experiment 'serve'"),
    ("kv_at_rest", "kv_at_rest only applies to experiment 'serve'"),
    ("pipeline", "pipeline only applies to experiments 'split' and 'serve'"),
    ("speculative", "speculative only applies to experiment 'serve'"),
    ("cluster", "cluster only applies to experiment 'serve'"),
    ("disagg", "disagg only applies to experiment 'serve'"),
    ("gray", "gray only applies to experiment 'serve'"),
)


def _validate_params_json(p: dict, device="cuda") -> None:
    """Fail fast — naming the offending key — before any device work starts,
    with the reference CLI's messages for every check a sweep reaches.
    ``device`` is the one the run will use: the hop codecs resolve to its
    implementations (on CUDA the kernel twins)."""
    def die(msg):
        raise SystemExit(f"params.json: {msg}")

    if not isinstance(p, dict):
        die(f"expected a JSON object, got {type(p).__name__}")
    unknown = sorted(set(p) - set(_PARAM_KEYS))
    if unknown:
        die(f"unknown key(s) {unknown}; known keys: {sorted(_PARAM_KEYS)}")
    exp = p.get("experiment", "")
    if exp not in _EXPERIMENTS:
        die(f"unknown experiment {exp!r}; options: {list(_EXPERIMENTS)}")
    if exp in NOT_PORTED:
        die(f"experiment {exp!r} is not ported yet to edgellm_tpu_torch; "
            f"run it with python -m edgellm_tpu.run")
    if "observability" in p:
        from .obs import ObservabilityConfig

        ob = p["observability"]
        if not isinstance(ob, dict):
            die(f"observability must be an object of ObservabilityConfig "
                f"fields, got {ob!r}")
        fields = {f.name for f in dataclasses.fields(ObservabilityConfig)}
        bad = sorted(set(ob) - fields)
        if bad:
            die(f"observability: unknown field(s) {bad}; "
                f"known: {sorted(fields)}")
        try:
            ObservabilityConfig(**ob)
        except (TypeError, ValueError) as e:
            die(f"observability: {e}")
    if "budget" in p:
        b = p["budget"]
        if not isinstance(b, dict):
            die(f"budget must be an object with 'aot_peak_bytes' (and an "
                f"optional 'note'), got {b!r}")
        bad = sorted(set(b) - {"aot_peak_bytes", "note"})
        if bad:
            die(f"budget: unknown field(s) {bad}; "
                f"known: ['aot_peak_bytes', 'note']")
        if "aot_peak_bytes" not in b:
            die("budget needs 'aot_peak_bytes' (the latticelint AOT ceiling)")
        if (not isinstance(b["aot_peak_bytes"], int)
                or isinstance(b["aot_peak_bytes"], bool)
                or b["aot_peak_bytes"] < 1):
            die(f"budget.aot_peak_bytes must be a positive integer, "
                f"got {b['aot_peak_bytes']!r}")
        if "note" in b and not isinstance(b["note"], str):
            die(f"budget.note must be a string, got {b['note']!r}")
    if exp not in ("split", "serve") and (
            "faults" in p or "link_policy" in p or "fec" in p
            or "hedge" in p or "link_health" in p):
        die("faults/link_policy/fec/hedge/link_health only apply to "
            "experiments 'split' and 'serve'")
    if exp != "split" and ("deadline" in p or "stage_failure" in p
                           or "recovery" in p):
        die("deadline/stage_failure/recovery only apply to experiment 'split'")
    if exp != "serve" and "serving" in p:
        die("serving only applies to experiment 'serve'")
    if exp != "serve" and "batching" in p:
        die("batching only applies to experiment 'serve'")
    for k in _REQUIRED.get(exp, ()):
        if k not in p:
            die(f"experiment {exp!r} requires key {k!r}")
    if exp not in ("split", "serve", "initial", "relevance", "distances"):
        # token/channel sweeps sweep layers (x ratios for the token sweep)
        methods = p.get("methods", [])
        need = ["layers_of_interest"]
        if not (methods and isinstance(methods[0], str)
                and "channel" in methods[0]):
            need.append("ratios")
        for k in need:
            if k not in p:
                die(f"experiment {exp or '(token sweep)'!r} requires key {k!r}")
    for k in ("max_length", "stride", "n_seq", "n_data", "n_model",
              "max_compiles"):
        if k in p and (not isinstance(p[k], int) or isinstance(p[k], bool)
                       or p[k] < 1):
            die(f"{k} must be a positive integer, got {p[k]!r}")
    for k in ("methods", "layers_of_interest", "ratios", "cuts", "hop_codecs"):
        if k in p and not isinstance(p[k], list):
            die(f"{k} must be a list, got {type(p[k]).__name__}")
    if exp == "serve" and ("cuts" in p) != ("hop_codecs" in p):
        die("serve: cuts and hop_codecs go together")
    if "fused_hops" in p:
        if exp not in ("split", "serve"):
            die("fused_hops only applies to experiments 'split' and 'serve'")
        if "cuts" not in p:
            die("fused_hops needs a pipeline to fuse — add 'cuts'/'hop_codecs'")
        fh = p["fused_hops"]
        if fh not in ("auto", "off", "wire", "remote"):
            die(f"fused_hops must be one of ['auto', 'off', 'wire', "
                f"'remote'], got {fh!r}")
        if fh != "off" and any(("faults" in p, "fec" in p, "hedge" in p)):
            # an active faulty link owns the hop: fusion is refused there
            die("fused_hops: an active faults/fec/hedge link owns the hop "
                "protocol — fusion is refused at runtime; set fused_hops: "
                "'off' or drop the link config")
    if exp == "split":
        _validate_split(p, die, device)
    if exp == "serve":
        _validate_serve(p, die, device)
        return
    for key, msg in _ONLY_FOR:
        if key in p and not (key == "pipeline" and exp == "split"):
            die(msg)


def _validate_split(p: dict, die, device) -> None:
    """The split branch: ``n_seq`` combined with ``n_data`` / ``n_model``
    exits with the reference's message (its run time check), then the
    reference's checks of ``cuts``, ``hop_codecs`` and
    ``importance_method``, the codecs' resolution on ``device``, then the
    link keys."""
    if p.get("n_seq", 1) > 1 and (p.get("n_data", 1) > 1 or p.get("n_model", 1) > 1):
        raise SystemExit("n_seq composes the pipeline with sequence sharding only; "
                         "combining it with n_data/n_model is not supported")
    _validate_cuts(p, die, device)
    _validate_link(p, die)
    _validate_recovery(p, die)
    _validate_pipeline(p, die)


def _validate_pipeline(p: dict, die) -> None:
    """The reference's checks of the ``pipeline`` block under ``split`` and
    ``serve``, with its messages."""
    if "pipeline" not in p:
        return
    from .parallel.split import PipelineConfig

    if "cuts" not in p:
        die("pipeline schedules micro-batches across the split boundary "
            "— add 'cuts'/'hop_codecs'")
    pl = p["pipeline"]
    if not isinstance(pl, dict):
        die(f"pipeline must be an object of PipelineConfig fields, got {pl!r}")
    fields = {f.name for f in dataclasses.fields(PipelineConfig)}
    bad = sorted(set(pl) - fields)
    if bad:
        die(f"pipeline: unknown field(s) {bad}; known: {sorted(fields)}")
    try:
        pc = PipelineConfig(**pl)
    except (TypeError, ValueError) as e:
        die(f"pipeline: {e}")
    if pc.enabled and p.get("n_seq", 1) > 1:
        die("pipeline needs the plain split runtime (n_seq == 1); the "
            "stage x seq runtime overlaps hops with its ring rotation")
    if pc.enabled and "batching" in p:
        ms = p["batching"].get("max_slots", 4)
        if ms % pc.num_microbatches:
            die(f"batching.max_slots {ms} must be a multiple of "
                f"pipeline.num_microbatches {pc.num_microbatches}")
    if pc.enabled and "speculative" in p:
        if p["speculative"].get("enabled", True):
            die("pipeline + speculative: the spec loop verifies one "
                "stream at a time (B == 1), leaving nothing to "
                "micro-batch — drop one of the two blocks")
    if pc.enabled and p.get("kv_at_rest", {}).get("codec", "fp") != "fp":
        # the µ-batch step has no quantized twin
        die("kv_at_rest + pipeline: quantized paged decode composes "
            "with the unpipelined split runtime only — drop 'pipeline' "
            "or use codec 'fp'")


def _validate_recovery(p: dict, die) -> None:
    """The reference's checks of ``deadline``, ``stage_failure`` and
    ``recovery``, with its messages."""
    if "deadline" in p:
        d = p["deadline"]
        if isinstance(d, bool) or not isinstance(d, (int, float)) or d <= 0:
            die(f"deadline must be a positive number of seconds, got {d!r}")
    if "stage_failure" in p:
        from .serve.recovery import StageFailure

        sf = p["stage_failure"]
        if not isinstance(sf, dict):
            die(f"stage_failure must be an object of StageFailure fields, got {sf!r}")
        fields = {f.name for f in dataclasses.fields(StageFailure)}
        bad = sorted(set(sf) - fields)
        if bad:
            die(f"stage_failure: unknown field(s) {bad}; known: {sorted(fields)}")
        try:
            obj = StageFailure(**sf)
        except (TypeError, ValueError) as e:
            die(f"stage_failure: {e}")
        if obj.stage > len(p["cuts"]):
            die(f"stage_failure.stage {obj.stage} out of range for "
                f"{len(p['cuts']) + 1} pipeline stage(s)")
        if p.get("n_seq", 1) > 1:
            die("stage_failure needs the plain split runtime (n_seq == 1)")
    if "recovery" in p:
        r = p["recovery"]
        if not isinstance(r, dict):
            die(f"recovery must be an object, got {r!r}")
        bad = sorted(set(r) - {"replan", "max_failovers"})
        if bad:
            die(f"recovery: unknown field(s) {bad}; known: ['max_failovers', 'replan']")
        if "replan" in r and not isinstance(r["replan"], bool):
            die(f"recovery.replan must be a boolean, got {r['replan']!r}")
        mf = r.get("max_failovers", 1)
        if isinstance(mf, bool) or not isinstance(mf, int) or mf < 1:
            die(f"recovery.max_failovers must be a positive integer, got {mf!r}")


def _validate_link(p: dict, die) -> None:
    """The reference's checks of the link keys, with its messages: each an
    object of its config's fields that constructs, the ladder's tiers
    registry codecs, and ``fec`` / ``hedge`` / ``link_health`` only beside
    an enabled ``faults``."""
    from .codecs.faults import FaultConfig, LinkPolicy
    from .codecs.fec import FECConfig, HedgeConfig, LinkHealthConfig
    from .codecs.packing import get_wire_codec

    for key, cls in (("faults", FaultConfig), ("link_policy", LinkPolicy), ("fec", FECConfig),
                     ("hedge", HedgeConfig), ("link_health", LinkHealthConfig)):
        if key not in p:
            continue
        if not isinstance(p[key], dict):
            die(f"{key} must be an object of {cls.__name__} fields, got {p[key]!r}")
        fields = {f.name for f in dataclasses.fields(cls)}
        bad = sorted(set(p[key]) - fields)
        if bad:
            die(f"{key}: unknown field(s) {bad}; known: {sorted(fields)}")
        try:
            obj = cls(**{**p[key], "tiers": tuple(p[key].get("tiers", ()))}
                      if key == "link_policy" else p[key])
        except (TypeError, ValueError) as e:
            die(f"{key}: {e}")
        if key == "link_policy":
            for t in obj.tiers:
                try:
                    get_wire_codec(t)
                except ValueError as e:
                    die(f"link_policy.tiers: {e}")
        if key in ("fec", "hedge", "link_health") and (
                "faults" not in p or not FaultConfig(**p["faults"]).enabled):
            die(f"{key} requires an enabled 'faults' config (the link "
                f"machinery only exists in the graph when a fault can "
                f"fire)")


def _validate_cuts(p: dict, die, device) -> None:
    """The reference's checks of ``cuts`` and ``hop_codecs`` (split and
    serve), then the codecs' resolution on ``device``."""
    if not p["cuts"] or not all(isinstance(c, int) and not isinstance(c, bool)
                                and c >= 0 for c in p["cuts"]):
        die(f"cuts must be a non-empty list of layer indices, got {p['cuts']!r}")
    if len(p["hop_codecs"]) != len(p["cuts"]):
        die(f"hop_codecs has {len(p['hop_codecs'])} entries for "
            f"{len(p['cuts'])} cut(s)")
    from .codecs.packing import get_wire_codec
    from .eval.split_eval import parse_hop_codec
    from .importance.metrics import ATTENTION_METHODS
    from .parallel.split import apply_default_codec_backend

    resolved_codecs = []
    for spec in p["hop_codecs"]:
        if not isinstance(spec, str):
            die(f"hop_codecs entries must be codec spec strings, got {spec!r}")
        try:
            resolved = parse_hop_codec(spec, p.get("n_seq", 1))
            if isinstance(resolved, str):
                resolved = get_wire_codec(resolved)
        except (ValueError, KeyError) as e:
            die(f"bad hop codec {spec!r}: {e}")
        resolved_codecs.append(resolved)
    method = p.get("importance_method")
    if method is not None and method not in ATTENTION_METHODS:
        die(f"importance_method must be one of {list(ATTENTION_METHODS)}, "
            f"got {method!r}")
    try:
        apply_default_codec_backend(resolved_codecs, device)
    except ValueError as e:
        die(f"hop_codecs on {device}: {e}")


def _validate_serve(p: dict, die, device) -> None:
    """The serve branch: the reference's checks of ``cuts``, the
    ``serving``, ``batching``, ``prefix_cache``, ``kv_at_rest``,
    ``pipeline``, ``speculative``, ``cluster``, ``disagg`` and ``gray``
    blocks, in its order, with its messages."""
    if "cuts" in p:
        _validate_cuts(p, die, device)
    _validate_link(p, die)
    from .serve.batching import BatchingConfig
    from .serve.frontend import ServeFrontConfig
    from .serve.overload import (AdmissionConfig, BreakerConfig, BrownoutConfig,
                                 RetryBudgetConfig)
    from .serve.soak import SoakConfig

    sv = p["serving"]
    if not isinstance(sv, dict):
        die(f"serving must be an object of ServeFrontConfig fields "
            f"(plus 'soak'), got {sv!r}")
    top = {f.name for f in dataclasses.fields(ServeFrontConfig)} | {"soak"}
    bad = sorted(set(sv) - top)
    if bad:
        die(f"serving: unknown field(s) {bad}; known: {sorted(top)}")
    for key, cls in (("admission", AdmissionConfig), ("breaker", BreakerConfig),
                     ("brownout", BrownoutConfig), ("retry_budget", RetryBudgetConfig),
                     ("soak", SoakConfig)):
        if key not in sv:
            continue
        if not isinstance(sv[key], dict):
            die(f"serving.{key} must be an object of {cls.__name__} "
                f"fields, got {sv[key]!r}")
        fields = {f.name for f in dataclasses.fields(cls)}
        bad = sorted(set(sv[key]) - fields)
        if bad:
            die(f"serving.{key}: unknown field(s) {bad}; known: {sorted(fields)}")
        try:
            cls(**sv[key])
        except (TypeError, ValueError) as e:
            die(f"serving.{key}: {e}")
    try:
        _serve_front_config(sv)
    except (TypeError, ValueError) as e:
        die(f"serving: {e}")
    ks = (sv.get("soak") or {}).get("kill_stage")
    if ks is not None and "cuts" in p and ks > len(p["cuts"]):
        die(f"serving.soak.kill_stage {ks} out of range for "
            f"{len(p['cuts']) + 1} pipeline stage(s)")
    if "batching" not in p:
        for key, msg in (
                ("prefix_cache", "prefix_cache rides the continuous batcher's paged pool — "
                                 "add a 'batching' block"),
                ("kv_at_rest", "kv_at_rest compresses the continuous batcher's paged pool "
                               "— add a 'batching' block")):
            if key in p:
                die(msg)
        _validate_serve_blocks(p, die)
        return
    b = p["batching"]
    if not isinstance(b, dict):
        die(f"batching must be an object of BatchingConfig fields, got {b!r}")
    # dtype fields are runtime objects, not JSON; prefix_cache and kv_codec
    # have their own top-level blocks
    fields = {f.name for f in dataclasses.fields(BatchingConfig)} \
        - {"compute_dtype", "cache_dtype", "prefix_cache", "kv_codec"}
    bad = sorted(set(b) - fields)
    if bad:
        die(f"batching: unknown field(s) {bad}; known: {sorted(fields)}")
    try:
        bcfg = BatchingConfig(**b)
    except (TypeError, ValueError) as e:
        die(f"batching: {e}")
    sk = sv.get("soak") or {}
    need = sk.get("prompt_len", 8) + sk.get("max_new_tokens", 8) - 1
    if need > bcfg.span:
        die(f"batching: soak requests need {need} cache positions > slot "
            f"span {bcfg.span} (pages_per_slot x page_size)")
    if "prefix_cache" in p:
        from .models.paged_kv import PrefixCacheConfig

        pc = p["prefix_cache"]
        if not isinstance(pc, dict):
            die(f"prefix_cache must be an object of PrefixCacheConfig "
                f"fields, got {pc!r}")
        fields = {f.name for f in dataclasses.fields(PrefixCacheConfig)}
        bad = sorted(set(pc) - fields)
        if bad:
            die(f"prefix_cache: unknown field(s) {bad}; known: {sorted(fields)}")
        if "enabled" in pc and not isinstance(pc["enabled"], bool):
            die(f"prefix_cache.enabled must be a boolean, got {pc['enabled']!r}")
        for k in ("min_shared_block", "max_index_pages"):
            if k in pc and (not isinstance(pc[k], int) or isinstance(pc[k], bool)
                            or pc[k] < 0):
                die(f"prefix_cache.{k} must be a non-negative integer, got {pc[k]!r}")
        try:
            PrefixCacheConfig(**pc)
        except (TypeError, ValueError) as e:
            die(f"prefix_cache: {e}")
    if "kv_at_rest" in p:
        from .models.paged_kv import KV_PAGE_CODECS, resolve_kv_codec

        kq = p["kv_at_rest"]
        if not isinstance(kq, dict):
            die(f"kv_at_rest must be an object with a 'codec' tier (and "
                f"optional 'pool_bytes'), got {kq!r}")
        bad = sorted(set(kq) - {"codec", "pool_bytes"})
        if bad:
            die(f"kv_at_rest: unknown field(s) {bad}; known: ['codec', 'pool_bytes']")
        if "codec" not in kq:
            die(f"kv_at_rest needs a 'codec' tier name; options: {sorted(KV_PAGE_CODECS)}")
        try:
            resolve_kv_codec(kq["codec"])
        except (TypeError, ValueError) as e:
            die(f"kv_at_rest: {e}")
        if "pool_bytes" in kq and (not isinstance(kq["pool_bytes"], int)
                                   or isinstance(kq["pool_bytes"], bool)
                                   or kq["pool_bytes"] < 1):
            die(f"kv_at_rest.pool_bytes must be a positive integer, got {kq['pool_bytes']!r}")
    _validate_serve_blocks(p, die)


def _validate_serve_blocks(p: dict, die) -> None:
    """The serve blocks the reference checks after ``kv_at_rest``, in its
    order."""
    _validate_pipeline(p, die)
    _validate_speculative(p, die)
    _validate_cluster(p, die)
    _validate_disagg(p, die)
    _validate_gray(p, die)


def _validate_cluster(p: dict, die) -> None:
    """The reference's checks of the ``cluster`` block (experiment "serve")."""
    if "cluster" not in p:
        return
    from .serve.cluster import AutoscalerConfig, ClusterConfig, RespawnConfig
    from .serve.overload import BreakerConfig, RetryBudgetConfig

    if "batching" not in p:
        die("cluster replicas each run the continuous batcher — add a "
            "'batching' block")
    if "speculative" in p:
        die("cluster + speculative: the spec loop is single-stream with "
            "no replica routing story — drop one of the two blocks")
    cl = p["cluster"]
    if not isinstance(cl, dict):
        die(f"cluster must be an object of ClusterConfig fields, got {cl!r}")
    top = {f.name for f in dataclasses.fields(ClusterConfig)}
    bad = sorted(set(cl) - top)
    if bad:
        die(f"cluster: unknown field(s) {bad}; known: {sorted(top)}")
    for key, cls in (("breaker", BreakerConfig), ("retry_budget", RetryBudgetConfig),
                     ("respawn", RespawnConfig), ("autoscaler", AutoscalerConfig)):
        if key not in cl:
            continue
        if not isinstance(cl[key], dict):
            die(f"cluster.{key} must be an object of {cls.__name__} fields, got {cl[key]!r}")
        fields = {f.name for f in dataclasses.fields(cls)}
        bad = sorted(set(cl[key]) - fields)
        if bad:
            die(f"cluster.{key}: unknown field(s) {bad}; known: {sorted(fields)}")
    try:
        ccfg = _cluster_config(cl)
    except (TypeError, ValueError) as e:
        die(f"cluster: {e}")
    if ccfg.num_replicas < 2:
        die(f"cluster.num_replicas must be >= 2 (a one-replica cluster "
            f"is the plain serve front — drop the 'cluster' block), "
            f"got {ccfg.num_replicas}")
    if (p.get("serving", {}).get("soak") or {}).get("kill_stage") is not None:
        die("cluster + serving.soak.kill_stage: the stage kill is the "
            "single-front chaos hook — replica kills belong to the "
            "router (ClusterFront.kill_replica, exercised by the "
            "cluster tests/bench)")


def _validate_gray(p: dict, die) -> None:
    """The reference's checks of the ``gray`` block (experiment "serve")."""
    if "gray" not in p:
        return
    from .serve.cluster import GrayConfig

    if "cluster" not in p:
        die("gray hardening (straggler demotion, request hedging) is a "
            "router policy — add a 'cluster' block")
    gy = p["gray"]
    if not isinstance(gy, dict):
        die(f"gray must be an object of GrayConfig fields, got {gy!r}")
    top = {f.name for f in dataclasses.fields(GrayConfig)}
    bad = sorted(set(gy) - top)
    if bad:
        die(f"gray: unknown field(s) {bad}; known: {sorted(top)}")
    try:
        _gray_config(gy)
    except (TypeError, ValueError) as e:
        die(f"gray: {e}")


def _cluster_config(cl: dict):
    """The :class:`ClusterConfig` a ``"cluster"`` block describes: the nested
    ``breaker`` / ``retry_budget`` / ``respawn`` / ``autoscaler`` objects
    become the matching sub-configs."""
    from .serve.cluster import AutoscalerConfig, ClusterConfig, RespawnConfig
    from .serve.overload import BreakerConfig, RetryBudgetConfig

    kwargs = dict(cl)
    for key, cls in (("breaker", BreakerConfig), ("retry_budget", RetryBudgetConfig),
                     ("respawn", RespawnConfig), ("autoscaler", AutoscalerConfig)):
        if key in kwargs:
            kwargs[key] = cls(**kwargs[key])
    return ClusterConfig(**kwargs)


def _gray_config(gy: dict):
    """The :class:`GrayConfig` a ``"gray"`` block describes. A block that is
    present is armed unless it says otherwise: ``enabled`` defaults to True
    here (the dataclass's False serves programmatic construction)."""
    from .serve.cluster import GrayConfig

    kwargs = dict(gy)
    kwargs.setdefault("enabled", True)
    return GrayConfig(**kwargs)


def _validate_disagg(p: dict, die) -> None:
    """The reference's checks of the ``disagg`` block (experiment "serve")."""
    if "disagg" not in p:
        return
    from .codecs.faults import FaultConfig
    from .codecs.fec import FECConfig, HedgeConfig
    from .serve.disagg import DisaggConfig

    if "speculative" in p:
        die("disagg + speculative: the spec loop is single-stream with "
            "no prefill/decode split story — drop one of the two blocks")
    if "batching" not in p:
        die("disagg splits the continuous batcher into prefill and "
            "decode workers — add a 'batching' block")
    dg = p["disagg"]
    if not isinstance(dg, dict):
        die(f"disagg must be an object of DisaggConfig fields, got {dg!r}")
    top = {f.name for f in dataclasses.fields(DisaggConfig)}
    bad = sorted(set(dg) - top)
    if bad:
        die(f"disagg: unknown field(s) {bad}; known: {sorted(top)}")
    for key, cls in (("fec", FECConfig), ("hedge", HedgeConfig), ("faults", FaultConfig)):
        if dg.get(key) is None:
            continue
        if not isinstance(dg[key], dict):
            die(f"disagg.{key} must be an object of {cls.__name__} fields, got {dg[key]!r}")
        fields = {f.name for f in dataclasses.fields(cls)}
        bad = sorted(set(dg[key]) - fields)
        if bad:
            die(f"disagg.{key}: unknown field(s) {bad}; known: {sorted(fields)}")
    try:
        _disagg_config(dg)
    except (TypeError, ValueError) as e:
        die(f"disagg: {e}")


def _disagg_config(dg: dict):
    """The :class:`DisaggConfig` a ``"disagg"`` block describes: the nested
    ``fec`` / ``hedge`` / ``faults`` objects become the link's configs."""
    from .codecs.faults import FaultConfig
    from .codecs.fec import FECConfig, HedgeConfig
    from .serve.disagg import DisaggConfig

    kwargs = dict(dg)
    for key, cls in (("fec", FECConfig), ("hedge", HedgeConfig), ("faults", FaultConfig)):
        if kwargs.get(key) is not None:
            kwargs[key] = cls(**kwargs[key])
    return DisaggConfig(**kwargs)


def _validate_speculative(p: dict, die) -> None:
    """The reference's checks of the ``speculative`` block."""
    if "speculative" not in p:
        return
    from .serve.speculative import SpecConfig

    if "cuts" not in p:
        die("speculative decode verifies across the boundary — add 'cuts'/'hop_codecs'")
    sp = p["speculative"]
    if not isinstance(sp, dict):
        die(f"speculative must be an object of SpecConfig fields, got {sp!r}")
    fields = {f.name for f in dataclasses.fields(SpecConfig)}
    bad = sorted(set(sp) - fields)
    if bad:
        die(f"speculative: unknown field(s) {bad}; known: {sorted(fields)}")
    try:
        sc = SpecConfig(**sp)
    except (TypeError, ValueError) as e:
        die(f"speculative: {e}")
    if sc.enabled and p.get("fused_hops") == "remote":
        die("speculative + fused_hops 'remote': forced remote fusion is unprobed at the "
            "k-token verify shape — use 'auto' or 'off'")
    if sc.enabled and "batching" in p:
        die("speculative runs the one-stream spec loop; the batcher's ragged step verifies "
            "one token per slot — drop 'speculative' or 'batching'")


def _serve_front_config(sv: dict):
    """The :class:`ServeFrontConfig` a ``"serving"`` block describes: nested
    objects become the matching sub-configs; ``soak`` is the harness's."""
    from .serve.frontend import ServeFrontConfig
    from .serve.overload import (AdmissionConfig, BreakerConfig, BrownoutConfig,
                                 RetryBudgetConfig)

    kwargs = {k: v for k, v in sv.items() if k != "soak"}
    for key, cls in (("admission", AdmissionConfig), ("breaker", BreakerConfig),
                     ("brownout", BrownoutConfig), ("retry_budget", RetryBudgetConfig)):
        if key in kwargs:
            kwargs[key] = cls(**kwargs[key])
    return ServeFrontConfig(**kwargs)


def batching_config(cfg, params_json: dict):
    """The :class:`BatchingConfig` of a serve config: its ``batching`` block
    plus ``prefix_cache`` and the ``kv_at_rest`` tier (with ``pool_bytes``
    the page count is re-derived from the byte budget at that tier)."""
    from .models.paged_kv import PrefixCacheConfig, num_pages_for_bytes
    from .serve.batching import BatchingConfig

    kw = dict(params_json["batching"])
    if "prefix_cache" in params_json:
        kw["prefix_cache"] = PrefixCacheConfig(**params_json["prefix_cache"])
    if "kv_at_rest" in params_json:
        kq = params_json["kv_at_rest"]
        kw["kv_codec"] = kq["codec"]
        if "pool_bytes" in kq:
            kw["num_pages"] = num_pages_for_bytes(cfg, kq["pool_bytes"],
                                                  kw.get("page_size", 16),
                                                  kv_codec=kq["codec"])
    return BatchingConfig(**kw)


def _split_runtime(cfg, params: dict, params_json: dict):
    """The :class:`SplitRuntime` of a serve config's ``cuts`` /
    ``hop_codecs``, every stage on the weights' device, after ``fused_hops``
    is applied to the gate, with the config's faulty link (``faults``,
    ``link_policy``, ``fec``, ``hedge``) and ``pipeline`` as the reference
    builds it."""
    from .codecs.faults import FaultConfig, LinkPolicy
    from .codecs.fec import FECConfig, HedgeConfig
    from .parallel.split import SplitConfig, SplitRuntime

    apply_fused_hops(params_json)
    cuts = tuple(params_json["cuts"])
    lp = params_json.get("link_policy")
    link = dict(
        faults=FaultConfig(**params_json["faults"]) if "faults" in params_json else None,
        policy=LinkPolicy(**{**lp, "tiers": tuple(lp.get("tiers", ()))}) if lp else None,
        fec=FECConfig(**params_json["fec"]) if "fec" in params_json else None,
        hedge=HedgeConfig(**params_json["hedge"]) if "hedge" in params_json else None)
    return SplitRuntime(cfg, SplitConfig(cuts=cuts, hop_codecs=tuple(params_json["hop_codecs"])),
                        [params["embed"].device] * (len(cuts) + 1),
                        pipeline=pipeline_config(params_json), **link)


def pipeline_config(params_json: dict):
    """The :class:`PipelineConfig` of a ``"pipeline"`` block, or None."""
    if "pipeline" not in params_json:
        return None
    from .parallel.split import PipelineConfig

    return PipelineConfig(**params_json["pipeline"])


def _batched_setup(cfg, params: dict, params_json: dict) -> tuple:
    """What the batched serve routes share: the front's config, the soak,
    a :class:`FakeClock`, the batching config, the split runtime and its
    placed weights as batcher kwargs (with ``cuts``) and a factory of the
    batcher a front drains (a :class:`~.serve.disagg.DisaggServer` on the
    clock with ``disagg``, else a :class:`ContinuousBatcher`)."""
    from .serve.batching import ContinuousBatcher
    from .serve.soak import SoakConfig
    from .utils.clock import FakeClock

    sv = params_json["serving"]
    front_cfg = _serve_front_config(sv)
    soak = SoakConfig(**sv.get("soak", {}))
    clock = FakeClock()
    bcfg = batching_config(cfg, params_json)
    split_kw = {}
    if "cuts" in params_json:
        rt = _split_runtime(cfg, params, params_json)
        split_kw = dict(split_runtime=rt, placed_params=rt.place_params(params))
    dcfg = _disagg_config(params_json["disagg"]) if "disagg" in params_json else None

    def make_batcher():
        if dcfg is not None:
            from .serve.disagg import DisaggServer

            return DisaggServer(cfg, params, bcfg, dcfg, clock=clock, **split_kw)
        return ContinuousBatcher(cfg, params, bcfg, **split_kw)

    return front_cfg, soak, clock, bcfg, split_kw, make_batcher


def _warm_batcher(cfg, params: dict, bcfg, split_kw: dict, soak) -> None:
    """Warm the ragged step and the soak's prefill shape (kernel build,
    allocator) on a colocated batcher before the first request."""
    from .serve.batching import ContinuousBatcher

    warm = ContinuousBatcher(cfg, params, bcfg, **split_kw)
    warm.submit(np.ones((soak.prompt_len,), np.int32), 2)
    warm.run()


def _submit_arrivals(cfg, soak, clock, submit) -> None:
    """The soak's seeded arrivals, the reference's draws in its order:
    exponential gaps on ``clock``, prompts from ``soak.seed`` opening with
    one shared system prompt of ``shared_prefix_len`` tokens, request ``i``
    sampling under seed ``i``; each :class:`Request` goes to ``submit``."""
    from .serve.frontend import Request

    rng = np.random.default_rng(soak.seed)
    gaps = rng.exponential(1.0 / soak.arrival_rate, size=soak.n_requests)
    shared_pfx = (rng.integers(1, cfg.vocab_size, size=soak.shared_prefix_len).astype(np.int32)
                  if soak.shared_prefix_len else None)
    for i in range(soak.n_requests):
        clock.advance(float(gaps[i]))
        pi = rng.integers(1, cfg.vocab_size, size=soak.prompt_len).astype(np.int32)
        if shared_pfx is not None:
            pi[:soak.shared_prefix_len] = shared_pfx
        submit(Request(prompt_ids=pi, max_new_tokens=soak.max_new_tokens,
                       temperature=soak.temperature, deadline_s=soak.deadline_s, rng_seed=i))


def run_serve(cfg, params: dict, params_json: dict, out) -> dict:
    """The batched serve experiment (a ``batching`` block), as the reference
    CLI runs it: a warm
    batcher for the soak's prompt shape, then ``n_requests`` seeded arrivals
    (exponential gaps on a :class:`FakeClock`, prompts drawn from the soak's
    seed, a shared system prompt of ``shared_prefix_len`` tokens) submitted
    to a :class:`ServeFront` over one :class:`ContinuousBatcher` and drained
    through it. With ``cuts`` both batchers take a :class:`SplitRuntime`
    and its placed weights (mode "batched_split"); with ``disagg`` the
    front drains a :class:`~.serve.disagg.DisaggServer` on the same clock
    (the mode prefixed "disagg_", the migration count and the degrade flag
    on the line; the warm batcher stays colocated). Writes
    ``out("serve_report.json")`` and returns the printed
    summary line (the reference's keys) plus the records and the batcher
    report under ``"_records"`` / ``"_batcher"``. Raises ``SystemExit`` when
    a shared prefix was promised and the radix index never hit."""
    from .serve.frontend import ServeFront

    front_cfg, soak, clock, bcfg, split_kw, make_batcher = _batched_setup(
        cfg, params, params_json)
    batcher = make_batcher()
    front = ServeFront(cfg, params, config=front_cfg, clock=clock, batcher=batcher)
    _attach_front_obs(front)
    _warm_batcher(cfg, params, bcfg, split_kw, soak)
    _submit_arrivals(cfg, soak, clock, front.submit)
    records = front.drain_batched()
    rep = batcher.report()
    outcomes: dict = {}
    for rec in records:
        outcomes[rec.outcome] = outcomes.get(rec.outcome, 0) + 1
    artifact = {"requests": len(records), "outcomes": outcomes,
                "mode": (("disagg_" if "disagg" in params_json else "")
                         + ("batched_split" if split_kw else "batched")),
                "batcher": rep, "records": [r.as_dict() for r in records]}
    with open(out("serve_report.json"), "w") as f:
        json.dump(artifact, f, indent=1, default=float)
    pf = rep.get("prefix")
    summary = {
        "requests": len(records), "outcomes": outcomes, "mode": artifact["mode"],
        "batched_steps": rep["steps"], "jit_misses": rep["jit_misses"],
        "occupancy_mean": round(rep["alloc_util_mean"], 4),
        "decode_tokens_per_s": round(rep["decode_tokens_per_s"], 3),
        **({"prefix_hit_rate": round(pf["hit_rate"], 4),
            "prefill_tokens_saved": pf["saved_tokens"]} if pf else {}),
        **({"disagg_migrations": rep["disagg"]["migrations"],
            "disagg_degraded": rep["disagg"]["degraded"]} if rep.get("disagg") else {}),
        "artifact": out("serve_report.json")}
    if pf and soak.shared_prefix_len and not pf["hits"]:
        raise SystemExit(
            f"prefix cache enabled with shared_prefix_len={soak.shared_prefix_len} but the "
            f"radix index never hit: {pf}")
    return {**summary, "_records": records, "_batcher": rep, "_report": front.report(),
            "_front": front}


def run_cluster(cfg, params: dict, params_json: dict, out) -> dict:
    """The replica-router serve experiment (``batching`` and ``cluster``),
    as the reference CLI runs it: a :class:`~.serve.cluster.ClusterFront`
    of ``num_replicas`` :class:`ServeFront` s, each over its own batcher
    from the batched route's factory (so ``cuts`` and ``disagg`` compose
    with it), ``gray`` folded into the router's config; a warm colocated
    batcher, the batched route's seeded arrivals through ``cluster.submit``,
    then ``cluster.drain`` until it returns nothing. The replicas share the
    weights' device and drain in turn. ``record_cluster_stats`` absorbs the
    final report; writes ``out("cluster_report.json")`` (the report and
    every record) and returns the printed summary line (the reference's
    keys) plus the records, the report and the router under ``"_records"``
    / ``"_report"`` / ``"_cluster"``, and under ``"_lost"`` the message of
    the ``SystemExit`` the caller raises after printing when accepted work
    was left unterminated (None otherwise)."""
    from .obs.metrics import record_cluster_stats
    from .serve.cluster import ClusterFront
    from .serve.frontend import ServeFront

    front_cfg, soak, clock, bcfg, split_kw, make_batcher = _batched_setup(
        cfg, params, params_json)
    ccfg = _cluster_config(params_json["cluster"])
    if "gray" in params_json:
        ccfg = dataclasses.replace(ccfg, gray=_gray_config(params_json["gray"]))

    def replica_factory(replica_id, generation):
        return ServeFront(cfg, params, config=front_cfg, clock=clock, batcher=make_batcher())

    cluster = ClusterFront(replica_factory, ccfg, clock=clock)
    _attach_front_obs(cluster)
    _warm_batcher(cfg, params, bcfg, split_kw, soak)
    _submit_arrivals(cfg, soak, clock, cluster.submit)
    records = []
    while True:
        recs = cluster.drain()
        if not recs:
            break
        records.extend(recs)
    rep = cluster.report()
    record_cluster_stats(rep)
    outcomes: dict = {}
    for rec in records:
        outcomes[rec.outcome] = outcomes.get(rec.outcome, 0) + 1
    artifact = {"requests": len(records), "outcomes": outcomes,
                "mode": (("disagg_" if "disagg" in params_json else "")
                         + ("cluster_batched_split" if split_kw else "cluster_batched")),
                "cluster": rep, "records": [r.as_dict() for r in records]}
    with open(out("cluster_report.json"), "w") as f:
        json.dump(artifact, f, indent=1, default=float)
    summary = {"requests": len(records), "outcomes": outcomes, "mode": artifact["mode"],
               "replicas": len(rep["replicas"]), "placements": rep["totals"],
               "artifact": out("cluster_report.json")}
    lost = (f"cluster drain left {cluster.pending} accepted request(s) unterminated — the "
            f"router lost work: {rep}" if cluster.pending else None)
    return {**summary, "_records": records, "_report": rep, "_cluster": cluster,
            "_lost": lost}


def apply_fused_hops(params_json: dict) -> None:
    """``fused_hops`` onto the ``EDGELLM_FUSED_HOP`` gate, before a runtime
    resolves its fused plans: "auto" leaves the default (no fusion without
    probe data), "off" pins the separate hop, "wire" / "remote" force a mode
    (remote only on the card)."""
    fused_hops = params_json.get("fused_hops")
    if fused_hops == "auto":
        os.environ.pop("EDGELLM_FUSED_HOP", None)
    elif fused_hops is not None:
        os.environ["EDGELLM_FUSED_HOP"] = FUSED_HOP_ENV[fused_hops]


def run_serve_requests(cfg, params: dict, params_json: dict, out) -> dict:
    """The serve experiment without ``batching``, as the reference CLI runs
    it: a :class:`ServeFront` on a :class:`FakeClock`, with ``cuts`` over a
    :class:`SplitRuntime` whose stages all sit on the weights' device (and
    ``speculative`` its burst loop), else local; one warm ``generate`` (and
    ``generate_split``) call at the soak's plan, then :func:`run_soak`.
    Writes ``out("serve_report.json")`` (the soak's artifact, plus every
    record, as the batched route writes them, and every served request's
    ``tokens`` by request id) and returns the printed
    summary line (the reference's keys) plus the artifact and the records
    under ``"_artifact"`` / ``"_records"``."""
    from .serve.decode import generate, generate_split
    from .serve.frontend import ServeFront
    from .serve.soak import SoakConfig, run_soak
    from .serve.speculative import SpecConfig
    from .utils import prng
    from .utils.clock import FakeClock

    sv = params_json["serving"]
    front_cfg = _serve_front_config(sv)
    soak = SoakConfig(**sv.get("soak", {}))
    clock = FakeClock()
    rt = _split_runtime(cfg, params, params_json) if "cuts" in params_json else None
    link_health = None
    if rt is not None and "link_health" in params_json:
        from .codecs.fec import LinkHealth, LinkHealthConfig

        link_health = LinkHealth(config=LinkHealthConfig(**params_json["link_health"]),
                                 clock=clock)
    spec = SpecConfig(**params_json["speculative"]) if "speculative" in params_json else None
    front = ServeFront(cfg, params, split_runtime=rt, config=front_cfg, clock=clock,
                       speculative=spec, link_health=link_health)
    _attach_front_obs(front)
    # warm the soak's one (batch, capacity) plan: the virtual clock advances
    # by measured service time, which a first call's kernel builds would skew
    cr = front_cfg.capacity_round
    capacity = -(-(soak.prompt_len + soak.max_new_tokens) // cr) * cr
    warm_ids = np.zeros((1, soak.prompt_len), np.int32)
    warm_kw = dict(capacity=capacity, temperature=soak.temperature, rng_key=prng.key(0))
    generate(cfg, params, warm_ids, soak.max_new_tokens, **warm_kw)
    if rt is not None:
        if spec is not None and spec.enabled:
            warm_kw["capacity"] = max(capacity,
                                      soak.prompt_len + soak.max_new_tokens + spec.k - 2)
        generate_split(rt, rt.place_params(params), warm_ids, soak.max_new_tokens,
                       speculative=spec, raw_params=params, **warm_kw)
    artifact = run_soak(front, soak, clock=clock)
    artifact["records"] = [r.as_dict() for r in front.records]
    artifact["tokens"] = {str(r.request_id): np.asarray(r.tokens).tolist()
                          for r in front.records if r.tokens is not None}
    with open(out("serve_report.json"), "w") as f:
        json.dump(artifact, f, indent=1, default=float)
    summary = {"requests": artifact["requests"], "outcomes": artifact["outcomes"],
               "goodput_tokens_per_s": round(artifact["goodput_tokens_per_s"], 3),
               "slo_attainment": artifact["slo_attainment"],
               "p99_ttft_s": artifact["p99_ttft_s"],
               "token_identity_ok": (artifact["token_identity"] or {}).get("ok"),
               "artifact": out("serve_report.json")}
    return {**summary, "_artifact": artifact, "_records": list(front.records),
            "_report": artifact["report"], "_front": front}


def _print_serve_report(report: dict, front=None, artifact: Optional[dict] = None) -> None:
    """``--serve-report``'s tail, the reference's lines: outcome counts,
    reject / shed reasons, per-breaker states, the brownout and retry-budget
    posture, the prefix index. Beyond them, where they exist: the front's
    plan (the cuts it serves on after any failover), its failovers and its
    link counters summed over the requests it served, and the soak's kill."""
    print("serve report:")
    for k in sorted(report["outcomes"]):
        print(f"  outcome {k:<14} {report['outcomes'][k]}")
    for k in sorted(report.get("reasons", {})):
        print(f"  reason  {k:<28} {report['reasons'][k]}")
    for name, b in sorted(report["breakers"].items()):
        print(f"  breaker {name:<8} {b['state']:<9} opens={b['opens']} "
              f"failures={b['total_failures']}")
    bo = report["brownout"]
    print(f"  brownout level={bo['level']} mode={bo['mode']} "
          f"switches={bo['switches']} sheds={bo['sheds']}")
    rb = report["retry_budget"]
    print(f"  retry budget spent={rb['spent']} denied={rb['denied']} "
          f"available={rb['available']:.1f}")
    pf = report.get("prefix")
    if pf:
        print(f"  prefix  hits={pf['hits']} misses={pf['misses']} "
              f"hit_rate={pf['hit_rate']:.3f} "
              f"prefill_tokens_saved={pf['saved_tokens']}")
        print(f"  prefix  cow_forks={pf['cow_forks']} "
              f"shared_pages={pf['shared_pages']} "
              f"index_pages={pf['index_pages']} "
              f"evictions={pf['index_evictions']} "
              f"reclaimed={pf['reclaimed_pages']}")
    rt = front.split_runtime if front is not None else None
    if rt is not None:
        print(f"  plan    cuts={list(rt.split.cuts)} "
              f"hop_codecs={[c.name for c in rt.codecs]} failovers={report['failovers']}")
    lc = report.get("link_counters")
    if lc:
        print("  link    " + " ".join(f"{k}={v}" for k, v in lc.items()))
    kill = (artifact or {}).get("kill")
    if kill:
        print(f"  kill    stage={kill['stage']} at_s={kill['at_s']:.3f} "
              f"recovery_s={kill['recovery_s']}")


def _print_fault_report(result: dict) -> None:
    """``--fault-report``'s tail, as the reference prints it: the summed
    per-hop link counters, the link-health gauges and the recovery
    counters in one metrics registry, printed as one table, then the tier
    trail."""
    from .codecs.faults import flatten_counters
    from .obs.metrics import (MetricsRegistry, format_table, record_link_counters,
                              record_link_health, record_recovery_counters)

    counters = result.get("link_counters")
    if not counters:
        print("fault report: no link counters recorded (faults were off)")
        return
    reg = MetricsRegistry(enabled=True)
    record_link_counters(counters, registry=reg)
    for k, total in flatten_counters(counters).items():
        reg.counter(f"edgellm_link_{k}_total").inc(total, hop="total")
    record_link_health(result.get("link_health"), registry=reg)
    record_recovery_counters((result.get("recovery") or {}).get("counters"), registry=reg)
    print(format_table(reg, title="fault report (obs metrics registry)"))
    if result.get("tier_switches"):
        print(f"  tier switches: {result['tier_switches']} "
              f"(final tier {result.get('final_tier', 0)}, "
              f"{result.get('degraded_chunks', 0)} degraded chunk(s))")


def _print_trace_report(tracer) -> None:
    """``--trace-report``'s tail, the reference's: one block a request id
    with the span tree the host tracer recorded (wall time, TTFT from the
    first span to the end of ``generate.prefill``, nested span durations,
    every boundary hop's {cut, codec, wire bytes, ladder outcome}). Spans
    without a request id (warm-up, eval sweeps) are counted, not listed."""
    events = tracer.to_chrome_trace()["traceEvents"]
    by_rid: dict = {}
    unattributed = 0
    for ev in events:
        rid = (ev.get("args") or {}).get("rid")
        if rid is None:
            unattributed += 1
        else:
            by_rid.setdefault(str(rid), []).append(ev)
    if not by_rid:
        print(f"trace report: no request-attributed spans "
              f"({unattributed} unattributed span(s); tracing off, or "
              f"nothing was submitted)")
        return

    def _order(rid: str):
        # "r12" sorts numerically, anything else lexically after
        tail = rid.lstrip("r")
        return (0, int(tail), rid) if tail.isdigit() else (1, 0, rid)

    print(f"trace report: {len(by_rid)} request(s), "
          f"{sum(len(v) for v in by_rid.values())} attributed span(s)"
          + (f", {unattributed} unattributed" if unattributed else ""))
    for rid in sorted(by_rid, key=_order):
        evs = sorted(by_rid[rid], key=lambda e: (e["ts"], -e["dur"]))
        t0 = min(e["ts"] for e in evs)
        wall_ms = (max(e["ts"] + e["dur"] for e in evs) - t0) / 1e3
        prefill = [e for e in evs if e["name"] == "generate.prefill"]
        head = f"  {rid}: {wall_ms:.2f} ms wall"
        if prefill:
            head += (f", ttft "
                     f"{(prefill[0]['ts'] + prefill[0]['dur'] - t0) / 1e3:.2f}"
                     f" ms")
        print(head)
        open_until: list = []  # end timestamps of still-open ancestors
        for e in evs:
            while open_until and e["ts"] >= open_until[-1]:
                open_until.pop()
            pad = "    " + "  " * len(open_until)
            a = dict(e.get("args") or {})
            a.pop("rid", None)
            if e["name"] == "split.hop":
                line = (f"hop {a.pop('hop', '?')}: "
                        f"cut={a.pop('cut', '?')} codec={a.pop('codec', '?')}"
                        f" wire_bytes={a.pop('wire_bytes', '?')} "
                        f"outcome={a.pop('outcome', '?')}")
            else:
                line = f"{e['name']} {e['dur'] / 1e3:.2f} ms"
            if a:
                line += " " + " ".join(f"{k}={a[k]}" for k in sorted(a))
            print(pad + line)
            open_until.append(e["ts"] + e["dur"])


def run_distances(cfg, params: dict, corpus: np.ndarray, params_json: dict, args, out,
                  device) -> dict:
    """The layer-distance analysis, as the reference CLI runs it: one sample
    per array of a multi-array ``.npz`` corpus (each range-checked), else
    non-overlapping ``max_length`` windows of the flat corpus; samples
    shorter than 2 dropped, at most ``--max-chunks`` kept. Writes
    ``layer_distances.json`` and, where matplotlib imports, the heatmap
    ``layer_distances.png``; where it does not, says so on stderr and reports
    ``"heatmap": None``. Returns the printed summary line."""
    from .analysis import (layer_importance_distributions, pairwise_layer_distances,
                           save_heatmap)

    max_length = params_json.get("max_length", cfg.max_position_embeddings)
    if args.corpus and args.corpus.endswith(".npz"):
        data = np.load(args.corpus)
        samples = [np.asarray(data[f]).reshape(-1) for f in data.files]
        for i, s in enumerate(samples):  # _load_corpus only checked files[0]
            if s.size and (s.max() >= cfg.vocab_size or s.min() < 0):
                raise SystemExit(f"npz sample {i} has token ids outside "
                                 f"[0, {cfg.vocab_size}) — wrong tokenizer?")
    else:
        samples = [corpus[i:i + max_length] for i in range(0, len(corpus), max_length)]
    samples = [s for s in samples if len(s) >= 2]
    if args.max_chunks:
        samples = samples[: args.max_chunks]
    # clipping to bucketed lengths is opt-in: the notebook analyzes every
    # sample at native length
    max_compiles = params_json.get("max_compiles")
    dists = layer_importance_distributions(cfg, params, samples, max_compiles=max_compiles,
                                           device=device)
    matrix = pairwise_layer_distances(dists)
    artifact = {"matrix": [[None if not np.isfinite(v) else float(v) for v in row]
                           for row in matrix],
                "n_samples": len(samples), "model": args.model,
                "max_compiles": max_compiles,
                "clipped": max_compiles is not None and
                len({int(s.shape[0]) for s in samples}) > max_compiles}
    with open(out("layer_distances.json"), "w") as f:
        json.dump(artifact, f, indent=1)
    heatmap_path = out("layer_distances.png")
    try:
        save_heatmap(matrix, heatmap_path)
    except ImportError as e:
        print(f"distances: no heatmap written, matplotlib does not import ({e}); "
              f"the matrix is in {out('layer_distances.json')}", file=sys.stderr)
        heatmap_path = None
    return {"artifact": out("layer_distances.json"), "heatmap": heatmap_path,
            "n_samples": len(samples), "layers": matrix.shape[0]}


#: the flags ``--lint`` passes on to the lint CLI, each with its value
LINT_PASSTHROUGH = ("--device", "--json", "--matrix")


def _lint_argv(argv: list) -> list:
    """The lint CLI's arguments for ``--lint``: mypy off (as the
    reference's gate runs it), and ``--device`` (and the report paths
    ``--json`` / ``--matrix``) passed on when given."""
    out = ["--no-mypy"]
    for i, a in enumerate(argv):
        if a in LINT_PASSTHROUGH and i + 1 < len(argv):
            out += [a, argv[i + 1]]
        elif a.split("=", 1)[0] in LINT_PASSTHROUGH and "=" in a:
            out.append(a)
    return out


def main(argv=None) -> int:
    # --lint short-circuits before the parser: the graphlint gate needs no
    # params.json, and running it first means a contract violation is caught
    # before any experiment spends card time
    argv_list = sys.argv[1:] if argv is None else list(argv)
    if "--lint" in argv_list:
        from .lint.__main__ import main as lint_main

        return lint_main(_lint_argv(argv_list))
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--params", required=True,
                    help="reference-style params.json (or inline JSON)")
    from .models import PORT_PRESETS, PRESETS

    ap.add_argument("--model", default="qwen2-0.5b", choices=sorted({**PRESETS, **PORT_PRESETS}),
                    help="model preset")
    ap.add_argument("--corpus", help=".npy/.npz token ids or raw .txt (with --tokenizer); "
                                     "omitted -> synthetic corpus (smoke mode)")
    ap.add_argument("--tokenizer", help="local HF tokenizer path for raw-text corpora")
    ap.add_argument("--weights", help="local .safetensors file/dir, torch state_dict (.pt) "
                                      "or HF model dir; omitted -> random init (smoke mode)")
    ap.add_argument("--head-weights", help="LRP head weights .json (L x H) for weighted_importance")
    ap.add_argument("--output-dir", default=".")
    ap.add_argument("--max-chunks", type=int, help="stop after N chunks (smoke/CI)")
    ap.add_argument("--window-batch", type=int, default=8,
                    help="evaluation windows batched per forward (identical "
                         "accumulation)")
    ap.add_argument("--checkpoint-every", type=int, default=1000)
    ap.add_argument("--deadline-s", type=float,
                    help="split experiment: per-chunk watchdog deadline in seconds — a "
                         "stalled eval writes a best-effort resume checkpoint and exits "
                         "with a typed DecodeTimeout (overrides params.json \"deadline\")")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--synthetic-corpus-len", type=int, default=4096)
    ap.add_argument("--device", default="cuda",
                    help="torch device the sweep runs on (default: cuda)")
    ap.add_argument("--serve-report", action="store_true",
                    help="serve experiment: after the soak, print outcome counts, "
                         "reject / shed reasons, breaker states, the brownout and "
                         "retry-budget posture, the plan, failovers, link counters "
                         "and the kill")
    ap.add_argument("--fault-report", action="store_true",
                    help="split experiment: after the sweep, print the summed per-hop "
                         "link counters (detected / repaired / retried / hedge wins / "
                         "substituted), the tier trail and the link-health budget burn")
    ap.add_argument("--metrics-out", metavar="PATH",
                    help="enable the obs metrics registry and write its final snapshot to "
                         "PATH after the experiment: Prometheus text for .prom / .txt, "
                         "JSON otherwise")
    ap.add_argument("--trace-out", metavar="PATH",
                    help="enable host-side span tracing and write the Chrome trace-event "
                         "JSON to PATH (load at ui.perfetto.dev)")
    ap.add_argument("--trace-report", action="store_true",
                    help="after the experiment, print per-request span trees from the host "
                         "tracer (wall time, TTFT, every boundary hop's {cut, codec, wire "
                         "bytes, ladder outcome}); implies tracing")
    ap.add_argument("--profile", metavar="DIR",
                    help="capture a torch.profiler trace of the experiment (CPU and CUDA "
                         "activity) into DIR/torch_trace.json; every span opened in a "
                         "torch.profiler capture is a CPU range on the capture's clock")
    ap.add_argument("--obs-port", type=int, metavar="PORT",
                    help="serve the live telemetry endpoint on 127.0.0.1:PORT for the run "
                         "(0 = any free port): /metrics, /healthz, /snapshot.json, /trace")
    ap.add_argument("--distributed", action="store_true",
                    help="join a torch.distributed process group (gloo, env:// rendezvous: "
                         "MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK) before touching "
                         "devices; the split's data axis spreads over the processes")
    ap.add_argument("--lint", action="store_true",
                    help="run the graphlint gate (AST and thread rules, executed "
                         "graph contracts and the config lattice: python -m "
                         "edgellm_tpu_torch.lint --no-mypy, on --device; --json and "
                         "--matrix PATH pass on) and exit; handled before any other "
                         "flag is required")
    args = ap.parse_args(argv)

    if args.distributed:
        from .parallel import initialize_distributed
        from .parallel.distributed import process_index

        n_proc = initialize_distributed()
        print(f"distributed: process {process_index()} of {n_proc}", flush=True)

    if args.params.lstrip().startswith("{"):
        params_json = json.loads(args.params)
    else:
        with open(args.params) as f:
            params_json = json.load(f)
    _validate_params_json(params_json, args.device)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda, but torch finds no CUDA device; pass "
                         "--device cpu to run on the CPU")

    head_weights = None
    if args.head_weights:
        with open(args.head_weights) as f:
            head_weights = np.asarray(json.load(f))

    cfg, params = _load_model(args, device)
    os.makedirs(args.output_dir, exist_ok=True)
    out = lambda name: os.path.join(args.output_dir, name)
    from . import obs

    # --metrics-out / --trace-out / --trace-report / --obs-port arm the obs
    # package; a params.json "observability" object picks the pillars (a
    # flag forces its own pillar on); the previous state comes back after
    # the run: the pillars' flags, and a recorder or endpoint this run armed
    # is detached or stopped
    armed = (obs.get_registry().enabled, obs.tracing.tracing_enabled(),
             obs.get_flight_recorder(), obs.server.get_global())
    obs_params = params_json.get("observability")
    if (args.metrics_out or args.trace_out or args.trace_report
            or args.obs_port is not None or obs_params is not None):
        ob_cfg = obs.ObservabilityConfig(**(obs_params or {}))
        ob_cfg = dataclasses.replace(
            ob_cfg, metrics=ob_cfg.metrics or bool(args.metrics_out),
            tracing=ob_cfg.tracing or bool(args.trace_out) or args.trace_report)
        if args.obs_port is not None:
            try:
                ob_cfg = dataclasses.replace(ob_cfg, obs_port=args.obs_port)
            except ValueError as e:
                raise SystemExit(f"--obs-port: {e}")
        if ob_cfg.flight_recorder is True:
            # an unnamed recorder writes beside the run's other artifacts
            ob_cfg = dataclasses.replace(
                ob_cfg, flight_recorder=os.path.join(args.output_dir, "flight_recorder"))
        obs.enable(ob_cfg)
        srv = obs.server.get_global()
        if ob_cfg.obs_port is not None and srv is not None:
            print(f"obs endpoint -> {srv.url}  (/metrics /healthz /snapshot.json /trace)",
                  flush=True)
    try:
        with obs.trace_capture(args.profile):
            return _dispatch(args, cfg, params, params_json, head_weights, out, device)
    finally:
        # written even when the experiment dies: a partial trace or
        # snapshot is what a post-mortem needs
        _export_observability(args, obs)
        if args.trace_report:
            _print_trace_report(obs.get_tracer())
        obs.get_registry().enabled = armed[0]
        obs.tracing.configure(enabled=armed[1])
        if armed[2] is None:
            obs.configure_flight(None)
        if armed[3] is None:
            obs.server.stop_global()


def _attach_front_obs(front) -> None:
    """Point the live endpoint's ``/healthz`` at this serve front when
    ``--obs-port`` or ``obs_port`` started one (the endpoint starts before
    the front exists)."""
    from .obs.server import get_global

    srv = get_global()
    if srv is not None:
        srv.health_fn = front.health_summary


def _export_observability(args, obs) -> None:
    """``--metrics-out`` and ``--trace-out``'s files, as the reference
    writes them."""
    if args.metrics_out:
        reg = obs.get_registry()
        text = (reg.to_prometheus() if args.metrics_out.endswith((".prom", ".txt"))
                else reg.to_json(indent=1))
        with open(args.metrics_out, "w") as f:
            f.write(text)
        print(f"metrics snapshot -> {args.metrics_out}", flush=True)
    if args.trace_out:
        obs.get_tracer().export(args.trace_out)
        print(f"chrome trace -> {args.trace_out}", flush=True)


def split_mesh(params_json: dict, distributed: bool, device):
    """The split's mesh, as the reference builds it: under ``--distributed``
    the slice-aware multi-process layout (the data axis over the
    processes; a stage x seq mesh is checked, and the ring runs on
    ``device``); else a ("stage", "data", "model") mesh of the
    ``n_data`` / ``n_model`` sizes, every slot on ``device``; None for a
    stage x seq split."""
    from .parallel import (make_multihost_sp_stage_mesh, make_multihost_stage_mesh,
                           make_stage_mesh)

    n_stages = len(params_json["cuts"]) + 1
    n_data, n_model = params_json.get("n_data"), params_json.get("n_model", 1)
    if params_json.get("n_seq", 1) > 1:
        if distributed:
            make_multihost_sp_stage_mesh(n_stages, params_json["n_seq"], device=device)
        return None
    if distributed:
        return make_multihost_stage_mesh(n_stages, n_data=n_data, n_model=n_model,
                                         device=device)
    return make_stage_mesh(n_stages, n_data=n_data or 1, n_model=n_model, device=device)


def _dispatch(args, cfg, params: dict, params_json: dict, head_weights, out, device) -> int:
    """Run the experiment the params name and print its result line."""
    if params_json.get("experiment") == "serve":
        run = (run_serve_requests if "batching" not in params_json
               else run_cluster if "cluster" in params_json else run_serve)
        summary = run(cfg, params, params_json, out)
        print(json.dumps({k: v for k, v in summary.items() if not k.startswith("_")},
                         default=float))
        if summary.get("_lost"):
            raise SystemExit(summary["_lost"])
        if args.serve_report and "_front" in summary:
            _print_serve_report(summary["_report"], summary["_front"],
                                summary.get("_artifact"))
        return 0
    corpus = _load_corpus(args, cfg.vocab_size)
    if corpus.max() >= cfg.vocab_size or corpus.min() < 0:
        raise SystemExit(f"corpus token ids outside [0, {cfg.vocab_size}) — wrong tokenizer?")

    from .eval import run_channel_sweep, run_initial_sweep, run_split_eval, run_token_sweep

    experiment = params_json.get("experiment", "")
    methods = params_json.get("methods", [])
    max_length = params_json.get("max_length", cfg.max_position_embeddings)
    if experiment == "relevance":
        from .importance.relevance import run_relevance_extraction

        stats: dict = {}
        weights = run_relevance_extraction(
            cfg, params, corpus, max_length=max_length,
            stride=params_json.get("stride", 32), max_chunks=args.max_chunks,
            window_batch=max(args.window_batch, 1),
            checkpoint_path=out("relevance_checkpoint.json"),
            checkpoint_every=args.checkpoint_every,
            metrics_path=out("relevance_metrics.jsonl"), stats=stats, device=device)
        with open(out("attention_head_weights.json"), "w") as f:
            json.dump(np.asarray(weights).tolist(), f)
        print(json.dumps({"artifact": out("attention_head_weights.json"),
                          "shape": list(np.asarray(weights).shape), **stats}))
        return 0
    if experiment == "distances":
        print(json.dumps(run_distances(cfg, params, corpus, params_json, args, out, device)))
        return 0
    if experiment == "split":
        apply_fused_hops(params_json)
        result = run_split_eval(
            cfg, params, corpus, cuts=params_json["cuts"],
            hop_codecs=params_json["hop_codecs"], max_length=max_length,
            stride=params_json.get("stride", 32),
            importance_method=params_json.get("importance_method"),
            head_weights=head_weights, max_chunks=args.max_chunks,
            window_batch=max(args.window_batch, 1),
            checkpoint_path=out("split_checkpoint.json"),
            checkpoint_every=args.checkpoint_every,
            metrics_path=out("split_metrics.jsonl"),
            **{k: params_json.get(k) for k in LINK_KEYS},
            deadline_s=(args.deadline_s if args.deadline_s is not None
                        else params_json.get("deadline")),
            stage_failure=params_json.get("stage_failure"),
            recovery=params_json.get("recovery"),
            pipeline=pipeline_config(params_json), n_seq=params_json.get("n_seq", 1),
            mesh=split_mesh(params_json, args.distributed, device), device=device)
        with open(out("split_eval_results.json"), "w") as f:
            json.dump(result, f, indent=1)
        print(json.dumps(result))
        if args.fault_report:
            _print_fault_report(result)
        return 0
    common = dict(
        max_length=max_length, stride=params_json.get("stride", 32),
        checkpoint_path=out("sweep_checkpoint.json"),
        checkpoint_every=args.checkpoint_every,
        metrics_path=out("metrics.jsonl"),
        max_chunks=args.max_chunks,
        window_batch=max(args.window_batch, 1),
        device=device,
    )
    if experiment == "initial":
        result = run_initial_sweep(
            cfg, params, corpus, layers_of_interest=params_json["layers_of_interest"],
            ratios=params_json["ratios"], **common)
    elif methods and "channel" in methods[0]:
        result = run_channel_sweep(
            cfg, params, corpus, methods=methods,
            layers_of_interest=params_json["layers_of_interest"], **common)
    else:
        if head_weights is None and "weighted_importance" in methods:
            raise SystemExit("weighted_importance requires --head-weights "
                             "(produce it with experiment: \"relevance\")")
        if device.type == "cuda" and common["window_batch"] > 1:
            # an out-of-memory mid-sweep costs the run: shrink the window
            # batch first to what the probes say fits the card's budget
            from .tools.wb_preflight import preflight_token_sweep_batch

            wb = preflight_token_sweep_batch(
                cfg, common["window_batch"], max_length=max_length, stride=common["stride"],
                layers_of_interest=params_json["layers_of_interest"],
                ratios=params_json["ratios"],
                dtype=params["embed"].dtype, params=params, device=device)
            if wb != common["window_batch"]:
                print(f"window_batch {common['window_batch']} exceeds the memory budget; "
                      f"running at {wb}", flush=True)
                common["window_batch"] = wb
        result = run_token_sweep(
            cfg, params, corpus, methods=methods or ["regular_importance"],
            layers_of_interest=params_json["layers_of_interest"],
            ratios=params_json["ratios"], head_weights=head_weights, **common)

    with open(out("avg_ppl_results.json"), "w") as f:
        json.dump(result.to_json(), f, indent=1)
    print(result.table())
    print(json.dumps({"chunks": result.chunks, "n_tokens": result.n_tokens,
                      "wall_s": round(result.wall_s, 3),
                      "ppl": np.round(result.ppl(), 4).tolist()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
