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
  over the faulty link, whose counters and tier trail ``--fault-report``
  prints
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
  a ``SplitRuntime`` (the split-paged batcher, mode "batched_split")
- ``experiment: "serve"`` without ``batching`` -> the front's per-request
  route through ``run_soak``: with ``cuts`` / ``hop_codecs`` every request
  on a ``SplitRuntime`` (``generate_split``; ``speculative``: the draft /
  verify burst loop), else on the single-device ``generate``; the identity
  audit, ``serve_report.json`` and one JSON line

A split config that carries a key of a split feature not ported yet
(``UNPORTED_SPLIT_KEYS``: survivability, pipelining, the seq / data / model
mesh axes) exits non-zero, and so do a serve config with a key of a serve
feature not ported yet (``UNPORTED_SERVE_KEYS``: the link keys among them,
since the decode paths take no link yet), the per-request route's recovery
and chaos fields (``serving.checkpoint_dir``, ``serving.step_deadline_s``,
``serving.soak.kill_stage``), and ``--serve-report``, each naming what is
missing. ``fused_hops`` maps onto the ``EDGELLM_FUSED_HOP`` gate as in the
reference ("auto" fuses a hop only where this card's probe cache recorded
a win, ``codecs/probe_cache.py``).

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

import numpy as np
import torch

#: experiments of the reference CLI that this package has not ported yet
NOT_PORTED = ()
#: split keys whose feature is not ported yet (the mesh axes only above 1)
UNPORTED_SPLIT_KEYS = ("pipeline", "deadline", "stage_failure", "recovery",
                       "n_seq", "n_data", "n_model")
#: the faulty link's keys (ported under experiment "split")
LINK_KEYS = ("faults", "link_policy", "fec", "hedge", "link_health")
#: serve keys whose feature is not ported yet (the boundary's faulty links on
#: the decode paths, µ-batch pipelining, the fleet)
UNPORTED_SERVE_KEYS = ("faults", "link_policy", "fec", "hedge", "link_health", "pipeline",
                       "cluster", "disagg", "gray")
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
    from .models import PRESETS, config_from_hf, init_params, params_from_state_dict

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
    cfg = PRESETS[args.model]
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
        die("observability is not ported yet to edgellm_tpu_torch; drop the "
            "block or run with python -m edgellm_tpu.run")
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
        if key in p:
            die(msg)


def _validate_split(p: dict, die, device) -> None:
    """The split branch: unported features die naming their key, then the
    reference's checks of ``cuts``, ``hop_codecs`` and ``importance_method``,
    the codecs' resolution on ``device``, then the link keys."""
    for key in UNPORTED_SPLIT_KEYS:
        if key in p and not (key in ("n_seq", "n_data", "n_model") and p[key] == 1):
            die(f"{key} is not ported yet to edgellm_tpu_torch; drop it or run "
                f"the split with python -m edgellm_tpu.run")
    _validate_cuts(p, die, device)
    _validate_link(p, die)


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
            resolved = parse_hop_codec(spec)
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
    """The serve branch: unported features die naming what is missing, then
    the reference's checks of ``cuts``, the ``serving``, ``batching``,
    ``prefix_cache``, ``kv_at_rest`` and ``speculative`` blocks, with its
    messages."""
    for key in UNPORTED_SERVE_KEYS:
        if key in p:
            die(f"{key} is not ported yet to edgellm_tpu_torch under experiment 'serve'; "
                f"drop it or run with python -m edgellm_tpu.run")
    if "cuts" in p:
        _validate_cuts(p, die, device)
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
        for name in ("checkpoint_dir", "step_deadline_s"):
            if sv.get(name) is not None:
                die(f"serving.{name} (the per-request route's recovery) is not ported yet "
                    f"to edgellm_tpu_torch; drop it or run with python -m edgellm_tpu.run")
        if ks is not None:
            die("serving.soak.kill_stage (stage loss) is not ported yet to "
                "edgellm_tpu_torch; drop it or run with python -m edgellm_tpu.run")
        for key, msg in (
                ("prefix_cache", "prefix_cache rides the continuous batcher's paged pool — "
                                 "add a 'batching' block"),
                ("kv_at_rest", "kv_at_rest compresses the continuous batcher's paged pool "
                               "— add a 'batching' block")):
            if key in p:
                die(msg)
        _validate_speculative(p, die)
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
    _validate_speculative(p, die)


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
    is applied to the gate."""
    from .parallel.split import SplitConfig, SplitRuntime

    apply_fused_hops(params_json)
    cuts = tuple(params_json["cuts"])
    return SplitRuntime(cfg, SplitConfig(cuts=cuts, hop_codecs=tuple(params_json["hop_codecs"])),
                        [params["embed"].device] * (len(cuts) + 1))


def run_serve(cfg, params: dict, params_json: dict, out) -> dict:
    """The batched serve experiment (a ``batching`` block), as the reference
    CLI runs it: a warm
    batcher for the soak's prompt shape, then ``n_requests`` seeded arrivals
    (exponential gaps on a :class:`FakeClock`, prompts drawn from the soak's
    seed, a shared system prompt of ``shared_prefix_len`` tokens) submitted
    to a :class:`ServeFront` over one :class:`ContinuousBatcher` and drained
    through it. With ``cuts`` both batchers take a :class:`SplitRuntime`
    and its placed weights (mode "batched_split"). Writes
    ``out("serve_report.json")`` and returns the printed
    summary line (the reference's keys) plus the records and the batcher
    report under ``"_records"`` / ``"_batcher"``. Raises ``SystemExit`` when
    a shared prefix was promised and the radix index never hit."""
    from .serve.batching import ContinuousBatcher
    from .serve.frontend import Request, ServeFront
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
    batcher = ContinuousBatcher(cfg, params, bcfg, **split_kw)
    front = ServeFront(cfg, params, config=front_cfg, clock=clock, batcher=batcher)
    # warm the ragged step and the soak's prefill shape (kernel build,
    # allocator) before the first request
    warm = ContinuousBatcher(cfg, params, bcfg, **split_kw)
    warm.submit(np.ones((soak.prompt_len,), np.int32), 2)
    warm.run()
    del warm
    rng = np.random.default_rng(soak.seed)
    gaps = rng.exponential(1.0 / soak.arrival_rate, size=soak.n_requests)
    shared_pfx = (rng.integers(1, cfg.vocab_size, size=soak.shared_prefix_len).astype(np.int32)
                  if soak.shared_prefix_len else None)
    for i in range(soak.n_requests):
        clock.advance(float(gaps[i]))
        pi = rng.integers(1, cfg.vocab_size, size=soak.prompt_len).astype(np.int32)
        if shared_pfx is not None:
            pi[:soak.shared_prefix_len] = shared_pfx
        front.submit(Request(prompt_ids=pi, max_new_tokens=soak.max_new_tokens,
                             temperature=soak.temperature, deadline_s=soak.deadline_s,
                             rng_seed=i))
    records = front.drain_batched()
    rep = batcher.report()
    outcomes: dict = {}
    for rec in records:
        outcomes[rec.outcome] = outcomes.get(rec.outcome, 0) + 1
    artifact = {"requests": len(records), "outcomes": outcomes,
                "mode": "batched_split" if split_kw else "batched",
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
        "artifact": out("serve_report.json")}
    if pf and soak.shared_prefix_len and not pf["hits"]:
        raise SystemExit(
            f"prefix cache enabled with shared_prefix_len={soak.shared_prefix_len} but the "
            f"radix index never hit: {pf}")
    return {**summary, "_records": records, "_batcher": rep}


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
    spec = SpecConfig(**params_json["speculative"]) if "speculative" in params_json else None
    front = ServeFront(cfg, params, split_runtime=rt, config=front_cfg, clock=clock,
                       speculative=spec)
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
    return {**summary, "_artifact": artifact, "_records": list(front.records)}


def _print_fault_report(result: dict) -> None:
    """``--fault-report``'s tail, as the reference prints it: the summed
    per-hop link counters and the link-health gauges in one metrics
    registry, printed as one table, then the tier trail. The recovery block
    (item 21) is not ported: the table carries no recovery counters."""
    from .codecs.faults import flatten_counters
    from .obs.metrics import (MetricsRegistry, format_table, record_link_counters,
                              record_link_health)

    counters = result.get("link_counters")
    if not counters:
        print("fault report: no link counters recorded (faults were off)")
        return
    reg = MetricsRegistry(enabled=True)
    record_link_counters(counters, registry=reg)
    for k, total in flatten_counters(counters).items():
        reg.counter(f"edgellm_link_{k}_total").inc(total, hop="total")
    record_link_health(result.get("link_health"), registry=reg)
    print(format_table(reg, title="fault report (obs metrics registry)"))
    if result.get("tier_switches"):
        print(f"  tier switches: {result['tier_switches']} "
              f"(final tier {result.get('final_tier', 0)}, "
              f"{result.get('degraded_chunks', 0)} degraded chunk(s))")


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--params", required=True,
                    help="reference-style params.json (or inline JSON)")
    from .models import PRESETS

    ap.add_argument("--model", default="qwen2-0.5b", choices=sorted(PRESETS),
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
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--synthetic-corpus-len", type=int, default=4096)
    ap.add_argument("--device", default="cuda",
                    help="torch device the sweep runs on (default: cuda)")
    ap.add_argument("--serve-report", action="store_true",
                    help="the reference's serve-report printer (not ported yet)")
    ap.add_argument("--fault-report", action="store_true",
                    help="split experiment: after the sweep, print the summed per-hop "
                         "link counters (detected / repaired / retried / hedge wins / "
                         "substituted), the tier trail and the link-health budget burn")
    args = ap.parse_args(argv)
    if args.serve_report:
        raise SystemExit("--serve-report is not ported yet to edgellm_tpu_torch; run it "
                         "with python -m edgellm_tpu.run")

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
    if params_json.get("experiment") == "serve":
        run = run_serve if "batching" in params_json else run_serve_requests
        summary = run(cfg, params, params_json, out)
        print(json.dumps({k: v for k, v in summary.items() if not k.startswith("_")},
                         default=float))
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
            **{k: params_json.get(k) for k in LINK_KEYS}, device=device)
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
