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
  model cut at ``cuts``, each cut crossed as a packed ``hop_codecs`` payload
- otherwise                   -> the Qwen-style token sweep

The ``serve``, ``relevance`` and ``distances`` experiments are not ported
yet: they exit non-zero, naming the experiment. So does a split config that
carries a key of a split feature not ported yet (``UNPORTED_SPLIT_KEYS``:
faults, healing, survivability, pipelining, the seq / data / model mesh
axes), naming the key. ``fused_hops`` maps onto the ``EDGELLM_FUSED_HOP``
gate as in the reference ("auto" fuses nowhere on the card yet: the port has
no probe cache).

Corpus input is a ``.npy``/``.npz`` of token ids, or a raw ``.txt`` plus
``--tokenizer`` (a local HF tokenizer path). Weights: ``--weights`` (a
``.safetensors`` file or directory, a state_dict ``.pt``, or an HF directory),
else random fp32 init from ``--seed`` (smoke/benchmark mode). Runs on the
card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

#: experiments of the reference CLI that this package has not ported yet
NOT_PORTED = ("relevance", "distances", "serve")
#: split keys whose feature is not ported yet (the mesh axes only above 1)
UNPORTED_SPLIT_KEYS = ("faults", "link_policy", "fec", "hedge", "link_health",
                       "pipeline", "deadline", "stage_failure", "recovery",
                       "n_seq", "n_data", "n_model")
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
    if exp != "split" and (
            "faults" in p or "link_policy" in p or "fec" in p
            or "hedge" in p or "link_health" in p):
        die("faults/link_policy/fec/hedge/link_health only apply to "
            "experiments 'split' and 'serve'")
    if exp != "split" and ("deadline" in p or "stage_failure" in p
                           or "recovery" in p):
        die("deadline/stage_failure/recovery only apply to experiment 'split'")
    if "serving" in p:
        die("serving only applies to experiment 'serve'")
    if "batching" in p:
        die("batching only applies to experiment 'serve'")
    for k in _REQUIRED.get(exp, ()):
        if k not in p:
            die(f"experiment {exp!r} requires key {k!r}")
    if exp not in ("split", "initial"):
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
    for key, msg in _ONLY_FOR:
        if key in p:
            die(msg)


def _validate_split(p: dict, die, device) -> None:
    """The split branch: unported features die naming their key, then the
    reference's checks of ``cuts`` and ``hop_codecs``, then the codecs'
    resolution on ``device``."""
    for key in UNPORTED_SPLIT_KEYS:
        if key in p and not (key in ("n_seq", "n_data", "n_model") and p[key] == 1):
            die(f"{key} is not ported yet to edgellm_tpu_torch; drop it or run "
                f"the split with python -m edgellm_tpu.run")
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
    args = ap.parse_args(argv)

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
    corpus = _load_corpus(args, cfg.vocab_size)
    if corpus.max() >= cfg.vocab_size or corpus.min() < 0:
        raise SystemExit(f"corpus token ids outside [0, {cfg.vocab_size}) — wrong tokenizer?")
    os.makedirs(args.output_dir, exist_ok=True)
    out = lambda name: os.path.join(args.output_dir, name)

    from .eval import run_channel_sweep, run_initial_sweep, run_split_eval, run_token_sweep

    experiment = params_json.get("experiment", "")
    methods = params_json.get("methods", [])
    max_length = params_json.get("max_length", cfg.max_position_embeddings)
    if experiment == "split":
        # fused_hops maps onto the EDGELLM_FUSED_HOP gate before the runtime
        # resolves its fused plans: "auto" leaves the default (no fusion
        # without probe data), "off" pins the separate hop, "wire" / "remote"
        # force a mode (remote only on the card)
        fused_hops = params_json.get("fused_hops")
        if fused_hops == "auto":
            os.environ.pop("EDGELLM_FUSED_HOP", None)
        elif fused_hops is not None:
            os.environ["EDGELLM_FUSED_HOP"] = FUSED_HOP_ENV[fused_hops]
        result = run_split_eval(
            cfg, params, corpus, cuts=params_json["cuts"],
            hop_codecs=params_json["hop_codecs"], max_length=max_length,
            stride=params_json.get("stride", 32),
            importance_method=params_json.get("importance_method"),
            head_weights=head_weights, max_chunks=args.max_chunks,
            window_batch=max(args.window_batch, 1),
            checkpoint_path=out("split_checkpoint.json"),
            checkpoint_every=args.checkpoint_every,
            metrics_path=out("split_metrics.jsonl"), device=device)
        with open(out("split_eval_results.json"), "w") as f:
            json.dump(result, f, indent=1)
        print(json.dumps(result))
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
