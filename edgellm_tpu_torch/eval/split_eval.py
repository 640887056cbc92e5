"""Sliding-window perplexity over the real split runtime (PyTorch counterpart
of the plain path of ``edgellm_tpu/eval/split_eval.py``).

Every window group's forward crosses each cut as a packed payload
(``parallel.SplitRuntime``); the result records the PPL beside the measured
bytes per token per hop. An axes-validated JSON checkpoint every
``checkpoint_every`` chunks gives an exact resume (identical PPL and byte
totals), with an append-only metrics stream, as in the sweep drivers. The
checkpoint axes are the reference's, so a checkpoint written by either
package resumes in the other.

Not ported yet (each raises naming its argument): the faulty link and its
healing (``faults``, ``link_policy``, ``fec``, ``hedge``, ``link_health``),
survivability (``deadline_s``, ``stage_failure``, ``recovery``), the
micro-batch ``pipeline`` and the stage x seq runtime (``n_seq > 1``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..codecs.codec_kernels import SELECTIVE_EXCLUSION
from ..codecs.packing import selective_int4
from ..importance.metrics import importance_per_layer
from ..models.configs import ModelConfig
from ..models.transformer import nll_from_logits, params_to, run_layers_from_ids
from ..parallel.split import NOT_PORTED_MSG, SplitConfig, SplitRuntime
from .harness import ResumableDriver, _emit, _iter_window_groups, _run_pipelined


def parse_hop_codec(spec: str, n_seq: int = 1) -> object:
    """Codec spec -> registry name or ``WireCodec``.

    Plain names pass through (``"int4_per_token"``, ``"int8_per_token_pallas"``);
    token-selective specs are ``"selective_int4:<ratio>[:<high>]"`` (e.g.
    ``"selective_int4:0.25:bf16"``). ``n_seq > 1`` (the stage x seq ring
    runtime) is not ported yet."""
    if n_seq > 1:
        raise ValueError(f"n_seq > 1 (the stage x seq ring runtime) {NOT_PORTED_MSG}")
    if not spec.startswith("selective_int4"):
        return spec
    parts = spec.split(":")
    ratio = float(parts[1]) if len(parts) > 1 else 0.25
    high = parts[2] if len(parts) > 2 else "bf16"
    if len(parts) > 3:
        raise ValueError(f"selective mode {parts[3]!r} only applies to the "
                         f"stage x seq runtime (n_seq > 1)")
    if parts[0].endswith("_pallas"):
        raise ValueError(f"'selective_int4_pallas' no longer exists: {SELECTIVE_EXCLUSION}")
    return selective_int4(ratio, high)


def _importance(cfg: ModelConfig, params: dict, ids: torch.Tensor, method: str,
                head_weights) -> torch.Tensor:
    """The token importance of every layer, (L, B, S): one full-depth forward
    that captures the attention statistics (the reference's
    ``_importance_fn``)."""
    _, aux = run_layers_from_ids(cfg, params, ids, capture_stats=True)
    return importance_per_layer(aux["stats"], method, head_weights)


_UNPORTED_ARGS = ("faults", "link_policy", "fec", "hedge", "link_health",
                  "deadline_s", "stage_failure", "recovery", "pipeline")


def run_split_eval(
    cfg: ModelConfig,
    params: dict,
    token_ids: np.ndarray,
    *,
    cuts: Sequence[int],
    hop_codecs: Sequence,
    max_length: int,
    stride: int,
    importance_method: Optional[str] = None,
    head_weights: Optional[np.ndarray] = None,
    max_chunks: Optional[int] = None,
    time_hops: bool = True,
    window_batch: int = 1,
    n_seq: int = 1,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 1000,
    metrics_path: Optional[str] = None,
    faults=None,
    link_policy=None,
    fec=None,
    hedge=None,
    link_health=None,
    deadline_s: Optional[float] = None,
    stage_failure=None,
    recovery=None,
    pipeline=None,
    device="cuda",
) -> dict:
    """Token-weighted sliding-window PPL with the model split at ``cuts``,
    every stage on ``device``.

    ``hop_codecs`` entries are names, codec-spec strings or ``WireCodec``
    instances. Token-selective hops take their importance from
    ``importance_method``, computed at the hop's cut layer by a stats pass.
    ``window_batch``: up to W full-length windows per forward, with identical
    accumulation (per-row NLL weighting; token-selective hops carry per-row
    importance, so every window keeps its own ordering and scale).

    Returns the reference's result dict: ``ppl``, ``total_nll``,
    ``n_tokens``, ``chunks``, ``wall_s``, the token rates, ``cuts``,
    ``hop_codecs`` (as they ran: ``*_pallas`` for the kernel twins),
    ``bytes_per_token_per_hop``, the measured byte totals, the pad
    accounting, ``mesh`` and, with ``time_hops``, the per-hop times."""
    given = dict(faults=faults, link_policy=link_policy, fec=fec, hedge=hedge,
                 link_health=link_health, deadline_s=deadline_s,
                 stage_failure=stage_failure, recovery=recovery, pipeline=pipeline)
    for name in _UNPORTED_ARGS:
        if given[name] is not None:
            raise ValueError(f"run_split_eval {name} {NOT_PORTED_MSG}")
    if n_seq > 1:
        raise ValueError(f"n_seq > 1 (the stage x seq ring runtime) {NOT_PORTED_MSG}")
    codecs = [parse_hop_codec(c) if isinstance(c, str) else c for c in hop_codecs]
    split = SplitConfig(cuts=tuple(cuts), hop_codecs=tuple(codecs))
    devices = [torch.device(device)] * split.n_stages
    params = params_to(params, device=devices[0])
    rt = SplitRuntime(cfg, split, devices)
    placed = rt.place_params(params)
    needs_imp = [c.needs_importance for c in rt.codecs]
    if any(needs_imp) and importance_method is None:
        raise ValueError("token-selective hop codecs require importance_method")
    hw = (None if head_weights is None else
          torch.as_tensor(np.asarray(head_weights, np.float32), device=devices[0]))
    mesh = {"stage": split.n_stages, "data": 1, "model": 1}

    # resume axes: the USER-LEVEL split spec (requested codec specs, not the
    # runtime's kernel-twin names), exactly the reference's
    axes = {
        "model": {"family": cfg.family, "num_layers": cfg.num_layers,
                  "hidden_size": cfg.hidden_size, "num_heads": cfg.num_heads,
                  "vocab_size": cfg.vocab_size},
        "cuts": [int(c) for c in cuts],
        "hop_codecs": [c if isinstance(c, str) else c.name for c in hop_codecs],
        "max_length": int(max_length), "stride": int(stride),
        "importance_method": importance_method,
        "window_batch": int(window_batch), "n_seq": int(n_seq),
        "mesh": mesh,
    }
    rd = ResumableDriver(checkpoint_path, axes, checkpoint_every)
    total_nll, n_tokens = 0.0, 0.0
    fwd_tokens = 0  # every token pushed through the pipeline
    real_fwd_tokens = 0  # the same, minus batch-pad windows
    hop_bytes_total = [0] * len(rt.codecs)  # measured per chunk, tail included
    if rd.state is not None:
        total_nll, n_tokens = rd.state["total_nll"], rd.state["n_tokens"]
        fwd_tokens = rd.state["fwd_tokens"]
        real_fwd_tokens = rd.state["real_fwd_tokens"]
        hop_bytes_total = list(rd.state["hop_bytes_total"])

    def save_checkpoint():
        rd.save({"total_nll": total_nll, "n_tokens": n_tokens,
                 "fwd_tokens": fwd_tokens, "real_fwd_tokens": real_fwd_tokens,
                 "hop_bytes_total": hop_bytes_total})

    bytes_cache: dict = {}

    def submit_group(group):
        n_real = len(group)
        s_unpadded = group[0].input_ids.shape[1]
        counts = [c.num_loss_tokens for c in group]
        ids = torch.from_numpy(np.concatenate([c.input_ids for c in group]).astype(np.int64))
        targets = torch.from_numpy(np.concatenate([c.target_ids for c in group]))
        ids = ids.to(devices[0])
        with torch.inference_mode():
            hop_imp = None
            if any(needs_imp):
                imp = _importance(cfg, params, ids, importance_method, hw)  # (L, W, S)
                hop_imp = [(imp[cut] if len(group) > 1 else imp[cut, 0]) if need else None
                           for cut, need in zip(split.cuts, needs_imp)]
            logits = rt.forward(placed, ids, hop_importance=hop_imp)
            nlls = nll_from_logits(logits, targets.to(logits.device), per_example=True)
        return group, n_real, s_unpadded, counts, tuple(ids.shape), nlls

    def drain_group(rec):
        nonlocal total_nll, n_tokens, fwd_tokens, real_fwd_tokens
        group, n_real, s_unpadded, counts, (w, s_chunk), nlls = rec
        total_nll += float(nlls.double().cpu().numpy() @ np.asarray(counts, np.float64))
        n_tokens += sum(counts)
        fwd_tokens += w * s_chunk
        real_fwd_tokens += n_real * s_unpadded
        key = (w, s_chunk)
        if key not in bytes_cache:  # payloads are shape-determined
            bytes_cache[key] = rt.hop_bytes(w, s_chunk)
        for i, b in enumerate(bytes_cache[key]):
            hop_bytes_total[i] += b
        if rd.advance(group, count=n_real):
            save_checkpoint()
            _emit(metrics_path, {
                "chunk": group[-1].index, "chunks": rd.chunks, "n_tokens": n_tokens,
                "ppl": float(np.exp(total_nll / max(n_tokens, 1e-9))),
                "hop_bytes_total": hop_bytes_total})

    _run_pipelined(
        _iter_window_groups(token_ids, max_length, stride, window_batch=window_batch,
                            start_chunk=rd.start_chunk,
                            max_count=rd.remaining(max_chunks)),
        submit_group, drain_group)
    wall = rd.wall()  # cumulative across resumes
    save_checkpoint()

    seq = min(max_length, len(np.asarray(token_ids).reshape(-1)))
    result = {
        "ppl": float(np.exp(total_nll / max(n_tokens, 1e-9))),
        "total_nll": total_nll,
        "n_tokens": n_tokens,
        "chunks": rd.chunks,
        "wall_s": wall,
        "tokens_per_s": fwd_tokens / max(wall, 1e-9),
        "scored_tokens_per_s": n_tokens / max(wall, 1e-9),
        "cuts": list(split.cuts),
        "hop_codecs": [c.name for c in rt.codecs],
        # the per-token rate at the steady window size, and the byte totals
        # accumulated chunk by chunk (short tail windows included)
        "bytes_per_token_per_hop": rt.bytes_per_token(seq),
        "measured_hop_bytes_total": hop_bytes_total,
        "measured_bytes_per_fwd_token_per_hop": [
            b / max(fwd_tokens, 1) for b in hop_bytes_total],
        "real_fwd_tokens": real_fwd_tokens,
        "pad_fraction": 1.0 - real_fwd_tokens / max(fwd_tokens, 1),
        "real_tokens_per_s": real_fwd_tokens / max(wall, 1e-9),
        "mesh": mesh,
    }
    if time_hops and rd.chunks:
        result["per_hop_ms"] = rt.time_hops(1, seq)
        result["per_decode_hop_ms"] = rt.time_decode_hops(1)
        result["per_hop_timing"] = [
            {"hop": s, "cut_layer": int(split.cuts[s]), "codec": rt.codecs[s].name,
             "forward_ms": result["per_hop_ms"][s],
             "decode_ms": result["per_decode_hop_ms"][s]}
            for s in range(len(split.cuts))]
    _emit(metrics_path, {"final": True, "chunks": rd.chunks, "n_tokens": n_tokens,
                         "ppl": result["ppl"], "wall_s": wall,
                         "hop_bytes_total": hop_bytes_total,
                         "pad_fraction": result["pad_fraction"]})
    return result
