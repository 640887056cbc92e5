"""Sweep drivers: (method x split-layer x ratio) perplexity sweeps
(PyTorch counterpart of ``edgellm_tpu/eval/harness.py``).

Each window group runs ONE prefix forward that captures attention statistics
and keeps the boundary activation at every split layer of interest; each
(method, layer, ratio) combination then costs only a codec step and the layer
suffix [l+1, L), with the (ratio x window) rows flattened into one batch.
The suffix resumes from the exact pre-quantization hidden state a full
forward would recompute.

Accumulation semantics per experiment:
- token-weighted: ``total += nll * num_loss_tokens; PPL = exp(total / n_tokens)``
  (token and channel sweeps);
- unweighted mean of chunk means (the Pythia "initial" experiment).

Checkpoint/resume: the JSON checkpoint stores the next chunk index and the
accumulators, written atomically, so a restart is exact.

Device work is issued without host syncs and drained one group later
(:func:`_run_pipelined`), so the host's accumulation and checkpointing of one
group overlap the card's work on the next.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..codecs.simulate import (channel_wise_quant_windows, int4_token_select_windows,
                               per_token_affine_int8, token_select_mask, top_rho_mask)
from ..importance.metrics import (aggregate_upto, importance_per_layer,
                                  maximum_aggregation, regular_importance)
from ..models.configs import ModelConfig
from ..models.transformer import AttnStats, embed, nll_tail, params_to, run_layers
from .windowing import sliding_windows

TOKEN_CODECS = ("int4_token_select", "affine_int8_rank", "affine_int8_top_rho")


def run_with_oom_backoff(run: Callable[[int], object], window_batch: int,
                         min_window_batch: int = 1, on_backoff=None):
    """Call ``run(window_batch)``, halving the batch on out-of-memory instead
    of dying -> (result, effective_window_batch). ``run`` must be restartable
    (the sweep drivers are; with a checkpoint a retried call resumes from it)."""
    import gc

    wb = window_batch
    while True:
        msg = None
        try:
            return run(wb), wb
        except (MemoryError, torch.cuda.OutOfMemoryError) as e:
            if wb <= min_window_batch:
                raise
            msg = str(e)
            wb = max(wb // 2, min_window_batch)
        # free OUTSIDE the except block: the active exception's traceback
        # frames still hold the failed call's tensors inside it
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        if on_backoff:
            on_backoff(wb, msg)


def _apply_token_codec_windows(codec: str, hidden, importance, ratio, k):
    """Quantize W windows ``hidden`` (W, S, D) under one token codec, each
    window with its own scales; ``importance`` (W, S); ``ratio`` a float32
    fraction; ``k`` the host-computed ``int(ratio * S)``."""
    seq_len = hidden.shape[1]
    if codec == "int4_token_select":
        return int4_token_select_windows(hidden, importance, ratio, k=k)
    if codec == "affine_int8_rank":
        return per_token_affine_int8(hidden, token_select_mask(importance, ratio, seq_len, k=k))
    if codec == "affine_int8_top_rho":
        return per_token_affine_int8(hidden, top_rho_mask(importance, 1.0 - ratio))
    raise ValueError(f"unknown token codec {codec!r}; options: {TOKEN_CODECS}")


def _stats_forward(cfg: ModelConfig, params: dict, ids: torch.Tensor,
                   hidden_layers: tuple, want_final: bool = False,
                   stats_upto: Optional[int] = None):
    """Prefix pass: ids -> (attention stats, boundary hiddens, final hidden
    or None).

    Stats cover layers [0, stats_upto] (default: the deepest hidden layer);
    boundary hiddens are kept only at ``hidden_layers``, stacked in sorted
    layer order. With ``want_final`` the layers past the stats depth run
    without stats and the final hidden is returned, whose scoring tail is the
    ratio-0 baseline."""
    layers = tuple(sorted({int(l) for l in hidden_layers}))
    upto = max(stats_upto if stats_upto is not None else 0, layers[-1])
    h = embed(params, ids)
    cols, lasts, hiddens = [], [], []
    prev = 0
    for cut in layers:
        h, aux = run_layers(cfg, params, h, start=prev, stop=cut + 1, capture_stats=True)
        cols.append(aux["stats"].col_mean)
        lasts.append(aux["stats"].last_row)
        hiddens.append(h)
        prev = cut + 1
    if prev <= upto:
        h, aux = run_layers(cfg, params, h, start=prev, stop=upto + 1, capture_stats=True)
        cols.append(aux["stats"].col_mean)
        lasts.append(aux["stats"].last_row)
        prev = upto + 1
    stats = AttnStats(col_mean=torch.cat(cols), last_row=torch.cat(lasts))
    final = run_layers(cfg, params, h, start=prev)[0] if want_final else None
    return stats, torch.stack(hiddens), final


def _plain_forward(cfg: ModelConfig, params: dict, ids: torch.Tensor,
                   hidden_layers: tuple):
    """Prefix pass without stats: the boundary hiddens at ``hidden_layers``
    (stacked in sorted layer order), stopping at the deepest one."""
    h = embed(params, ids)
    hiddens, prev = [], 0
    for cut in sorted({int(l) for l in hidden_layers}):
        h, _ = run_layers(cfg, params, h, start=prev, stop=cut + 1)
        hiddens.append(h)
        prev = cut + 1
    return torch.stack(hiddens)


# Codecs for which ratio == 0 provably quantizes nothing, so the fp-baseline
# column is method-independent and computed once per group.
DEDUP_ZERO_CODECS = ("int4_token_select", "affine_int8_rank")


def _suffix_sweep(cfg: ModelConfig, params: dict, layer: int, codec: str, tail: int,
                  boundary_hidden, targets, importance, ratios, ks):
    """Boundary hiddens at ``layer`` -> (ratio, window) NLL matrix.

    The codec runs per (ratio, window), each window with its own scales (the
    reference quantizes each window alone at batch 1); the suffix forward and
    the scoring tail then run on the flattened (R*W, S, D) batch, where every
    row still scores alone. boundary_hidden (W, S, D), targets (W, S),
    importance (W, S), ratios (R,) float32, ks R ints -> (R, W)."""
    w, s, d = boundary_hidden.shape
    r = ratios.shape[0]
    h = torch.stack([_apply_token_codec_windows(codec, boundary_hidden, importance,
                                                ratios[i], ks[i])
                     for i in range(r)]).reshape(r * w, s, d)
    out, _ = run_layers(cfg, params, h, start=layer + 1)
    tgt = targets[None].expand(r, w, s).reshape(r * w, s)
    return nll_tail(cfg, params, out, tgt, tail, per_example=True).reshape(r, w)


def _suffix_channel(cfg: ModelConfig, params: dict, layer: int, method: str, tail: int,
                    boundary_hidden, targets):
    """Boundary hiddens (W, S, D) -> per-window NLL (W,) under one per-channel
    codec, each window with its own channel scales."""
    h = channel_wise_quant_windows(boundary_hidden, method)
    out, _ = run_layers(cfg, params, h, start=layer + 1)
    return nll_tail(cfg, params, out, targets, tail, per_example=True)


@dataclasses.dataclass
class SweepResult:
    """Accumulated sweep state. ``total_nll`` indexed [method][layer][ratio]
    (token sweeps), [method][layer] (channel sweep), or [layer][ratio]
    (initial)."""

    axes: dict
    total_nll: np.ndarray
    n_tokens: float
    chunks: int
    weighting: str  # "token_weighted" | "mean_of_means"
    wall_s: float = 0.0

    def ppl(self) -> np.ndarray:
        denom = self.n_tokens if self.weighting == "token_weighted" else max(self.chunks, 1)
        return np.exp(self.total_nll / max(denom, 1e-9))

    def to_json(self) -> dict:
        return {
            "axes": self.axes,
            "total_nll": self.total_nll.tolist(),
            "n_tokens": self.n_tokens,
            "chunks": self.chunks,
            "weighting": self.weighting,
            "wall_s": self.wall_s,
            "ppl": self.ppl().tolist(),
        }

    def table(self) -> str:
        """Human-readable PPL table: one row per (method, split layer), one
        column per ratio (or one column per layer for the channel sweep)."""
        ppl = self.ppl()
        lines = []
        if "ratios" in self.axes:
            ratios = self.axes["ratios"]
            layers = self.axes["layers_of_interest"]
            methods = self.axes.get("methods")
            header = ["method", "layer"] if methods else ["layer"]
            cols = header + [f"r={r}" for r in ratios]
            rows = []
            if methods:
                for m, method in enumerate(methods):
                    for l, layer in enumerate(layers):
                        rows.append([method, str(layer)]
                                    + [f"{v:.4g}" for v in ppl[m, l]])
            else:
                for l, layer in enumerate(layers):
                    rows.append([str(layer)] + [f"{v:.4g}" for v in ppl[l]])
        else:  # channel sweep: methods x layers
            cols = ["method"] + [f"layer {l}" for l in self.axes["layers_of_interest"]]
            rows = [[m] + [f"{v:.4g}" for v in ppl[i]]
                    for i, m in enumerate(self.axes["methods"])]
        widths = [max(len(c), *(len(r[i]) for r in rows)) if rows else len(c)
                  for i, c in enumerate(cols)]
        fmt = lambda vals: "  ".join(v.ljust(w) for v, w in zip(vals, widths))
        lines.append(fmt(cols))
        lines.append(fmt(["-" * w for w in widths]))
        lines.extend(fmt(r) for r in rows)
        lines.append(f"[{self.chunks} chunks, {self.n_tokens:.0f} scored tokens, "
                     f"{self.wall_s:.1f}s, weighting={self.weighting}]")
        return "\n".join(lines)


def _scoring_tail(chunk) -> int:
    """Scoring-tail length of one window: trg_len = num_loss_tokens + 1,
    clamped to the unembeddable positions."""
    return min(chunk.num_loss_tokens + 1, chunk.input_ids.shape[1] - 1)


def _group_arrays(group, device):
    """One window group -> (ids (W, S), targets (W, S), counts (W,), tail) on
    ``device``; the group's max tail bounds every member's scoring span."""
    ids = torch.from_numpy(np.concatenate([c.input_ids for c in group]).astype(np.int64))
    targets = torch.from_numpy(np.concatenate([c.target_ids for c in group]).astype(np.int64))
    counts = np.array([c.num_loss_tokens for c in group], np.float64)
    tail = max(c.num_loss_tokens + 1 for c in group)
    return ids.to(device), targets.to(device), counts, tail


def _iter_window_groups(token_ids, max_length: int, stride: int, *,
                        window_batch: int, start_chunk: int = 0,
                        max_count: Optional[int] = None, tail_of=None):
    """Yield groups of evaluation windows, one batched forward each.

    Only full-length windows are grouped (the short corpus-tail window runs
    alone); ``tail_of`` splits groups whose scoring-tail lengths differ
    (chunk 0 scores its whole window, and batching it with stride-tail
    chunks would widen every member's unembed). ``start_chunk`` skips resumed
    chunks; ``max_count`` caps the total yielded."""
    buffer: list = []
    yielded = 0
    for chunk in sliding_windows(token_ids, max_length, stride):
        if chunk.index < start_chunk:
            continue
        if max_count is not None and yielded + len(buffer) >= max_count:
            break
        if chunk.input_ids.shape[1] == max_length and window_batch > 1:
            if buffer and tail_of is not None and tail_of(chunk) != tail_of(buffer[0]):
                yield buffer
                yielded += len(buffer)
                buffer = []
            buffer.append(chunk)
            if len(buffer) == window_batch:
                yield buffer
                yielded += len(buffer)
                buffer = []
        else:
            if buffer:
                yield buffer
                yielded += len(buffer)
                buffer = []
            yield [chunk]
            yielded += 1
    if buffer:
        yield buffer


def _run_pipelined(groups, submit, drain):
    """Drive submit/drain one group apart: ``submit(group)`` enqueues device
    work without host syncs and returns a record; ``drain(record)`` does the
    host-side accumulation, so it overlaps the next group's device work."""
    inflight = None
    for group in groups:
        rec = submit(group)
        if inflight is not None:
            drain(inflight)
        inflight = rec
    if inflight is not None:
        drain(inflight)


def _load_checkpoint(path: Optional[str], axes: dict) -> Optional[dict]:
    """Load a resume checkpoint only if the SAME sweep configuration wrote it."""
    if path and os.path.exists(path):
        with open(path) as f:
            state = json.load(f)
        if state.get("axes") == json.loads(json.dumps(axes)):
            return state
        raise ValueError(
            f"checkpoint {path} was written by a different sweep configuration "
            f"({state.get('axes')} != {axes}); delete it or use a fresh output dir")
    return None


def _save_checkpoint_state(path: Optional[str], state: dict):
    """Atomic JSON checkpoint write (tmp + rename)."""
    if not path:
        return
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(state, f)
    os.replace(tmp, path)


class ResumableDriver:
    """The resumable-driver scaffold: axes-validated checkpoint load, atomic
    save, cumulative wall clock across resumes, and the ``checkpoint_every``
    trigger. ``state`` holds the loaded checkpoint (None on a fresh start)."""

    def __init__(self, checkpoint_path: Optional[str], axes: dict,
                 checkpoint_every: int):
        self.path, self.axes, self.every = checkpoint_path, axes, checkpoint_every
        self.state = _load_checkpoint(checkpoint_path, axes)
        loaded = self.state or {}
        self.prior_wall = loaded.get("wall_s", 0.0)
        self.start_chunk = loaded.get("next_chunk", 0)
        self.chunks = loaded.get("chunks", 0)
        self.next_chunk = self.start_chunk
        self._last_ckpt = self.chunks
        self._t0 = time.monotonic()

    def wall(self) -> float:
        """Cumulative seconds across every resumed run."""
        return self.prior_wall + time.monotonic() - self._t0

    def save(self, extra: dict):
        _save_checkpoint_state(self.path, {
            "next_chunk": self.next_chunk, "axes": self.axes,
            "chunks": self.chunks, "wall_s": self.wall(), **extra})

    def advance(self, group, count: Optional[int] = None) -> bool:
        """Account one drained window group -> True when a checkpoint is due."""
        self.chunks += len(group) if count is None else count
        self.next_chunk = group[-1].index + 1
        if self.chunks - self._last_ckpt >= self.every:
            self._last_ckpt = self.chunks
            return True
        return False

    def remaining(self, max_chunks: Optional[int]) -> Optional[int]:
        return None if max_chunks is None else max_chunks - self.chunks


def _emit(metrics_path: Optional[str], record: dict):
    if not metrics_path:
        return
    with open(metrics_path, "a") as f:
        f.write(json.dumps(record) + "\n")


def _run_accumulator_sweep(result: SweepResult, token_ids: np.ndarray, *,
                           max_length: int, stride: int, window_batch: int,
                           submit: Callable, accumulate: Callable,
                           checkpoint_path: Optional[str],
                           checkpoint_every: int,
                           metrics_path: Optional[str],
                           max_chunks: Optional[int],
                           device,
                           progress: Optional[Callable[[int], None]] = None,
                           emit_tokens: bool = False) -> SweepResult:
    """The sweep-driver loop shared by the token / initial / channel drivers:
    exact resume, atomic checkpoints, cumulative wall clock, pipelined
    submit/drain. ``submit(ids, targets, tail) -> pending`` enqueues one
    group's device work; ``accumulate(pending, counts)`` folds the drained
    results into ``result.total_nll``."""
    drv = ResumableDriver(checkpoint_path, result.axes, checkpoint_every)
    if drv.state is not None:
        result.total_nll = np.asarray(drv.state["total_nll"])
        result.n_tokens = drv.state["n_tokens"]
        result.chunks = drv.chunks

    def save():
        drv.save({"total_nll": result.total_nll.tolist(), "n_tokens": result.n_tokens})

    def submit_group(group):
        ids, targets, counts, tail = _group_arrays(group, device)
        with torch.inference_mode():
            return group, counts, submit(ids, targets, tail)

    def drain_group(rec):
        group, counts, pending = rec
        accumulate(pending, counts)
        result.n_tokens += counts.sum()
        due = drv.advance(group)
        result.chunks = drv.chunks
        if progress:
            progress(group[-1].index)
        if due:
            save()
            record = {"chunk": group[-1].index}
            if emit_tokens:
                record["n_tokens"] = result.n_tokens
            _emit(metrics_path, {**record, "ppl": result.ppl().tolist()})

    _run_pipelined(
        _iter_window_groups(token_ids, max_length, stride,
                            window_batch=window_batch,
                            start_chunk=drv.start_chunk,
                            max_count=drv.remaining(max_chunks),
                            tail_of=_scoring_tail),
        submit_group, drain_group)
    result.wall_s = drv.wall()
    save()
    final = {"final": True, "chunks": result.chunks}
    if emit_tokens:
        final["n_tokens"] = result.n_tokens
    _emit(metrics_path, {**final, "ppl": result.ppl().tolist(), "wall_s": result.wall_s})
    return result


def _nlls(x: torch.Tensor) -> np.ndarray:
    return x.double().cpu().numpy()


def run_token_sweep(
    cfg: ModelConfig,
    params: dict,
    token_ids: np.ndarray,
    *,
    methods: Sequence[str],
    layers_of_interest: Sequence[int],
    ratios: Sequence[float],
    max_length: int,
    stride: int,
    head_weights: Optional[np.ndarray] = None,
    codec: str = "int4_token_select",
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 1000,
    metrics_path: Optional[str] = None,
    max_chunks: Optional[int] = None,
    progress: Optional[Callable[[int], None]] = None,
    window_batch: int = 1,
    device="cuda",
) -> SweepResult:
    """The main (method x split-layer x ratio) token-selective sweep:
    token-weighted NLL, the token codec at the split layer, importance from
    the four attention methods. ``ratios`` are fractions (0..1).

    ``window_batch``: up to W full-length windows per forward (short tail
    windows run alone); each window keeps its own codec scales and token
    weighting. ``params`` move to ``device`` (a no-op when they are there)."""
    bad = [l for l in layers_of_interest if not 0 <= int(l) < cfg.num_layers]
    if bad:
        raise ValueError(f"layers_of_interest {bad} out of range for a "
                         f"{cfg.num_layers}-layer model")
    params = params_to(params, device=device)
    shape = (len(methods), len(layers_of_interest), len(ratios))
    result = SweepResult(
        axes={"methods": list(methods), "layers_of_interest": list(layers_of_interest),
              "ratios": list(ratios)},
        total_nll=np.zeros(shape), n_tokens=0.0, chunks=0, weighting="token_weighted")

    # weighted importance only reads stats rows <= the deepest cut
    n_stats = max(int(l) for l in layers_of_interest) + 1
    hw = (None if head_weights is None else
          torch.as_tensor(np.asarray(head_weights, np.float32)[:n_stats], device=device))
    # ratio == 0 is the fp baseline: method-independent for the rank codecs,
    # so it is the tail NLL of the stats forward's own full-depth continuation
    zero_idx = [i for i, r in enumerate(ratios) if float(r) == 0.0] \
        if codec in DEDUP_ZERO_CODECS else []
    nz_idx = [i for i in range(len(ratios)) if i not in zero_idx]
    nz_ratios = torch.tensor(np.asarray([ratios[i] for i in nz_idx], np.float32),
                             device=device)
    layer_key = tuple(int(l) for l in layers_of_interest)
    pos_of = {l: i for i, l in enumerate(sorted(set(layer_key)))}

    def submit(ids, targets, tail):
        """Enqueue one group's device work; returns device results."""
        # k per ratio, truncated in Python float64 like the reference's int(ratio * s)
        ks = [int(float(ratios[i]) * ids.shape[1]) for i in nz_idx]
        stats, hiddens, final = _stats_forward(cfg, params, ids, layer_key,
                                               want_final=bool(zero_idx))
        base = (nll_tail(cfg, params, final, targets, tail, per_example=True)
                if zero_idx else None)
        del final
        imp_all = torch.stack([importance_per_layer(stats, m, hw) for m in methods])
        pending = []  # (m_indices, l, ratio_indices, device_nlls)
        for l, layer in enumerate(layers_of_interest):
            h_l = hiddens[pos_of[int(layer)]]
            if zero_idx:
                pending.append((range(len(methods)), l, zero_idx, base[None]))
            if nz_idx:
                for m in range(len(methods)):
                    nlls = _suffix_sweep(cfg, params, int(layer), codec, tail, h_l,
                                         targets, imp_all[m, layer], nz_ratios, ks)
                    pending.append(([m], l, nz_idx, nlls))
        return pending

    def accumulate(pending, counts):
        for ms, l, r_idx, nlls in pending:
            contrib = _nlls(nlls) @ counts  # (R',)
            for m in ms:
                result.total_nll[m, l, r_idx] += contrib

    return _run_accumulator_sweep(
        result, token_ids, max_length=max_length, stride=stride,
        window_batch=window_batch, submit=submit, accumulate=accumulate,
        checkpoint_path=checkpoint_path, checkpoint_every=checkpoint_every,
        metrics_path=metrics_path, max_chunks=max_chunks, device=device,
        progress=progress, emit_tokens=True)


def run_initial_sweep(
    cfg: ModelConfig,
    params: dict,
    token_ids: np.ndarray,
    *,
    layers_of_interest: Sequence,
    ratios: Sequence[float],
    max_length: int,
    stride: int,
    quant_layer: int = 2,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 1000,
    metrics_path: Optional[str] = None,
    max_chunks: Optional[int] = None,
    window_batch: int = 1,
    device="cuda",
) -> SweepResult:
    """The Pythia "initial" experiment: ``layers_of_interest`` mixes layer
    ints with ``'aggregate upto 2'``, ``'maximum aggregation'`` and
    ``'upto ratio'`` (how the token ordering is built); quantization is always
    at ``quant_layer`` with the per-token affine int8 codec. ``ratios`` follow
    the 0..10 integer convention (fraction = 0.1 * ratio). Accumulation is
    the unweighted mean of per-chunk NLL means."""
    magic = {"aggregate upto 2", "maximum aggregation", "upto ratio"}
    bad = [l for l in layers_of_interest
           if l not in magic and not 0 <= int(l) < cfg.num_layers]
    if bad or not 0 <= quant_layer < cfg.num_layers:
        raise ValueError(f"layer specs {bad or [quant_layer]} out of range for a "
                         f"{cfg.num_layers}-layer model")
    params = params_to(params, device=device)
    shape = (len(layers_of_interest), len(ratios))
    result = SweepResult(
        axes={"layers_of_interest": [str(l) for l in layers_of_interest],
              "ratios": list(ratios)},
        total_nll=np.zeros(shape), n_tokens=0.0, chunks=0, weighting="mean_of_means")

    fracs = torch.tensor(np.asarray([0.1 * r for r in ratios], np.float32), device=device)
    # stats cover every referenced layer: int specs, the fixed layer-2
    # aggregations, and "upto ratio"'s quant-layer distribution
    n_stats = max([quant_layer, 2] + [int(l) for l in layers_of_interest
                                      if l not in magic]) + 1

    def submit(ids, targets, tail):
        ks = [int(0.1 * r * ids.shape[1]) for r in ratios]
        stats, hiddens, _ = _stats_forward(cfg, params, ids, (quant_layer,),
                                           stats_upto=n_stats - 1)
        reg = regular_importance(stats.col_mean)  # (L', W, S)
        pending = []
        for l, spec in enumerate(layers_of_interest):
            if spec == "aggregate upto 2":
                imp, codec = aggregate_upto(stats.col_mean, 2), "affine_int8_rank"
            elif spec == "maximum aggregation":
                imp, codec = maximum_aggregation(stats.col_mean, 2), "affine_int8_rank"
            elif spec == "upto ratio":
                imp, codec = reg[quant_layer], "affine_int8_top_rho"
            else:
                imp, codec = reg[int(spec)], "affine_int8_rank"
            pending.append((l, _suffix_sweep(cfg, params, quant_layer, codec, tail,
                                             hiddens[0], targets, imp, fracs, ks)))
        return pending

    def accumulate(pending, counts):
        for l, nlls in pending:
            result.total_nll[l] += _nlls(nlls).sum(axis=1)

    return _run_accumulator_sweep(
        result, token_ids, max_length=max_length, stride=stride,
        window_batch=window_batch, submit=submit, accumulate=accumulate,
        checkpoint_path=checkpoint_path, checkpoint_every=checkpoint_every,
        metrics_path=metrics_path, max_chunks=max_chunks, device=device)


def run_channel_sweep(
    cfg: ModelConfig,
    params: dict,
    token_ids: np.ndarray,
    *,
    methods: Sequence[str],
    layers_of_interest: Sequence[int],
    max_length: int,
    stride: int,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 1000,
    metrics_path: Optional[str] = None,
    max_chunks: Optional[int] = None,
    window_batch: int = 1,
    device="cuda",
) -> SweepResult:
    """Per-channel codec sweep: methods x layers, token-weighted NLL, no
    importance scoring; per-window channel scales."""
    bad = [l for l in layers_of_interest if not 0 <= int(l) < cfg.num_layers]
    if bad:
        raise ValueError(f"layers_of_interest {bad} out of range for a "
                         f"{cfg.num_layers}-layer model")
    params = params_to(params, device=device)
    shape = (len(methods), len(layers_of_interest))
    result = SweepResult(
        axes={"methods": list(methods), "layers_of_interest": list(layers_of_interest)},
        total_nll=np.zeros(shape), n_tokens=0.0, chunks=0, weighting="token_weighted")
    layer_key = tuple(int(l) for l in layers_of_interest)
    pos_of = {l: i for i, l in enumerate(sorted(set(layer_key)))}

    def submit(ids, targets, tail):
        hiddens = _plain_forward(cfg, params, ids, layer_key)
        return [(m, l, _suffix_channel(cfg, params, int(layer), method, tail,
                                       hiddens[pos_of[int(layer)]], targets))
                for m, method in enumerate(methods)
                for l, layer in enumerate(layers_of_interest)]

    def accumulate(pending, counts):
        for m, l, nlls in pending:
            result.total_nll[m, l] += _nlls(nlls) @ counts

    return _run_accumulator_sweep(
        result, token_ids, max_length=max_length, stride=stride,
        window_batch=window_batch, submit=submit, accumulate=accumulate,
        checkpoint_path=checkpoint_path, checkpoint_every=checkpoint_every,
        metrics_path=metrics_path, max_chunks=max_chunks, device=device)
