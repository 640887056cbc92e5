"""Sliding-window perplexity over the real split runtime (PyTorch counterpart
of the plain path of ``edgellm_tpu/eval/split_eval.py``).

Every window group's forward crosses each cut as a packed payload
(``parallel.SplitRuntime``); the result records the PPL beside the measured
bytes per token per hop. An axes-validated JSON checkpoint every
``checkpoint_every`` chunks gives an exact resume (identical PPL and byte
totals), with an append-only metrics stream, as in the sweep drivers. The
checkpoint axes are the reference's, so a checkpoint written by either
package resumes in the other.

:func:`run_kv_tier_eval` / :func:`run_kv_tier_sweep` measure the other
compression of a served stream, its KV pages at rest: every window is
teacher-forced through a paged pool one position at a time at one tier
("fp", "int8_per_channel", "int4_per_channel"), the ragged step that serving
runs (K13 / K14 on the card), and the PPL comes beside the page bytes.

The faulty link (``faults``, ``link_policy``, ``fec``, ``hedge``,
``link_health``) runs as the reference's: every hop sealed, corrupted per
the seeded rates (the chunk index is the fault step) and handled per the
policy, a codec ladder walked by a :class:`~..codecs.faults.TierController`
or a :class:`~..codecs.fec.LinkHealth` with one runtime per tier, built on
first demand; :func:`run_fault_sweep` draws the PPL / counter curve over a
fault rate.

Not ported yet (each raises naming its argument): survivability
(``deadline_s``, ``stage_failure``, ``recovery``), the micro-batch
``pipeline`` and the stage x seq runtime (``n_seq > 1``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..codecs.codec_kernels import SELECTIVE_EXCLUSION
from ..codecs.faults import FaultConfig, LinkPolicy, TierController
from ..codecs.fec import FECConfig, HedgeConfig, LinkHealth, LinkHealthConfig
from ..codecs.packing import get_wire_codec, selective_int4
from ..importance.metrics import importance_per_layer
from ..models.configs import ModelConfig
from ..models.paged_kv import (init_pool, init_quant_pool, kv_page_bytes, paged_decode_step,
                               paged_decode_step_quant, resolve_kv_codec)
from ..models.transformer import nll_from_logits, params_to, run_layers_from_ids
from ..parallel.split import NOT_PORTED_MSG, SplitConfig, SplitRuntime
from ..utils.clock import MONOTONIC
from .harness import (ResumableDriver, _emit, _group_arrays, _iter_window_groups,
                      _run_pipelined)


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


_UNPORTED_ARGS = ("deadline_s", "stage_failure", "recovery", "pipeline")


def _link_configs(faults, link_policy, fec, hedge, link_health) -> tuple:
    """The link's settings as the reference resolves them (dicts become
    their configs; ``link_policy.tiers`` a tuple), with its refusal of
    healing without an enabled ``faults`` config."""
    if isinstance(faults, dict):
        faults = FaultConfig(**faults)
    if isinstance(link_policy, dict):
        link_policy = dataclasses.replace(LinkPolicy(**link_policy),
                                          tiers=tuple(link_policy.get("tiers", ())))
    if isinstance(fec, dict):
        fec = FECConfig(**fec)
    if isinstance(hedge, dict):
        hedge = HedgeConfig(**hedge)
    if isinstance(link_health, dict):
        link_health = LinkHealthConfig(**link_health)
    fault_on = faults is not None and faults.enabled
    healing_requested = ((fec is not None and fec.enabled)
                         or (hedge is not None and hedge.enabled)
                         or link_health is not None)
    if healing_requested and not fault_on:
        raise ValueError(
            "fec/hedge/link_health require an enabled faults config — the "
            "link machinery only exists in the graph when a fault can fire")
    return faults, link_policy, fec, hedge, link_health, fault_on


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
    _clock=MONOTONIC,
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
    accounting, ``mesh`` and, with ``time_hops``, the per-hop times.

    ``faults`` (a :class:`~..codecs.faults.FaultConfig` or kwargs dict)
    turns the wire faulty, handled per ``link_policy`` (:class:`LinkPolicy`
    or dict); ``fec`` / ``hedge`` arm in-band XOR repair and hedged routes;
    ``link_health`` replaces the streak controller with the SLO tracker
    (``_clock`` its clock). All three need an enabled ``faults``. When
    ``link_policy.tiers`` names a ladder, the controller observes each group
    at drain time (under the two-deep submit pipeline a switch takes effect
    one group late). The result then also holds ``faults``,
    ``link_policy``, ``link_counters`` (summed over the tiers' runtimes),
    ``tier_ladder``, ``tier_switches``, ``final_tier``,
    ``degraded_chunks``, ``fec`` / ``hedge`` / ``link_health`` as given,
    and, beyond the reference's keys, ``link_by_tier``: each tier's codecs
    and counters (None for a tier never built), which say how often each
    tier's kernels ran."""
    given = dict(deadline_s=deadline_s, stage_failure=stage_failure, recovery=recovery,
                 pipeline=pipeline)
    for name in _UNPORTED_ARGS:
        if given[name] is not None:
            raise ValueError(f"run_split_eval {name} {NOT_PORTED_MSG}")
    if n_seq > 1:
        raise ValueError(f"n_seq > 1 (the stage x seq ring runtime) {NOT_PORTED_MSG}")
    faults, link_policy, fec, hedge, link_health, fault_on = _link_configs(
        faults, link_policy, fec, hedge, link_health)
    policy = link_policy if link_policy is not None else LinkPolicy()
    codecs = [parse_hop_codec(c) if isinstance(c, str) else c for c in hop_codecs]
    split = SplitConfig(cuts=tuple(cuts), hop_codecs=tuple(codecs))
    devices = [torch.device(device)] * split.n_stages
    params = params_to(params, device=devices[0])

    def _make_runtime(tier_codecs):
        return SplitRuntime(cfg, SplitConfig(cuts=split.cuts, hop_codecs=tuple(tier_codecs)),
                            devices, faults=faults, policy=link_policy, fec=fec, hedge=hedge)

    # tier 0 is the configured codec set; lower tiers swap EVERY hop to one
    # fallback codec (payload shapes change, hence separate runtimes; the
    # placement does not depend on the codec, so ``placed`` is shared)
    ladder = [list(codecs)]
    controller = None
    health = None
    if fault_on and policy.tiers:
        for name in policy.tiers:
            get_wire_codec(name)  # fail fast on a bad ladder entry
            ladder.append([name] * len(codecs))
    if link_health is not None:
        health = LinkHealth(len(ladder), link_health, clock=_clock)
    elif fault_on and policy.tiers:
        controller = TierController(len(ladder), policy.degrade_after, policy.recover_after)
    runtimes = {0: _make_runtime(ladder[0])}
    rt = runtimes[0]
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
    if fault_on:
        # a checkpoint written under one fault regime must not resume under
        # another (JSON round-trips lists, so tuples are listified here)
        axes["faults"] = dataclasses.asdict(faults)
        axes["link_policy"] = {**dataclasses.asdict(policy), "tiers": list(policy.tiers)}
        if fec is not None:
            axes["fec"] = dataclasses.asdict(fec)
        if hedge is not None:
            axes["hedge"] = dataclasses.asdict(hedge)
        if link_health is not None:
            axes["link_health"] = dataclasses.asdict(link_health)
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
    degraded_chunks = 0  # chunks that ran below tier 0
    tier_log: list = []  # (chunk_index, tier) at every controller switch

    def submit_group(group):
        n_real = len(group)
        s_unpadded = group[0].input_ids.shape[1]
        counts = [c.num_loss_tokens for c in group]
        ids = torch.from_numpy(np.concatenate([c.input_ids for c in group]).astype(np.int64))
        targets = torch.from_numpy(np.concatenate([c.target_ids for c in group]))
        ids = ids.to(devices[0])
        tier = health.tier if health is not None else (
            controller.tier if controller is not None else 0)
        if tier not in runtimes:  # built on first demand, kept thereafter
            runtimes[tier] = _make_runtime(ladder[tier])
        art = runtimes[tier]
        needs_t = [c.needs_importance for c in art.codecs]
        with torch.inference_mode():
            hop_imp = None
            if any(needs_t):
                imp = _importance(cfg, params, ids, importance_method, hw)  # (L, W, S)
                hop_imp = [(imp[cut] if len(group) > 1 else imp[cut, 0]) if need else None
                           for cut, need in zip(split.cuts, needs_t)]
            # the chunk index drives the fault stream: same seed => same
            # chunks corrupted, run after run (ignored without a link)
            logits = art.forward(placed, ids, hop_importance=hop_imp,
                                 fault_step=group[0].index)
            nlls = nll_from_logits(logits, targets.to(logits.device), per_example=True)
        chunk_counters = art._counter_accum[-1] if fault_on else None
        return (group, n_real, s_unpadded, counts, tuple(ids.shape), nlls, tier,
                chunk_counters, art)

    def drain_group(rec):
        nonlocal total_nll, n_tokens, fwd_tokens, real_fwd_tokens, degraded_chunks
        (group, n_real, s_unpadded, counts, (w, s_chunk), nlls, tier, chunk_counters,
         art) = rec
        total_nll += float(nlls.double().cpu().numpy() @ np.asarray(counts, np.float64))
        n_tokens += sum(counts)
        fwd_tokens += w * s_chunk
        real_fwd_tokens += n_real * s_unpadded
        key = (tier, w, s_chunk)
        if key not in bytes_cache:  # payloads are shape-determined
            bytes_cache[key] = art.hop_bytes(w, s_chunk)
        for i, b in enumerate(bytes_cache[key]):
            hop_bytes_total[i] += b
        if tier:
            degraded_chunks += 1
        if health is not None:
            prev = health.tier
            if health.observe(chunk_counters) != prev:
                tier_log.append((group[-1].index, health.tier))
        elif controller is not None:
            corrupted = any(int(np.asarray(chunk_counters[k]).sum())
                            for k in ("detected", "budget_dropped"))
            prev = controller.tier
            if controller.observe(corrupted) != prev:
                tier_log.append((group[-1].index, controller.tier))
        if rd.advance(group, count=n_real):
            save_checkpoint()
            rec_out = {
                "chunk": group[-1].index, "chunks": rd.chunks, "n_tokens": n_tokens,
                "ppl": float(np.exp(total_nll / max(n_tokens, 1e-9))),
                "hop_bytes_total": hop_bytes_total}
            if fault_on:
                rec_out["tier"] = tier
            if health is not None:
                rec_out["burn_rate"] = health.burn_rate
            _emit(metrics_path, rec_out)

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
    if fault_on:
        agg = None  # per-hop counters summed over every tier's runtime
        for r in runtimes.values():
            c = r.link_counters()
            if agg is None:
                agg = {k: v.copy() for k, v in c.items()}
            else:
                for k in agg:
                    agg[k] += c[k]
        result["faults"] = dataclasses.asdict(faults)
        result["link_policy"] = {**dataclasses.asdict(policy), "tiers": list(policy.tiers)}
        result["link_counters"] = {k: [int(x) for x in v] for k, v in agg.items()}
        result["tier_ladder"] = [[c if isinstance(c, str) else c.name for c in t]
                                 for t in ladder]
        result["tier_switches"] = [list(t) for t in tier_log]
        result["final_tier"] = (health.tier if health is not None
                                else controller.tier if controller is not None else 0)
        result["degraded_chunks"] = degraded_chunks
        if fec is not None:
            result["fec"] = dataclasses.asdict(fec)
        if hedge is not None:
            result["hedge"] = dataclasses.asdict(hedge)
        if health is not None:
            result["link_health"] = health.summary()
        result["link_by_tier"] = [
            None if t not in runtimes else
            {"hop_codecs": [c.name for c in runtimes[t].codecs],
             "counters": {k: [int(x) for x in v]
                          for k, v in runtimes[t].link_counters().items()}}
            for t in range(len(ladder))]
    if time_hops and rd.chunks:
        result["per_hop_ms"] = rt.time_hops(1, seq)
        result["per_decode_hop_ms"] = rt.time_decode_hops(1)
        result["per_hop_timing"] = [
            {"hop": s, "cut_layer": int(split.cuts[s]), "codec": rt.codecs[s].name,
             "forward_ms": result["per_hop_ms"][s],
             "decode_ms": result["per_decode_hop_ms"][s]}
            for s in range(len(split.cuts))]
    final_rec = {"final": True, "chunks": rd.chunks, "n_tokens": n_tokens,
                 "ppl": result["ppl"], "wall_s": wall,
                 "hop_bytes_total": hop_bytes_total,
                 "pad_fraction": result["pad_fraction"]}
    if fault_on:
        final_rec["link_counters"] = result["link_counters"]
        final_rec["degraded_chunks"] = degraded_chunks
        if health is not None:
            final_rec["burn_rate"] = health.burn_rate
    _emit(metrics_path, final_rec)
    return result


def run_fault_sweep(
    cfg: ModelConfig,
    params: dict,
    token_ids: np.ndarray,
    *,
    rates: Sequence[float],
    knob: str = "drop_rate",
    seed: int = 0,
    byte_budget: Optional[int] = None,
    link_policy=None,
    **eval_kwargs,
) -> list:
    """PPL / throughput / counter curve as a function of fault rate:
    :func:`run_split_eval` once per entry of ``rates``, with ``knob``
    (``"drop_rate"``, ``"bitflip_rate"`` or ``"scale_corrupt_rate"``) set on
    a fresh :class:`FaultConfig`. Rate 0 with no ``byte_budget`` runs the
    fault-free split, the sweep's exact baseline. Each result gains
    ``fault_knob`` / ``fault_rate``; the other kwargs pass through. The
    healing kwargs (``fec`` / ``hedge`` / ``link_health``) are withheld from
    fault-free points."""
    if knob not in ("drop_rate", "bitflip_rate", "scale_corrupt_rate"):
        raise ValueError(f"unknown fault knob {knob!r}")
    out = []
    for r in rates:
        fc = FaultConfig(**{knob: float(r)}, byte_budget=byte_budget, seed=seed)
        kw = eval_kwargs
        if not fc.enabled:
            kw = {k: v for k, v in eval_kwargs.items()
                  if k not in ("fec", "hedge", "link_health")}
        res = run_split_eval(cfg, params, token_ids, faults=fc if fc.enabled else None,
                             link_policy=link_policy, **kw)
        res["fault_knob"] = knob
        res["fault_rate"] = float(r)
        out.append(res)
    return out


def run_kv_tier_eval(
    cfg: ModelConfig,
    params: dict,
    token_ids: np.ndarray,
    *,
    kv_codec: str = "fp",
    max_length: int,
    stride: int,
    page_size: int = 16,
    window_batch: int = 4,
    max_chunks: Optional[int] = None,
    compute_dtype=None,
    metrics_path: Optional[str] = None,
    progress=None,
    device="cuda",
) -> dict:
    """Token-weighted sliding-window PPL with the KV cache held at rest in
    one ``kv_codec`` tier (``models.paged_kv.KV_PAGE_CODECS``), on
    ``device``.

    The windows, their grouping (``window_batch``, the short corpus tail
    alone) and the token weighting are the sweeps'. Each group of W windows
    of T tokens gets a fresh pool of ``1 + W * ceil(T / page_size)`` pages
    (page 0 the trash page; float32 pages on the fp tier) and is
    teacher-forced one position at a time through the ragged paged step
    (quantize on append, dequantize in the attention): the step at
    position s scores target s + 1, the shift ``nll_from_logits`` applies
    to whole-window logits. Returns the reference's keys: ``ppl``,
    ``total_nll``, ``n_tokens``, ``chunks``, ``wall_s``, ``page_size``,
    ``window_batch``, ``kv_page_bytes`` (one page across every layer, K +
    V, codes + scales) and ``kv_page_bytes_fp``."""
    codec = resolve_kv_codec(kv_codec)
    device = torch.device(device)
    params = params_to(params, device=device)
    total_nll, n_tokens, chunks = 0.0, 0.0, 0
    t0 = time.perf_counter()
    for group in _iter_window_groups(token_ids, max_length, stride, window_batch=window_batch,
                                     max_count=max_chunks):
        ids, targets, counts, _ = _group_arrays(group, device)
        w, t = ids.shape
        pps = -(-t // page_size)
        num_pages = 1 + w * pps  # page 0 stays the trash page
        pools = (init_quant_pool(cfg, num_pages, page_size, codec.name, device)
                 if codec.quantized else init_pool(cfg, num_pages, page_size, device=device))
        table = torch.arange(1, num_pages, dtype=torch.int32, device=device).reshape(w, pps)
        nll_sum = torch.zeros((w,), dtype=torch.float32, device=device)
        n_valid = torch.zeros((w,), dtype=torch.float32, device=device)
        with torch.inference_mode():
            for step in range(t - 1):
                lengths = torch.full((w,), step, dtype=torch.int32, device=device)
                if codec.quantized:
                    logits = paged_decode_step_quant(
                        cfg, params, *pools, table, lengths, ids[:, step],
                        kv_codec=codec.name, compute_dtype=compute_dtype)[0]
                else:
                    logits = paged_decode_step(cfg, params, *pools, table, lengths,
                                               ids[:, step], compute_dtype=compute_dtype)[0]
                logp = torch.log_softmax(logits.float(), dim=-1)
                tgt = targets[:, step + 1]
                valid = tgt != -100
                nll = -logp.gather(1, torch.where(valid, tgt, 0)[:, None])[:, 0]
                nll_sum += torch.where(valid, nll, 0.0)
                n_valid += valid.float()
        per_window = (nll_sum.double().cpu().numpy()
                      / np.maximum(n_valid.double().cpu().numpy(), 1.0))
        total_nll += float(per_window @ counts)
        n_tokens += float(counts.sum())
        chunks += len(group)
        if progress:
            progress(group[-1].index)
    wall = time.perf_counter() - t0
    result = {
        "kv_codec": codec.name,
        "ppl": float(np.exp(total_nll / max(n_tokens, 1e-9))),
        "total_nll": total_nll,
        "n_tokens": n_tokens,
        "chunks": chunks,
        "wall_s": wall,
        "page_size": page_size,
        "window_batch": window_batch,
        "kv_page_bytes": kv_page_bytes(cfg, page_size, kv_codec=codec.name),
        "kv_page_bytes_fp": kv_page_bytes(cfg, page_size),
    }
    _emit(metrics_path, {"final": True, **{k: result[k] for k in
                         ("kv_codec", "ppl", "n_tokens", "chunks", "wall_s", "kv_page_bytes")}})
    return result


def run_kv_tier_sweep(
    cfg: ModelConfig,
    params: dict,
    token_ids: np.ndarray,
    *,
    tiers: Sequence[str] = ("fp", "int8_per_channel", "int4_per_channel"),
    **eval_kwargs,
) -> list:
    """:func:`run_kv_tier_eval` once per entry of ``tiers``: the PPL /
    page-bytes curve over the KV-at-rest tiers. With "fp" among them every
    result gains ``ppl_delta_vs_fp``, its PPL relative to the fp tier's."""
    out = [run_kv_tier_eval(cfg, params, token_ids, kv_codec=t, **eval_kwargs) for t in tiers]
    base = next((r["ppl"] for r in out if r["kv_codec"] == "fp"), None)
    if base is not None:
        for r in out:
            r["ppl_delta_vs_fp"] = (r["ppl"] - base) / base
    return out
