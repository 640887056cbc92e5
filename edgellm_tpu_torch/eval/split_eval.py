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

Survivability: ``deadline_s`` arms a :class:`~..serve.recovery.Watchdog`
petted once a drained chunk; ``stage_failure`` marks a stage dark at a
chunk index, and the harness re-plans the split onto the surviving stages
(evenly spaced cuts, the first hop's codec on every new hop), rebuilds the
runtimes of every tier and carries the partial sums on; ``recovery``
(``replan``, ``max_failovers``) tunes it, and the result's ``recovery``
block accounts the byte totals per plan generation.

``pipeline`` (a :class:`~..parallel.split.PipelineConfig` or kwargs dict)
runs every group's forward through the µ-batch schedule: ``window_batch``
must split into its µ-batches, a partial tail group is padded up to a
multiple of M with repeated windows of zero loss weight, a batch-variant
tier on the degradation ladder is refused, and the result carries the
pipeline's summary.

Observability, as the reference places it: ``eval.*`` spans around the
group submits, drains, checkpoints, failovers and hop timings; the
sweep's wire bytes, fused-hop decisions and link / recovery counters
published into the global registry, and one ``split.hop`` span a cut.
Beyond the reference's: ``eval.call`` around the whole call, the
device-timed ``eval.importance`` and ``eval.nll`` of a group, and inside
the runtime's forward ``split.stage``, ``split.cross`` and
``split.unembed``.

``mesh`` (a ("stage", "data", "model") :class:`~..parallel.split.Mesh`,
``make_stage_mesh``) adds the data and model axes: ``window_batch`` must be
a multiple of the data axis, a partial tail group pads up to it, each data
group crosses every cut with its own payload, each stage runs in
``n_model`` tensor-parallel shards, and ``mesh`` in the result and the
resume axes holds the real sizes (a failover keeps the data and model
axes). On a mesh whose data axis spans processes
(``parallel.distributed``) each process runs its own data groups, the
per-example NLLs are all-gathered in group order, and only process 0
writes the checkpoint and the metrics stream.

``n_seq > 1`` runs the stage x seq runtime (``parallel/ring.py``
``SplitRingRuntime``): within every stage the sequence is ring-sharded into
``n_seq`` shards, which run in turn on the one device, and each shard
crosses every cut with its own payload; importance comes from the ring's
own statistics pass (``importance_sp``), a window is right-padded to a
multiple of ``n_seq`` with masked (-100) targets, and ``selective_int4``
specs resolve to the ring codec (``codecs/ring_codecs.py``, ``:global`` or
``:local``).
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
from ..codecs.ring_codecs import ring_selective_int4
from ..importance.metrics import importance_per_layer
from ..models.configs import ModelConfig
from ..models.paged_kv import (init_pool, init_quant_pool, kv_page_bytes, paged_decode_step,
                               paged_decode_step_quant, resolve_kv_codec)
from ..models.transformer import nll_from_logits, params_to, run_layers_from_ids
from ..obs.metrics import (get_registry, record_link_counters, record_link_health,
                           record_probe_decisions, record_recovery_counters, record_wire_bytes)
from ..obs.tracing import device_span
from ..obs.tracing import span as obs_span
from ..obs.tracing import tracing_enabled
from ..parallel.distributed import all_gather_rows
from ..parallel.ring import SplitRingRuntime, importance_sp
from ..parallel.split import (Mesh, PipelineConfig, SplitConfig, SplitRuntime, make_stage_mesh,
                              mesh_stage_devices)
from ..serve.recovery import (DecodeTimeout, RecoveryCounters, StageFailure, StageLostError,
                              Watchdog)
from ..utils.clock import MONOTONIC
from .harness import (ResumableDriver, _call_span, _emit, _group_arrays,
                      _iter_window_groups, _run_pipelined)


def parse_hop_codec(spec: str, n_seq: int = 1) -> object:
    """Codec spec -> registry name or ``WireCodec``.

    Plain names pass through (``"int4_per_token"``, ``"int8_per_token_pallas"``);
    token-selective specs are ``"selective_int4:<ratio>[:<high>][:<mode>]"``
    (e.g. ``"selective_int4:0.25:bf16"``). With ``n_seq > 1`` (the stage x
    seq runtime) they resolve to the ring codec
    (:func:`~..codecs.ring_codecs.ring_selective_int4`), ``mode`` "global"
    (the exact dense selection, the default) or "local" (shard-local
    selection, agreed scale)."""
    if not spec.startswith("selective_int4"):
        return spec
    parts = spec.split(":")
    ratio = float(parts[1]) if len(parts) > 1 else 0.25
    high = parts[2] if len(parts) > 2 else "bf16"
    mode = parts[3] if len(parts) > 3 else "global"
    if n_seq > 1:
        if parts[0].endswith("_pallas"):
            # no kernel ring variant exists; the plain ring codec in its
            # place would discard the explicit pin
            raise ValueError(
                f"{parts[0]!r} has no ring (n_seq > 1) implementation; use "
                f"'selective_int4:...' and let the backend choose")
        return ring_selective_int4(ratio, high, n_seq=n_seq, mode=mode)
    if len(parts) > 3:
        raise ValueError(f"selective mode {mode!r} only applies to the "
                         f"stage x seq runtime (n_seq > 1)")
    if parts[0].endswith("_pallas"):
        raise ValueError(f"'selective_int4_pallas' no longer exists: {SELECTIVE_EXCLUSION}")
    return selective_int4(ratio, high)


def _importance(cfg: ModelConfig, params: dict, ids: torch.Tensor, method: str,
                head_weights, n_seq: int) -> tuple:
    """The token importance of every attention layer, (L', B, S), and the
    row of a layer in it -> (importance, row): one full-depth forward that
    captures the attention statistics (the reference's ``_importance_fn``;
    ``AttnStats.row``), or with ``n_seq`` > 1 the ring's own statistics
    (:func:`~..parallel.ring.importance_sp`, whose rows are every layer's:
    the ring runs no convolution layer)."""
    if n_seq > 1:
        return (importance_sp(cfg, params, ids, n_seq, method, head_weights, device=ids.device),
                range(cfg.num_layers).index)
    with device_span("eval.importance", ids.device):
        _, aux = run_layers_from_ids(cfg, params, ids, capture_stats=True)
        return importance_per_layer(aux["stats"], method, head_weights), aux["stats"].row


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


@_call_span
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
    mesh: Optional[Mesh] = None,
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
    every stage on ``device`` (or on its slots of ``mesh``, whose data and
    model axes then apply: see the module note).

    ``hop_codecs`` entries are names, codec-spec strings or ``WireCodec``
    instances. Token-selective hops take their importance from
    ``importance_method``, computed at the hop's cut layer by a stats pass.
    ``window_batch``: up to W full-length windows per forward, with identical
    accumulation (per-row NLL weighting; token-selective hops carry per-row
    importance, so every window keeps its own ordering and scale).

    ``n_seq > 1`` selects the stage x seq runtime
    (:class:`~..parallel.ring.SplitRingRuntime`): the sequence ring-sharded
    within every stage (the shards in turn on ``device``), per-token or ring
    hop codecs, importance from :func:`~..parallel.ring.importance_sp`, and
    windows whose length ``n_seq`` does not divide right-padded with masked
    (-100) positions, which causal attention keeps from every scored one.
    The result's ``mesh`` then reads ``{"stage", "seq"}``, and the hops are
    timed at the padded length with no decode-hop timing (the ring runtime
    has no decode surface). ``stage_failure`` and ``pipeline`` need
    ``n_seq == 1``.

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
    tier's kernels ran, and under a pipeline ``microbatch_counters``: the
    (M, n_hops) rows of every tier's runtime, summing to ``link_counters``.

    ``deadline_s`` (a :class:`~..serve.recovery.Watchdog` petted once a
    drained chunk; ``_clock`` its clock), ``stage_failure`` (a
    :class:`~..serve.recovery.StageFailure` or dict; ``at_step`` a chunk
    index) and ``recovery`` (``{"replan", "max_failovers"}``) as in the
    reference: a lost stage re-plans the split onto the survivors and the
    same accumulation continues; the result then holds a ``recovery`` block
    (counters, plan generations, the re-planned cuts and codecs, the byte
    totals per post-failover generation) and the timed hops are the
    surviving plan's.

    ``pipeline`` (a :class:`~..parallel.split.PipelineConfig` or kwargs
    dict) runs the µ-batch schedule, as the reference does: a partial tail
    group is padded to a multiple of M (zero loss weight; the padding
    crosses the wire and counts in the pushed-token and byte totals), and
    the result gains ``pipeline``, the runtime's summary."""
    if isinstance(pipeline, dict):
        pipeline = PipelineConfig(**pipeline)
    pipelined = pipeline is not None and pipeline.enabled
    faults, link_policy, fec, hedge, link_health, fault_on = _link_configs(
        faults, link_policy, fec, hedge, link_health)
    if isinstance(stage_failure, dict):
        stage_failure = StageFailure(**stage_failure)
    if stage_failure is not None and n_seq > 1:
        raise ValueError(
            "stage_failure needs the plain split runtime: the stage x seq "
            "ring has no failover re-planning (n_seq must be 1)")
    recovery_on = deadline_s is not None or stage_failure is not None or bool(recovery)
    recovery = dict(recovery or {})
    unknown = set(recovery) - {"replan", "max_failovers"}
    if unknown:
        raise ValueError(f"unknown recovery key(s): {sorted(unknown)}")
    rec_replan = bool(recovery.get("replan", True))
    rec_max_failovers = int(recovery.get("max_failovers", 1))
    if rec_max_failovers < 1:
        raise ValueError("recovery.max_failovers must be >= 1")
    rcounters = RecoveryCounters()
    wd = Watchdog(deadline_s, clock=_clock) if deadline_s is not None else None
    policy = link_policy if link_policy is not None else LinkPolicy()
    codecs = [parse_hop_codec(c, n_seq) if isinstance(c, str) else c for c in hop_codecs]
    split = SplitConfig(cuts=tuple(cuts), hop_codecs=tuple(codecs))
    if mesh is not None and n_seq > 1:
        raise ValueError("n_seq composes the pipeline with sequence sharding only; "
                         "combining it with n_data/n_model is not supported")
    if mesh is None:
        mesh = make_stage_mesh(split.n_stages, device=device)
    dev0 = torch.device(device) if n_seq > 1 else mesh_stage_devices(mesh)[0]
    params = params_to(params, device=dev0)
    if pipelined and n_seq > 1:
        raise ValueError(
            "micro-batch pipelining composes with the plain split runtime "
            "only; the stage x seq ring runtime already overlaps its hops "
            "with the ring rotation — drop pipeline or set n_seq=1")

    def _make_runtime(tier_codecs):
        if n_seq > 1:
            return SplitRingRuntime(cfg, split.cuts, list(tier_codecs), n_seq, dev0,
                                    faults=faults, policy=link_policy, fec=fec, hedge=hedge)
        return SplitRuntime(cfg, SplitConfig(cuts=split.cuts, hop_codecs=tuple(tier_codecs)),
                            mesh, faults=faults, policy=link_policy, fec=fec, hedge=hedge,
                            pipeline=pipeline)

    # tier 0 is the configured codec set; lower tiers swap EVERY hop to one
    # fallback codec (payload shapes change, hence separate runtimes; the
    # placement does not depend on the codec, so ``placed`` is shared)
    ladder = [list(codecs)]
    controller = None
    health = None
    if fault_on and policy.tiers:
        for name in policy.tiers:
            c = get_wire_codec(name)  # fail fast on a bad ladder entry
            if pipelined and not c.batch_invariant and not c.needs_importance:
                raise ValueError(
                    f"degradation-ladder tier '{name}' couples batch rows; "
                    "its wire scales would change under the µ-batch split — "
                    "use batch-invariant fallback tiers or drop pipeline")
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
          torch.as_tensor(np.asarray(head_weights, np.float32), device=dev0))
    n_data = 1 if n_seq > 1 else mesh.shape["data"]
    if window_batch % n_data:
        raise ValueError(f"window_batch {window_batch} must be a multiple of the "
                         f"mesh data axis size {n_data}")
    if pipelined:
        # fail before the first chunk, not inside the first forward
        rt.pipeline.validate_batch(window_batch, "window_batch")
    # a partial tail group pads up to the data axis and the µ-batch grid
    # (n_data is 1 whenever pipelined: the runtime takes a stage-only mesh)
    group_pad = n_data * (rt.pipeline.num_microbatches if pipelined else 1)

    def mesh_dict() -> dict:
        return ({"stage": split.n_stages, "seq": n_seq} if n_seq > 1 else
                {k: int(v) for k, v in mesh.shape.items()})

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
        "mesh": mesh_dict(),
    }
    if pipelined:
        # the µ-batch count changes a chunk's wire traffic and counter
        # shapes: a plan axis, written only when pipelining is on, so an
        # unpipelined checkpoint keeps the reference's axes
        axes["num_microbatches"] = int(pipeline.num_microbatches)
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
    if stage_failure is not None:
        axes["stage_failure"] = dataclasses.asdict(stage_failure)
    rd = ResumableDriver(checkpoint_path, axes, checkpoint_every)
    total_nll, n_tokens = 0.0, 0.0
    fwd_tokens = 0  # every token pushed through the pipeline (pads included)
    real_fwd_tokens = 0  # the same, minus batch-pad windows and seq-pad positions
    hop_bytes_total = [0] * len(rt.codecs)  # measured per chunk, tail included
    if rd.state is not None:
        total_nll, n_tokens = rd.state["total_nll"], rd.state["n_tokens"]
        fwd_tokens = rd.state["fwd_tokens"]
        real_fwd_tokens = rd.state["real_fwd_tokens"]
        hop_bytes_total = list(rd.state["hop_bytes_total"])

    def save_checkpoint():
        with obs_span("eval.checkpoint_write"):
            rd.save({"total_nll": total_nll, "n_tokens": n_tokens,
                     "fwd_tokens": fwd_tokens, "real_fwd_tokens": real_fwd_tokens,
                     "hop_bytes_total": hop_bytes_total})

    bytes_cache: dict = {}
    degraded_chunks = 0  # chunks that ran below tier 0
    tier_log: list = []  # (chunk_index, tier) at every controller switch
    gen = 0  # plan generation: one more at every failover re-plan
    # generation 0 shares the checkpointed byte totals; a re-planned split
    # has another hop count, so its bytes accumulate per generation
    gen_bytes = {0: hop_bytes_total}
    sf_pending = stage_failure is not None

    def _eval_failover(lost: int, err: StageLostError):
        """Re-plan onto the survivors and swap every tier's runtime; the
        partial sums carry over (the PPL does not depend on the cut)."""
        if not rec_replan or rcounters.failovers >= rec_max_failovers:
            raise err  # the lost stage stays fatal
        rcounters.failovers += 1
        with obs_span("eval.failover", lost_stage=lost):
            _replan(lost)

    def _replan(lost: int):
        nonlocal split, placed, gen, ladder, mesh
        # the survivors keep the data and model axes
        mesh = Mesh(np.delete(mesh.devices, lost, axis=0), mesh.axis_names)
        split = split.replan(cfg.num_layers, mesh.shape["stage"])
        rcounters.replans += 1
        ladder = [list(split.hop_codecs)]
        if controller is not None or health is not None:
            for name in policy.tiers:
                ladder.append([name] * len(split.hop_codecs))
        runtimes.clear()
        runtimes[0] = _make_runtime(ladder[0])
        placed = runtimes[0].place_params(params)
        gen += 1
        gen_bytes[gen] = [0] * len(split.hop_codecs)

    def current_tier() -> int:
        return health.tier if health is not None else (
            controller.tier if controller is not None else 0)

    def submit_group(group):
        nonlocal sf_pending
        n_real = len(group)
        s_unpadded = group[0].input_ids.shape[1]
        counts = [c.num_loss_tokens for c in group]
        # pad a partial group up to the µ-batch grid with repeated windows;
        # their loss weight is zero
        while len(group) % group_pad:
            group = group + [group[-1]]
            counts = counts + [0]
        ids = np.concatenate([c.input_ids for c in group]).astype(np.int64)
        targets = np.concatenate([c.target_ids for c in group])
        if n_seq > 1 and ids.shape[1] % n_seq:
            # right-pad to a shardable length; the padded positions are
            # masked (-100) and, under causal attention, unseen by scored ones
            pad = n_seq - ids.shape[1] % n_seq
            ids = np.pad(ids, ((0, 0), (0, pad)))
            targets = np.pad(targets, ((0, 0), (0, pad)), constant_values=-100)
        ids, targets = torch.from_numpy(ids).to(dev0), torch.from_numpy(targets)
        if sf_pending and group[0].index >= stage_failure.at_step:
            sf_pending = False
            for r in runtimes.values():
                r.mark_stage_lost(stage_failure.stage)
        tier = current_tier()

        def _forward():
            if tier not in runtimes:  # built on first demand, kept thereafter
                runtimes[tier] = _make_runtime(ladder[tier])
            art = runtimes[tier]
            needs_t = [c.needs_importance for c in art.codecs]
            hop_imp = None
            if any(needs_t):
                imp, row = _importance(cfg, params, ids, importance_method, hw, n_seq)
                hop_imp = [(imp[row(cut)] if len(group) > 1 else imp[row(cut), 0])
                           if need else None for cut, need in zip(split.cuts, needs_t)]
            # the chunk index drives the fault stream: same seed => same
            # chunks corrupted, run after run (ignored without a link)
            return art, art.forward(placed, ids, hop_importance=hop_imp,
                                    fault_step=group[0].index)

        with torch.inference_mode():
            try:
                art, logits = _forward()
            except StageLostError as e:
                _eval_failover(e.stage, e)
                art, logits = _forward()  # the same chunk on the re-planned split
            # on a mesh whose data axis spans processes the logits are this
            # process's groups' rows
            targets = targets[_local_rows(art, targets.shape[0])]
            with device_span("eval.nll", logits.device):
                nlls = nll_from_logits(logits, targets.to(logits.device), per_example=True)
        chunk_counters = art._counter_accum[-1] if fault_on else None
        return (group, n_real, s_unpadded, counts, tuple(ids.shape), nlls, tier,
                chunk_counters, art, gen)

    def drain_group(rec):
        nonlocal total_nll, n_tokens, fwd_tokens, real_fwd_tokens, degraded_chunks
        (group, n_real, s_unpadded, counts, (w, s_chunk), nlls, tier, chunk_counters,
         art, g) = rec
        # the per-example NLLs of every process's data groups, in group order
        # (the reference's fetch_global)
        nlls = nlls.double().cpu().numpy()
        if getattr(art, "spans_processes", False):
            nlls = all_gather_rows(nlls)
        total_nll += float(nlls @ np.asarray(counts, np.float64))
        n_tokens += sum(counts)
        fwd_tokens += w * s_chunk
        real_fwd_tokens += n_real * s_unpadded
        key = (g, tier, w, s_chunk)
        if key not in bytes_cache:  # payloads are shape-determined
            bytes_cache[key] = art.hop_bytes(w, s_chunk)
        for i, b in enumerate(bytes_cache[key]):
            gen_bytes[g][i] += b
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
        if wd is not None:
            # pet the dog once a drained chunk; a stall past the deadline
            # writes a best-effort resume checkpoint and raises typed
            try:
                wd.check(save_checkpoint, what="eval chunk")
            except DecodeTimeout:
                rcounters.watchdog_fires += 1
                raise

    _run_pipelined(
        _iter_window_groups(token_ids, max_length, stride, window_batch=window_batch,
                            start_chunk=rd.start_chunk,
                            max_count=rd.remaining(max_chunks)),
        submit_group, drain_group, dev0, submit_attrs=lambda: {"tier": current_tier()})
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
        "mesh": mesh_dict(),
    }
    if fault_on:
        agg = None  # per-hop counters summed over every tier's runtime
        for r in runtimes.values():
            c = r.link_counters()
            if c is None:
                continue
            if agg is None:
                agg = {k: v.copy() for k, v in c.items()}
            else:
                for k in agg:
                    agg[k] += c[k]
        result["faults"] = dataclasses.asdict(faults)
        result["link_policy"] = {**dataclasses.asdict(policy), "tiers": list(policy.tiers)}
        result["link_counters"] = {k: [int(x) for x in v] for k, v in (agg or {}).items()}
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
        if pipelined:
            # beyond the reference's keys: the per-µ-batch rows of every
            # tier's pipelined forwards, {name: (M, n_hops)}, summing to
            # link_counters
            mb = [r.microbatch_counters() for r in runtimes.values()]
            result["microbatch_counters"] = {
                k: sum(np.asarray(c[k]) for c in mb).tolist() for k in mb[0]}
        result["link_by_tier"] = [
            None if t not in runtimes else
            {"hop_codecs": [c.name for c in runtimes[t].codecs],
             "counters": {k: [int(x) for x in v]
                          for k, v in runtimes[t].link_counters().items()}}
            for t in range(len(ladder))]
    if recovery_on:
        rec_block = {"deadline_s": deadline_s,
                     "stage_failure": (dataclasses.asdict(stage_failure)
                                       if stage_failure is not None else None),
                     "counters": rcounters.as_dict(), "plan_generations": gen + 1}
        if rcounters.failovers:
            rec_block["replanned_cuts"] = list(split.cuts)
            rec_block["failover_hop_codecs"] = [c.name for c in runtimes[0].codecs]
            rec_block["failover_hop_bytes_total"] = {str(g): list(b)
                                                     for g, b in gen_bytes.items() if g > 0}
            rec_block["failover_mesh"] = mesh_dict()
        result["recovery"] = rec_block
    if pipelined:
        result["pipeline"] = rt.pipeline_summary()
    if time_hops and rd.chunks:
        # the padded length the ring's hops move; after a failover, the
        # boundary that finished the run
        t_seq = seq + (-seq) % n_seq
        timed_rt = runtimes[0] if rcounters.failovers else rt
        timed_cuts = list(timed_rt.split.cuts)
        with obs_span("eval.time_hops", seq=t_seq):
            result["per_hop_ms"] = timed_rt.time_hops(1, t_seq)
        if n_seq == 1:  # the ring runtime is a whole-window forward: no decode hop
            with obs_span("eval.time_decode_hops"):
                result["per_decode_hop_ms"] = timed_rt.time_decode_hops(1)
        result["per_hop_timing"] = [
            {"hop": s, "cut_layer": int(timed_cuts[s]), "codec": timed_rt.codecs[s].name,
             "forward_ms": result["per_hop_ms"][s],
             **({"decode_ms": result["per_decode_hop_ms"][s]}
                if "per_decode_hop_ms" in result else {})}
            for s in range(len(timed_cuts))]
    # this sweep's totals into the global registry (no-ops with
    # observability off): wire bytes, the fused-hop decisions, the link and
    # recovery counters, and one attribution span a cut
    record_wire_bytes(hop_bytes_total, kind="eval_forward")
    final_rt = runtimes[0] if recovery_on and rcounters.failovers else rt
    if get_registry().enabled and n_seq == 1:  # the ring's hops never fuse
        record_probe_decisions(final_rt.wire_summary(1, seq))
    if fault_on:
        record_link_counters(result["link_counters"])
        if health is not None:
            record_link_health(result["link_health"])
    if recovery_on:
        record_recovery_counters(rcounters)
    if tracing_enabled() and n_seq == 1:
        from ..serve.decode import _emit_hop_spans

        _emit_hop_spans(final_rt, result.get("link_counters"), list(hop_bytes_total),
                        link_tier=getattr(health, "tier", None), chunks=int(rd.chunks))
    final_rec = {"final": True, "chunks": rd.chunks, "n_tokens": n_tokens,
                 "ppl": result["ppl"], "wall_s": wall,
                 "hop_bytes_total": hop_bytes_total,
                 "pad_fraction": result["pad_fraction"]}
    if fault_on:
        final_rec["link_counters"] = result["link_counters"]
        final_rec["degraded_chunks"] = degraded_chunks
        if health is not None:
            final_rec["burn_rate"] = health.burn_rate
    if recovery_on:
        final_rec["failovers"] = rcounters.failovers
    _emit(metrics_path, final_rec)
    return result


def _local_rows(rt, batch: int):
    """The batch rows ``rt.forward`` returns: every row, or this process's
    data groups' on a mesh whose data axis spans processes."""
    if not getattr(rt, "spans_processes", False):
        return slice(None)
    rows = batch // rt.n_data
    return torch.cat([torch.arange(g * rows, (g + 1) * rows) for g in rt.data_groups])


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
