"""Pipeline-split forward with packed boundary transfers (PyTorch counterpart
of the plain path of ``edgellm_tpu/parallel/split.py``).

The model is cut after each layer of ``cuts``. Stage i owns the layers
between two cuts and runs on its own torch device (one card holds every
stage here: each stage is ``cuda:0``). At each cut the boundary activation is
ENCODED to a packed payload on the stage's device, every payload leaf is
COPIED to the next stage's device (a real copy, never an alias), and the copy
is DECODED there. Bytes per token are measured from those leaves. A fused hop
(``codecs/fused_hop.py``, planned once per cut at construction) crosses the
cut as one sealed wire buffer instead, or through kernel K8.

Where the reference runs one SPMD program over a ("stage", "data", "model")
mesh, padding every stage to equal depth with masked zero layers, each stage
here owns only its own layer slice and the stages run in order. The dtype
flow is the reference's: its ``where(idx == s + 1, decode(moved), hidden)``
promotes a bf16 hidden to float32 at a separate hop, so every later stage
computes in float32 (its bf16 weights promoted, which ``place_params`` does
once by holding those stages' weights in float32). A fused hop returns the
hidden's own dtype, so the stages after a chain of fused hops keep it.

Incremental decode (``prefill_decode``, ``decode_step``, ``verify_step``):
each stage keeps its own layers' KV cache on its own device, one
(layers_of_stage, B, capacity, KV, hd) K and V tensor, and only the (B, 1, D)
hidden of a decode step (the (B, k, D) block of a verify burst) crosses a
cut, through the same hops as the forward. Every stage's cache holds the
dtype of the embedding output, as the reference's one stacked cache does: a
float32 stage behind a separate hop rounds its K/V rows as it writes them.

Paged decode (``init_paged_pool``, ``adopt_paged*``, ``copy_paged_pages``,
``gather_paged*``, ``decode_step_paged``): the continuous batcher's pages,
per stage. Each stage keeps one contiguous pool of its own layers,
(layers_of_stage, num_pages, page_size, KV, hd) K and V in the pool dtype
(codes plus fp32 per-row scales on a quantized tier), so every layer's page
view starts 16-byte aligned for K13 / K14; page 0 is the trash page and
pages never cross a cut. The host's ``PagedKVCache(materialize=False)``
keeps the page table. A ragged step runs every stage's layers through
``models.paged_kv.run_layers_paged`` and moves one (max_slots, 1, D) hidden
across each cut through ``run_pipeline_stages``, as ``decode_step`` does.
The payloads that leave the runtime (``gather_paged*``, and those
``adopt_paged_rows*`` take) keep the reference's (n_stages, stage_size, n,
KV, hd) layout, with zero rows for the layers that pad a shorter stage.

The faulty link (``faults``, ``policy``, ``fec``, ``hedge``): with an
enabled :class:`~..codecs.faults.FaultConfig` the runtime builds a
:class:`~..codecs.faults.FaultyLink`, and every hop of :meth:`forward`
goes through its seal / inject / verify / retry protocol (FEC and hedged
routes with ``fec`` / ``hedge``), keyed by ``fold_in(key(faults.seed),
fault_step)``; the per-hop counters accumulate on the runtime
(:meth:`link_counters`). An active link owns the hop, so no hop fuses.
The decode paths take the link too, each keyed as the reference keys it:
``prefill_decode`` by ``fold_in(fold_in(key(seed), 0x9EF1), fault_step)``,
``decode_step`` and ``verify_step`` by ``fold_in(fold_in(key(seed),
0x57E9), fill level before the write)`` and ``decode_step_paged`` by the
deepest slot's length in place of the fill level.

Stage loss (``mark_stage_lost``): every entry point raises the typed
:class:`~..serve.recovery.StageLostError` until the caller fails over to a
re-planned runtime (``SplitConfig.replan``). ``cache_state`` /
``load_cache_state`` move a decode cache to and from the host in the
reference's padded (n_stages, stage_size, B, capacity, KV, hd) layout, the
form a :class:`~..serve.recovery.DecodeCheckpoint` stores.

The µ-batch pipeline (``pipeline=PipelineConfig(num_microbatches=M)``):
``forward``, ``decode_step`` and ``decode_step_paged`` split the batch
into M contiguous row groups and run the reference's fill / steady / drain
schedule (:func:`run_pipeline_stages_microbatched`): at unroll step t
stage s runs µ-batch t - s, then the in-flight hops cross in reversed cut
order. The stages share one card and run in turn, so the fill and drain
steps, which the reference computes and masks, are never run; each
µ-batch flows through the sequential path's math, and the logits equal the
sequential run's. Under a link µ-batch m draws ``fold_in(key, m)`` and
bumps its own counter row (:meth:`SplitRuntime.microbatch_counters`).
``prefill_decode`` and ``verify_step`` stay sequential, as in the
reference.

The stage x seq runtime (``parallel/ring.py``) shares the hop protocol:
its stage activation is the list of its sequence shards, and
:func:`run_pipeline_stages` crosses each cut shard by shard
(:func:`_cross_shards`), each with its own payload and fault key.

The "data" and "model" mesh axes (``n_data``, ``n_model``, or a
:class:`Mesh` from :func:`make_stage_mesh`): the reference lays them out as
devices of its mesh; on one card every slot is the card, and the data groups
and model shards run in turn, as the ring's sequence shards do. ``forward``
cuts the batch into ``n_data`` contiguous row groups; each group runs the
whole stage chain and crosses every cut with its own payload (its rows of a
per-row importance with it, its own fault masks at its own shape from the
same key) and the groups' logits are joined in group order. Under the link
the runtime keeps its first data group's counters: the reference's leave
its shard_map through ``out_specs=P()``, which hands a process one slot's,
and every group draws the same masks. With ``n_model`` > 1 each stage's layers are
cut into ``n_model`` shards each (``models.transformer.tp_shard_layers``,
the reference's ``_TP_COL_SPLIT`` / ``_TP_ROW_SPLIT``): a shard computes
q / k / v over its head-contiguous columns, attends over its local heads
(K-attn on the card) and multiplies by its rows of ``wo``; the partial
products are summed in shard order, the reference's ``psum``
(``run_layers_tp``). The hidden the shards sum is the full activation, so
a cut crosses it once a data group: the bytes the reference replicates over
the model axis. On a mesh whose data axis spans processes
(``parallel.distributed.make_multihost_stage_mesh``) ``forward`` runs this
process's groups and returns their rows. Decode and the µ-batch pipeline
take a stage-only mesh, as in the reference.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..codecs.codec_kernels import pallas_variant
from ..codecs.faults import FaultyLink, LinkPolicy, fault_key, fold, sum_counters
from ..codecs.fused_hop import fused_hop, fused_hop_plan
from ..codecs.packing import WireCodec, get_wire_codec
from ..codecs.ring_codecs import RingWireCodec
from ..codecs.wire_format import cross_cut
from ..lint import graph_contract
from ..lint.contracts import hop_launches
from ..models.configs import ModelConfig
from ..models.flash_attention import dequantize_kv_rows, quantize_kv_rows
from ..models.paged_kv import (KVTierMismatchError, _host, _rows_get, _rows_set,
                               resolve_kv_codec, run_layers_paged)
from ..models.transformer import (apply_rotary, block_decode, block_verify, embed,
                                  layer_list, made_once, precompute_rope, run_layers,
                                  run_layers_tp, tp_shard_layers, unembed)
from ..obs.tracing import device_span
from ..serve.recovery import StageLostError

#: the reference's fold of the fault key for a split prefill, and for a
#: decode, verify or paged step
PREFILL_FAULT_FOLD, STEP_FAULT_FOLD = 0x9EF1, 0x57E9


def _split_launches(ctx: dict, attention=None) -> dict:
    """The kernels of one split call at lint geometry: ``attention`` once a
    layer a µ-batch, each cut's codec kernels once an encode and a decode
    a µ-batch (``ctx``: layers, micro, codecs)."""
    m = ctx.get("micro", 1)
    out = {attention: m * ctx["layers"]} if attention else {}
    out.update(hop_launches(ctx["codecs"], encodes=m, decodes=m))
    return out


def _hop_contract(name: str, attention=None, in_place: bool = False):
    """One split entry point's contract: the payload leaves, dtypes and
    bytes the driver measured from the codec registry cross the cuts, the
    caches (``in_place``) stay in place, and the kernels launch as
    :func:`_split_launches` counts."""
    return graph_contract(
        name, hops=lambda ctx: ctx["hops"],
        wire_dtypes=lambda ctx: ctx["wire_dtypes"],
        wire_bytes=lambda ctx: ctx["wire_bytes"],
        in_place=(lambda ctx: ctx.get("in_place_min", 2)) if in_place else 0,
        launches=lambda ctx: _split_launches(ctx, attention))


class Mesh:
    """A named device grid, the counterpart of ``jax.sharding.Mesh``:
    ``devices`` an object array whose axes ``axis_names`` name, each slot a
    torch device or a :class:`~.distributed.DeviceSlot` (whose ``device``
    is the process's own card); ``shape`` the {axis: size} dict."""

    def __init__(self, devices, axis_names: Sequence[str]):
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"a {self.devices.ndim}-d device grid for axes {self.axis_names}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))


def slot_device(slot) -> torch.device:
    """The torch device a mesh slot runs on."""
    return torch.device(getattr(slot, "device", slot))


def slot_is_local(slot) -> bool:
    """True when this process runs the slot (a plain device always is)."""
    from .distributed import process_index

    return getattr(slot, "process_index", process_index()) == process_index()


def mesh_stage_devices(mesh: Mesh) -> list:
    """Each stage's torch device on a ("stage", "data", "model") mesh: the
    data groups and model shards of a stage run in turn on it, so this
    process's slots of a stage must be one device."""
    out = []
    for s, row in enumerate(mesh.devices):
        local = {slot_device(x) for x in row.ravel() if slot_is_local(x)}
        if len(local) != 1:
            raise ValueError(f"stage {s}'s slots of this process are on {local or 'no device'}: "
                             f"its data groups and model shards run in turn on one device")
        out.append(local.pop())
    return out


def make_stage_mesh(n_stages: int, n_data: int = 1, n_model: int = 1,
                    devices=None, device="cuda") -> Mesh:
    """A ("stage", "data", "model") mesh from the first
    n_stages * n_data * n_model of ``devices``; by default every slot is
    ``device`` (on one card the slots run in turn)."""
    need = n_stages * n_data * n_model
    devices = np.asarray([torch.device(d) for d in ([device] * need if devices is None
                                                     else devices)], dtype=object)
    if devices.size < need:
        raise ValueError(f"need {need} devices, have {devices.size}")
    return Mesh(devices.reshape(-1)[:need].reshape(n_stages, n_data, n_model),
                ("stage", "data", "model"))


def apply_default_codec_backend(codecs: list, device="cuda") -> list:
    """Resolve hop-codec specs (names or ``WireCodec`` instances) to the
    backend's implementation: on a CUDA device the hand-written kernel twin of
    every codec that has one; on the CPU the plain codecs, as the reference
    keeps its plain codecs off the TPU. Explicit ``*_pallas`` names are always
    honoured."""
    codecs = [c if isinstance(c, WireCodec) else get_wire_codec(c) for c in codecs]
    if torch.device(device).type == "cuda":
        return [pallas_variant(c) or c for c in codecs]
    return codecs


def _encode(codec: WireCodec, hidden, imp):
    return codec.encode(hidden, imp) if codec.needs_importance else codec.encode(hidden)


def _hop(codec: WireCodec, hidden: torch.Tensor, imp, dst) -> torch.Tensor:
    """Encode on ``hidden``'s device, copy every payload leaf to ``dst``,
    decode the copy there (float32)."""
    payload = _encode(codec, hidden, imp)
    moved = {k: cross_cut(v, dst) for k, v in payload.items()}
    return codec.decode(moved)


def run_pipeline_stages(n_stages: int, codecs: list, run_stage, hidden,
                        hop_imps=None, devices: Optional[Sequence] = None,
                        fused_plans: Optional[Sequence] = None, link=None, fault_key=None):
    """Run ``run_stage(s, hidden)`` for every stage in order, crossing each
    cut as encode -> copy to ``devices[s + 1]`` -> decode. After a cut the
    hidden takes the promotion of its dtype and the decoded float32, as the
    reference's select does. ``fused_plans`` (one ``FusedHopPlan`` or None
    per cut) routes a hop through :func:`~..codecs.fused_hop.fused_hop`
    instead, which keeps the hidden's dtype.

    ``link`` (a :class:`~..codecs.faults.FaultyLink`) reroutes every hop
    through the faulty-wire protocol keyed by ``fault_key``; the return
    value then becomes ``(out, counters)``, this call's per-hop counters.

    ``hidden`` may be the list of a stage x seq activation's sequence shards
    (``parallel/ring.py``): ``run_stage`` then takes and returns the list,
    ``hop_imps[s]`` holds the shards' importance slices, and every shard
    crosses each cut with its own payload (:func:`_cross_shards`)."""
    if devices is None:
        dev = hidden[0].device if isinstance(hidden, list) else hidden.device
        devices = [dev] * n_stages
    counters = link.init_counters(n_stages - 1) if link is not None else None
    for s in range(n_stages):
        with device_span("split.stage", devices[s], stage=s):
            hidden = run_stage(s, hidden)
        if s < n_stages - 1:
            imp = hop_imps[s] if codecs[s].needs_importance else None
            hidden = _cross(s, codecs[s], hidden, imp, devices[s + 1], fused_plans, link,
                            fault_key, counters)
    if link is None:
        return hidden
    return hidden, counters


def _cross(s: int, codec: WireCodec, hidden, imp, dst, fused_plans, link, key, counters):
    """Cut ``s`` crossed once, inside a ``split.cross`` span timed on the
    sending device's stream: by the sequence shards of a stage x seq
    activation (:func:`_cross_shards`), else :func:`_cross_one`."""
    src = hidden[0].device if isinstance(hidden, list) else hidden.device
    with device_span("split.cross", src, hop=s, codec=codec.name):
        if isinstance(hidden, list):
            return _cross_shards(s, codec, hidden, imp, dst, link, key, counters)
        return _cross_one(s, codec, hidden, imp, dst, fused_plans, link, key, counters)


def _cross_one(s: int, codec: WireCodec, hidden, imp, dst, fused_plans, link, key, counters):
    """One activation across cut ``s``: through the faulty link (keyed by
    ``key``, bumping ``counters`` in place), the cut's fused plan, or the
    separate hop, whose float32 decode the hidden's dtype promotes as the
    reference's select does."""
    if link is not None:
        return link.hop(codec, hidden, s, dst, key, counters, hop_imp=imp)
    if fused_plans is not None and fused_plans[s] is not None:
        return fused_hop(fused_plans[s], codec, hidden, dst)
    decoded = _hop(codec, hidden, imp, dst)
    return decoded.to(torch.promote_types(decoded.dtype, hidden.dtype))


def _sent(codec: WireCodec, payload: dict) -> WireCodec:
    """``codec`` whose encode hands back ``payload``, a shard's payload
    encoded already: the hop protocols take it as they take any encode."""
    return dataclasses.replace(codec, encode=lambda *_: payload)


def _cross_shards(s: int, codec: WireCodec, shards: list, imps, dst, link, key, counters):
    """Cut ``s`` crossed by the sequence shards of a stage x seq activation:
    a ring codec encodes every shard at once (its selection and scale agreed
    across them), any other codec each shard alone; then each shard's
    payload crosses as a separate hop would, under ``link`` keyed by
    ``fold_in(key, shard)`` with the counters bumped for every shard."""
    if isinstance(codec, RingWireCodec):
        payloads = codec.encode(shards, imps)
    else:
        payloads = [_encode(codec, h, None if imps is None else imps[i])
                    for i, h in enumerate(shards)]
    return [_cross_one(s, _sent(codec, payload), h, None, dst, None, link,
                       None if link is None else fold(key, i), counters)
            for i, (h, payload) in enumerate(zip(shards, payloads))]


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Micro-batch pipelining of the stage unroll.

    ``num_microbatches`` (M): the batch is split into M contiguous row
    groups and the stages run a GPipe-style fill / steady / drain schedule
    of M + n_stages - 1 unroll steps, so in steady state every stage has a
    different µ-batch while the quantized boundary activations of the
    others are on the wire. M == 1 is the disabled configuration: the
    runtime runs the sequential unroll.

    The schedule keeps token identity with the sequential path at any M:
    each µ-batch flows through the same per-stage math and the same per-cut
    codec. That holds only when codecs treat batch rows independently
    (``WireCodec.batch_invariant``), which :class:`SplitRuntime` checks at
    construction.
    """

    num_microbatches: int = 1

    def __post_init__(self):
        if self.num_microbatches < 1:
            raise ValueError(
                f"num_microbatches must be >= 1, got {self.num_microbatches}")

    @property
    def enabled(self) -> bool:
        return self.num_microbatches > 1

    def validate_batch(self, batch: int, what: str = "batch") -> int:
        """Check ``batch`` splits evenly into µ-batches; return rows per
        µ-batch."""
        m = self.num_microbatches
        if batch < m or batch % m:
            raise ValueError(
                f"{what} {batch} must be a positive multiple of "
                f"num_microbatches={m} (each µ-batch needs >= 1 row)")
        return batch // m

    def summary(self, n_stages: int) -> dict:
        """Host-side schedule accounting: unroll length, per-stage
        occupancy (every stage is busy M of the M + n - 1 steps) and the
        analytic bubble fraction (n - 1) / (M + n - 1)."""
        m, n = self.num_microbatches, n_stages
        t = m + n - 1
        return {
            "enabled": self.enabled,
            "num_microbatches": m,
            "n_stages": n,
            "unroll_steps": t,
            "stage_occupancy": [m / t] * n,
            "bubble_fraction_schedule": (n - 1) / t,
            "bubble_fraction_sequential": (n - 1) / n,
        }


def _microbatch_imp(codec, hop_imps, s: int, mb: int, mb_rows: int):
    """The importance one (cut, µ-batch) hop ships: per-row (B, S)
    importance sliced to the µ-batch's rows, shared (S,) importance whole."""
    if not codec.needs_importance:
        return None
    imp = hop_imps[s]
    return imp[mb * mb_rows:(mb + 1) * mb_rows] if imp.dim() == 2 else imp


def run_pipeline_stages_microbatched(n_stages: int, codecs: list, num_microbatches: int,
                                     run_stage, hidden, hop_imps=None,
                                     devices: Optional[Sequence] = None,
                                     fused_plans: Optional[Sequence] = None, link=None,
                                     fault_key=None):
    """The µ-batch twin of :func:`run_pipeline_stages` (the reference's
    ``run_pipeline_stages_microbatched`` and its carry form in one: a stage
    body that keeps state, the decode caches, writes it in place).

    The batch splits into M contiguous row views. For t in range(M + n - 1)
    stage s runs ``run_stage(s, h, mb)`` on µ-batch mb = t - s wherever
    0 <= mb < M (the fill and drain triangles are not run), then the hops
    of the µ-batches in flight cross in reversed cut order, each as the
    sequential path crosses it (fused plans too). Under ``link`` µ-batch mb
    draws ``fold_in(fault_key, mb)`` and bumps its own counter row; the
    return value is then ``(out, {key: (M, n_hops)})``. The M outputs are
    concatenated back to the caller's (B, ...) batch."""
    devices = devices if devices is not None else [hidden.device] * n_stages
    m, n_hops = int(num_microbatches), n_stages - 1
    mb_rows = hidden.shape[0] // m
    micro = [hidden[b * mb_rows:(b + 1) * mb_rows] for b in range(m)]
    counters = [link.init_counters(n_hops) for _ in range(m)] if link is not None else None
    at = [None] * n_stages  # the µ-batch activation held at each stage
    outs = []
    for t in range(m + n_stages - 1):
        if t < m:
            at[0] = micro[t]
        for s in range(n_stages):
            if 0 <= t - s < m:
                with device_span("split.stage", devices[s], stage=s, microbatch=t - s):
                    at[s] = run_stage(s, at[s], t - s)
        if 0 <= t - n_hops < m:
            outs.append(at[n_hops])
        for s in reversed(range(n_hops)):
            mb = t - s
            if not 0 <= mb < m:
                continue
            at[s + 1] = _cross(s, codecs[s], at[s],
                               _microbatch_imp(codecs[s], hop_imps, s, mb, mb_rows),
                               devices[s + 1], fused_plans, link,
                               None if link is None else fold(fault_key, mb),
                               None if link is None else counters[mb])
    out = torch.cat(outs)
    if link is None:
        return out
    return out, {k: np.stack([c[k] for c in counters]) for k in counters[0]}


def hop_payload_bytes(codecs, cfg: ModelConfig, batch: int, seq: int) -> list:
    """Measured payload bytes per hop for one (batch, seq, D) boundary
    activation. For the stage x seq runtime this is the sum over its shards'
    payloads: per-token payloads add up over the sequence, and a
    :class:`~..codecs.ring_codecs.RingWireCodec` counts its own (its
    ``payload_bytes`` is analytic, per-row at any batch, as it crosses)."""
    shape = (batch, seq, cfg.hidden_size)
    return [c.payload_bytes(shape) for c in codecs]


def measure_hop_times(codecs, cfg: ModelConfig, batch: int, seq: int,
                      devices: Sequence, *, iters: int = 20, warmup: int = 1,
                      n_seq: int = 1) -> list:
    """Per-hop boundary-transfer time (ms): encode -> copy to the next
    stage's device -> decode of one random (batch, seq, D) float32
    activation, apart from the stage compute. ``warmup`` is clamped to >= 1
    (the first call builds and loads the kernels). On one CUDA device the
    time is CUDA events around ``iters`` hops; across devices or on the CPU
    it is the host clock between synchronisations. ``n_seq`` > 1 splits the
    probe (and its importance) into the stage x seq runtime's sequence
    shards, and a hop is every shard's crossing (:func:`_cross_shards`)."""
    warmup = max(1, int(warmup))
    results = []
    for s, codec in enumerate(codecs):
        src, dst = torch.device(devices[s]), torch.device(devices[s + 1])
        gen = torch.Generator(device=src).manual_seed(0)
        hidden = torch.randn((batch, seq, cfg.hidden_size), generator=gen, device=src)
        # batched windows ship per-row importance (the B x k side channel):
        # time that payload, as forward sends it
        imp = torch.arange(seq, dtype=torch.float32, device=src)
        if batch > 1:
            imp = imp.expand(batch, seq)

        if n_seq > 1:
            s_loc = seq // n_seq
            blocks = [slice(i * s_loc, (i + 1) * s_loc) for i in range(n_seq)]
            shards = [hidden[:, blk].contiguous() for blk in blocks]
            imp_shards = [imp[..., blk] for blk in blocks] if codec.needs_importance else None

            def hop():
                return _cross_shards(s, codec, shards, imp_shards, dst, None, None, None)
        else:
            def hop():
                return _hop(codec, hidden, imp, dst)

        for _ in range(warmup):
            hop()
        if src.type == "cuda" and src == dst:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            with torch.cuda.device(src):
                start.record()
                for _ in range(iters):
                    hop()
                end.record()
            end.synchronize()
            results.append(start.elapsed_time(end) / iters)
            continue
        _sync(src, dst)
        t0 = time.perf_counter()
        for _ in range(iters):
            hop()
        _sync(src, dst)
        results.append((time.perf_counter() - t0) * 1e3 / iters)
    return results


def _sync(*devices):
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def place_stage_params(params: dict, bounds: list, devices: list, fused_plans: list,
                       n_model: int = 1) -> dict:
    """Each stage's layer slice on its device, the embedding on the first
    stage's and the final norm and head on the last stage's. A stage behind
    a separate (unfused) hop computes in float32 (see the module note), so
    its floating weights are held in float32; an unchanged slice on its own
    device is a view, not a copy, and a copy is made once while its source
    is unchanged (``made_once``), placement after placement, so the GEMM
    planes of it are prepared once. ``fused_plans``: one plan or None a cut.
    A stage is its layers' dicts, with ``n_model`` > 1 each layer's
    ``n_model`` shard dicts (:func:`~..models.transformer.tp_shard_layers`)."""
    layers = layer_list(params["layers"])
    stages = []
    for s, ((start, stop), dev) in enumerate(zip(bounds, devices)):
        promoted = any(plan is None for plan in fused_plans[:s])

        def place(t):
            dtype = (torch.promote_types(t.dtype, torch.float32)
                     if promoted and t.is_floating_point() else t.dtype)
            if t.device == dev and t.dtype == dtype:  # in place already: no copy to keep
                return t
            return made_once(t, ("stage", str(dev), dtype),
                             lambda: t.to(device=dev, dtype=dtype))

        stage = [{name: place(t) for name, t in lp.items()} for lp in layers[start:stop]]
        stages.append(tp_shard_layers(stage, n_model) if n_model > 1 else stage)
    rest = {k: v for k, v in params.items() if k != "layers"}
    return {"stages": stages,
            "first": {k: v.to(devices[0]) for k, v in rest.items()},
            "last": {k: v.to(devices[-1]) for k, v in rest.items()}}


def stacked_importance(codecs: list, hop_importance, batch: int, seq: int,
                       devices: list) -> list:
    """Validate the per-hop importance entries and shape them as the
    reference stacks them: every entry (S,), or every entry (B, S) when any
    is per-row or an importance hop runs at batch > 1; a hop without one
    gets zeros. Each entry lands on its cut's device."""
    n_hops = len(codecs)
    imps = list(hop_importance) if hop_importance is not None else [None] * n_hops
    if len(imps) != n_hops:
        raise ValueError(f"expected {n_hops} hop_importance entries, got {len(imps)}")
    imps = [None if i is None else torch.as_tensor(i) for i in imps]
    for c, imp in zip(codecs, imps):
        if c.needs_importance and imp is None:
            raise ValueError(f"hop codec {c.name} requires an importance vector")
        if c.needs_importance and batch > 1 and (
                imp.dim() != 2 or imp.shape[0] != batch):
            # one (S,) vector cannot speak for several evaluation windows:
            # each window has its own token ordering in the reference
            raise ValueError(
                f"hop codec {c.name} with batch {batch} needs per-row "
                f"({batch}, S) importance (got shape {tuple(imp.shape)})")
    per_row = any(i is not None and i.dim() == 2 for i in imps) or (
        batch > 1 and any(c.needs_importance for c in codecs))
    shape = (batch, seq) if per_row else (seq,)
    return [torch.zeros(shape, dtype=torch.float32, device=dev) if i is None
            else torch.broadcast_to(i.to(device=dev, dtype=torch.float32), shape)
            for i, dev in zip(imps, devices)]


@dataclasses.dataclass(frozen=True)
class SplitConfig:
    """Where the model is cut and what crosses each cut.

    cuts: boundary layers; the activation crosses *after* layer ``cuts[i]``.
    hop_codecs: one entry per cut, a registry name or a ``WireCodec``
        instance (parameterised codecs such as ``selective_int4``)."""

    cuts: tuple
    hop_codecs: tuple

    def __post_init__(self):
        if len(self.hop_codecs) != len(self.cuts):
            raise ValueError("need exactly one hop codec per cut")
        if list(self.cuts) != sorted(set(self.cuts)):
            raise ValueError("cuts must be strictly increasing")

    @property
    def n_stages(self) -> int:
        return len(self.cuts) + 1

    def stage_bounds(self, num_layers: int) -> list:
        """[(start, stop)] per stage; stage i owns layers [start, stop)."""
        edges = [0] + [c + 1 for c in self.cuts] + [num_layers]
        if not all(0 <= c < num_layers - 1 for c in self.cuts):
            raise ValueError(f"cuts {self.cuts} out of range for {num_layers} layers")
        return list(zip(edges[:-1], edges[1:]))

    def replan(self, num_layers: int, n_stages: int, codec=None) -> "SplitConfig":
        """The split for another stage count: cuts evenly spaced over
        ``num_layers``, every cut carrying ``codec`` (default: this plan's
        first hop codec); ``n_stages == 1`` is the cut-free plan."""
        if not 1 <= n_stages <= num_layers:
            raise ValueError(
                f"cannot re-plan {num_layers} layers onto {n_stages} stage(s)")
        if n_stages == 1:
            return SplitConfig(cuts=(), hop_codecs=())
        if codec is None:
            if not self.hop_codecs:
                raise ValueError("re-planning a cut-free split needs an explicit codec")
            codec = self.hop_codecs[0]
        cuts = tuple(round(i * num_layers / n_stages) - 1 for i in range(1, n_stages))
        return SplitConfig(cuts=cuts, hop_codecs=(codec,) * len(cuts))


class SplitRuntime:
    """A pipeline-split forward for one (cfg, split, stage devices).

    Usage::

        rt = SplitRuntime(cfg, SplitConfig(cuts=(11,), hop_codecs=("int8_per_token",)))
        placed = rt.place_params(params)
        logits = rt.forward(placed, ids)   # every cut crossed as a packed payload
        rt.hop_bytes(batch, seq)           # measured payload bytes per hop
    """

    def __init__(self, cfg: ModelConfig, split: SplitConfig,
                 devices=None, *,
                 faults=None, policy=None, fec=None, hedge=None, pipeline=None,
                 n_data: int = 1, n_model: int = 1):
        """``devices``: one torch device a stage (default: the card for
        every stage), or a ("stage", "data", "model") :class:`Mesh`, whose
        data and model sizes then replace ``n_data`` / ``n_model``."""
        n_stages = split.n_stages
        if isinstance(devices, Mesh):
            mesh = devices
        else:
            devices = ["cuda"] * n_stages if devices is None else list(devices)
            if len(devices) != n_stages:
                raise ValueError(f"{len(devices)} stage devices given, split needs {n_stages}")
            mesh = make_stage_mesh(n_stages, n_data, n_model,
                                   [d for d in devices for _ in range(n_data * n_model)])
        self.mesh = mesh
        n_data, n_model = mesh.shape["data"], mesh.shape["model"]
        if mesh.shape["stage"] != n_stages:
            raise ValueError(
                f"mesh has {mesh.shape['stage']} stage slots, split needs {n_stages}")
        grid = mesh.devices
        #: this process's data groups: every group, but on a mesh whose data
        #: axis spans processes
        self.data_groups = [g for g in range(n_data) if slot_is_local(grid[0, g, 0])]
        self.spans_processes = len(self.data_groups) < n_data
        devices = mesh_stage_devices(mesh)
        self.n_data, self.n_model = n_data, n_model
        if n_model > 1:
            cfg.require_uniform("a tensor-parallel stage")
            bad = [(name, dim) for name, dim in
                   [("num_heads", cfg.num_heads), ("num_kv_heads", cfg.num_kv_heads),
                    ("intermediate_size", cfg.intermediate_size)] if dim % n_model]
            if bad:
                raise ValueError(
                    f"tensor parallelism n_model={n_model} requires head/FFN dims "
                    f"divisible by the axis; offending: {bad}")
        self.cfg = cfg
        self.split = split
        self.faults = faults
        self.policy = policy if policy is not None else LinkPolicy()
        self.fec = fec
        self.hedge = hedge
        self.pipeline = pipeline
        # an all-zero-rate config builds no link: the hop is the fault-free one
        self._link = (FaultyLink(faults, self.policy, fec=fec, hedge=hedge)
                      if faults is not None and faults.enabled else None)
        self._counter_accum: list = []
        self._mb_counter_accum: list = []  # pipelined: {key: (M, n_hops)}
        self._lost_stage: Optional[int] = None
        self.devices = devices
        self.bounds = split.stage_bounds(cfg.num_layers)
        self.codecs: list[WireCodec] = apply_default_codec_backend(
            list(split.hop_codecs), self.devices[0])
        # per-cut fused-transport decision, resolved once (None = the
        # separate encode / copy / decode hop); the gate reads
        # EDGELLM_FUSED_HOP and the probe cache now, and refuses under an
        # active link, which owns the hop
        self.fused_plans: list = [
            fused_hop_plan(c, link_active=self._link is not None, device=self.devices[s])
            for s, c in enumerate(self.codecs)]
        #: the deepest stage's layer count: the depth every stage of a
        #: paged payload is padded to, as the reference pads its stages
        self.stage_size = max(stop - start for start, stop in self.bounds)
        if n_data > 1:
            # token-selective codecs are exempt: forward gives batched
            # windows per-row (B, S) importance, so their ordering and scale
            # are row-local, the same on any cut of the batch
            bad = [c.name for c in self.codecs
                   if not c.batch_invariant and not c.needs_importance]
            if bad:
                raise ValueError(
                    f"codecs {bad} compute scales over the batch axis and would "
                    f"diverge from a single-device run under data parallelism "
                    f"(n_data={n_data}); use per-token codecs or n_data=1")
        if pipeline is not None and pipeline.enabled:
            if n_stages < 2:
                raise ValueError(
                    "micro-batch pipelining needs a cut to hide hops behind; "
                    f"got n_stages={n_stages} with num_microbatches="
                    f"{pipeline.num_microbatches}")
            if n_data > 1 or n_model > 1:
                raise ValueError(
                    "micro-batch pipelining supports stage-only meshes "
                    "(n_data=n_model=1): the µ-batch split owns the batch "
                    f"axis; got data={n_data}, model={n_model}")
            # a batch-wide codec scale changes when the batch splits into
            # µ-batches (token-selective codecs ship per-row importance at
            # any batch > 1, so their payloads are row-local)
            bad = [c.name for c in self.codecs
                   if not c.batch_invariant and not c.needs_importance]
            if bad:
                raise ValueError(
                    f"codecs {bad} compute scales over the batch axis; their "
                    f"payloads change when the batch splits into "
                    f"{pipeline.num_microbatches} µ-batches, breaking the "
                    f"token-identity guarantee — use per-token codecs or "
                    f"num_microbatches=1")

    # ---------- stage liveness ----------

    def mark_stage_lost(self, stage: int) -> None:
        """Record a dark stage: every later call raises
        :class:`~..serve.recovery.StageLostError` until the caller fails
        over. Host state only."""
        if not 0 <= stage < self.split.n_stages:
            raise ValueError(f"stage {stage} out of range for {self.split.n_stages} stages")
        self._lost_stage = stage

    @property
    def lost_stage(self) -> Optional[int]:
        return self._lost_stage

    def _check_alive(self) -> None:
        if self._lost_stage is not None:
            raise StageLostError(self._lost_stage)

    # ---------- parameter placement ----------

    def place_params(self, params: dict) -> dict:
        """Each stage's layer slice on its device, the embedding on the first
        stage's and the final norm and head on the last stage's
        (:func:`place_stage_params`)."""
        return place_stage_params(params, self.bounds, self.devices, self.fused_plans,
                                  self.n_model)

    # ---------- forward ----------

    # every payload leaf of every cut crosses once a call (a fused hop: one
    # flat sealed buffer a cut, hop_bytes + 8); a pipelined call moves M
    # payloads of (B / M, S, D) a cut
    @_hop_contract("split.forward", "causal_attention")
    @_hop_contract("split.forward.fused", "causal_attention")
    @_hop_contract("split.forward.pipelined", "causal_attention")
    def forward(self, placed: dict, input_ids: torch.Tensor,
                hop_importance: Optional[Sequence] = None,
                fault_step: int = 0) -> torch.Tensor:
        """ids (B, S) -> float32 logits (B, S, V) on the last stage's device,
        every cut crossed as a packed payload.

        ``hop_importance``: one entry per hop, required for token-selective
        hops (None elsewhere); each (S,), or (B, S) when batching evaluation
        windows so every window keeps its own ordering and codec scale.

        ``fault_step``: the fault layer's per-call fold (pass the chunk index,
        so each chunk draws its own faults); ignored without a link. The
        per-hop counters accumulate on the runtime (:meth:`link_counters`).

        With ``n_data`` > 1 the batch splits into ``n_data`` contiguous row
        groups, each through the whole stage chain with its own payloads
        (see the module note); on a mesh whose data axis spans processes
        the logits are this process's groups' rows."""
        self._check_alive()
        batch, seq = input_ids.shape
        if self.pipelined:
            self.pipeline.validate_batch(batch, "forward batch")
        if batch % self.n_data:
            raise ValueError(f"forward batch {batch} must be a multiple of the mesh data "
                             f"axis size {self.n_data}")
        imps = stacked_importance(self.codecs, hop_importance, batch, seq, self.devices)
        hidden = embed(placed["first"], input_ids.to(self.devices[0]))

        def run_stage(s, h, mb=None):
            stage = placed["stages"][s]
            if self.n_model > 1:
                return run_layers_tp(self.cfg, stage, h)
            start, stop = self.bounds[s]
            return run_layers(self.cfg, {"layers": stage}, h, start=start, stop=stop,
                              first=start)[0]

        rows, outs, counters = batch // self.n_data, [], []
        for g in self.data_groups:
            sl = slice(g * rows, (g + 1) * rows)
            outs.append(self._run_stages(
                run_stage, hidden[sl], [i[sl] if i.dim() == 2 else i for i in imps],
                lambda seed: fault_key(seed, fault_step), microbatched=True,
                accum=counters.append))
        if counters:
            # the reference's counters leave its shard_map as if replicated
            # (out_specs=P()): a process reads its first local slot's
            self._accum_counters(counters[0])
        with device_span("split.unembed", self.devices[-1]):
            return unembed(self.cfg, placed["last"],
                           outs[0] if len(outs) == 1 else torch.cat(outs))

    def _run_stages(self, run_stage, hidden, imps, key_fn, microbatched: bool = False,
                    accum=None):
        """The stage unroll over this runtime's hops: the µ-batch schedule
        (:func:`run_pipeline_stages_microbatched`, ``run_stage(s, h, mb)``)
        when ``microbatched`` and the runtime is pipelined, else
        :func:`run_pipeline_stages`; through the link keyed by
        ``key_fn(seed)`` when one is active (this call's counters go to
        ``accum``, by default accumulating on the runtime), else the plain
        or fused hops."""
        n, link = self.split.n_stages, self._link
        key = key_fn(link.faults.seed) if link is not None else None
        if microbatched and self.pipelined:
            got = run_pipeline_stages_microbatched(
                n, self.codecs, self.pipeline.num_microbatches, run_stage, hidden, imps,
                self.devices, self.fused_plans, link, key)
        else:
            got = run_pipeline_stages(n, self.codecs, run_stage, hidden, imps, self.devices,
                                      self.fused_plans, link, key)
        if link is None:
            return got
        out, counters = got
        (accum or self._accum_counters)(counters)
        return out

    @property
    def pipelined(self) -> bool:
        """True when the µ-batch schedule is armed (num_microbatches > 1);
        False, ``PipelineConfig(num_microbatches=1)`` included, runs the
        sequential unroll."""
        return self.pipeline is not None and self.pipeline.enabled

    def pipeline_summary(self) -> dict:
        """Schedule accounting for the obs gauges and the result dicts:
        µ-batch count, unroll length, per-stage occupancy, the analytic
        bubble fraction (the reference's; the stages of one card run in
        turn on one stream). Meaningful when pipelining is off too."""
        pipe = self.pipeline if self.pipeline is not None else PipelineConfig()
        return pipe.summary(self.split.n_stages)

    def _accum_counters(self, counters: dict) -> None:
        """Park one call's counters. A pipelined call's {key: (M, n_hops)}
        rows accumulate apart (:meth:`microbatch_counters`) and their hop
        totals join the (n_hops,) stream :meth:`link_counters` reports."""
        if np.asarray(next(iter(counters.values()))).ndim == 2:
            self._mb_counter_accum.append(counters)
            counters = {k: v.sum(axis=0) for k, v in counters.items()}
        self._counter_accum.append(counters)

    @staticmethod
    def _step_key(level: int):
        """The decode / verify / paged step's key builder: the reference's
        ``fold_in(fold_in(key(seed), 0x57E9), level)``."""
        return lambda seed: fold(fault_key(seed, STEP_FAULT_FOLD), level)

    # ---------- the faulty link's accounting ----------

    @property
    def link(self) -> Optional[FaultyLink]:
        """The faulty link, or None when faults are off."""
        return self._link

    def link_counters(self, reset: bool = False) -> Optional[dict]:
        """Per-hop fault counters accumulated over every forward, prefill,
        step and verify so far: {name: (n_hops,) int64}. None when faults
        are off."""
        if self._link is None:
            return None
        tot = sum_counters(self._counter_accum)
        if tot is None:
            tot = self._link.init_counters(len(self.codecs))
        if reset:
            self._counter_accum = []
        return tot

    def microbatch_counters(self, reset: bool = False) -> Optional[dict]:
        """Per-µ-batch fault counters of the pipelined calls: {name: (M,
        n_hops) int64}, row m the faults µ-batch m's payloads drew on each
        cut. None when faults are off or pipelining is disabled. Sequential
        calls on the same runtime (prefill, verify) appear only in
        :meth:`link_counters`."""
        if self._link is None or not self.pipelined:
            return None
        tot = sum_counters(self._mb_counter_accum)
        if tot is None:
            m, n_hops = self.pipeline.num_microbatches, len(self.codecs)
            tot = {k: np.zeros((m, n_hops), np.int64)
                   for k in self._link.init_counters(n_hops)}
        if reset:
            self._mb_counter_accum = []
        return tot

    def wire_summary(self, batch: int, seq: int) -> list:
        """Per-hop wire accounting in one shot, the rows the obs registry
        reads: codec name, whole-window forward bytes, single-step decode
        bytes, steady-state bytes per token and the fused-plan decision."""
        fwd = self.hop_bytes(batch, seq)
        dec = self.decode_hop_bytes(batch)
        per_tok = self.bytes_per_token(seq)
        return [{"hop": i, "codec": self.codecs[i].name,
                 "forward_bytes": int(fwd[i]),
                 "decode_step_bytes": int(dec[i]) if i < len(dec) else 0,
                 "bytes_per_token": float(per_tok[i]),
                 "fused": (None if self.fused_plans[i] is None else
                           {"mode": self.fused_plans[i].mode,
                            "reason": self.fused_plans[i].reason})}
                for i in range(len(self.codecs))]

    def hop_attribution(self, delta: Optional[dict], per_hop_bytes: Optional[list] = None, *,
                        link_tier: Optional[int] = None) -> list:
        """Per-cut attribution rows for the tracing plane: {hop, cut layer,
        codec, wire bytes, ladder outcome} a boundary hop. ``delta`` is one
        call's :meth:`link_counters` delta (None without a link),
        ``per_hop_bytes`` the call's per-hop wire bytes, ``link_tier`` the
        LinkHealth tier if the caller tracks one. The outcome is the worst
        rung the hop reached: substituted > hedged > retried > repaired >
        degraded (tier > 0) > clean. Host arithmetic on host counters."""
        def counted(key: str, i: int) -> int:
            if not delta or key not in delta:
                return 0
            v = delta[key]
            try:
                return int(v[i])
            except (TypeError, IndexError):
                return int(v)

        rows = []
        for i, codec in enumerate(self.codecs):
            if counted("substituted", i):
                outcome = "substituted"
            elif counted("hedge_wins", i):
                outcome = "hedged"
            elif counted("retried", i):
                outcome = "retried"
            elif counted("repaired", i):
                outcome = "repaired"
            elif link_tier:
                outcome = "degraded"
            else:
                outcome = "clean"
            wire = 0.0
            if per_hop_bytes is not None and i < len(per_hop_bytes):
                wire = float(per_hop_bytes[i])
            rows.append({"hop": i, "cut": int(self.split.cuts[i]), "codec": codec.name,
                         "wire_bytes": wire, "outcome": outcome})
        return rows

    # ---------- wire accounting and timing ----------

    def hop_bytes(self, batch: int, seq: int) -> list:
        """Measured payload bytes per hop for one (batch, seq, D) activation."""
        return hop_payload_bytes(self.codecs, self.cfg, batch, seq)

    def bytes_per_token(self, seq: int) -> list:
        """Per-hop boundary bytes per token."""
        return [b / seq for b in self.hop_bytes(1, seq)]

    def time_hops(self, batch: int, seq: int, iters: int = 20, warmup: int = 1) -> list:
        """Per-hop transfer time (ms) of one (batch, seq, D) activation:
        encode -> copy -> decode, apart from the stage compute, warmed up."""
        return measure_hop_times(self.codecs, self.cfg, batch, seq, self.devices,
                                 iters=iters, warmup=warmup)

    def time_decode_hops(self, batch: int = 1, iters: int = 20, warmup: int = 1) -> list:
        """:meth:`time_hops` at the decode shape, one (batch, 1, D) token."""
        return measure_hop_times(self.codecs, self.cfg, batch, 1, self.devices,
                                 iters=iters, warmup=warmup)

    # ---------- incremental decode ----------
    #
    # At decode time each cut moves ONE token's hidden per step; the
    # per-stage caches never cross a cut.

    def _check_decode_supported(self):
        self._check_alive()
        if self.n_data > 1 or self.n_model > 1:
            raise ValueError(
                "split decode supports stage-only meshes (n_data=n_model=1); "
                f"got data={self.n_data}, model={self.n_model}")
        bad = [c.name for c in self.codecs if c.needs_importance]
        if bad:
            raise ValueError(
                f"token-selective hop codecs {bad} have no importance source "
                f"for a single decode position; use per-token/channel codecs")

    def _run_cached(self, placed: dict, cache: dict, token_ids: torch.Tensor, block_fn,
                    microbatched: bool = False):
        """Embed the (B, K) ids at positions ``length ..``, run every stage's
        layers through ``block_fn`` (:func:`block_decode` or
        :func:`block_verify`: each writes its rows into the stage's cache in
        place), crossing each cut as the forward does -> the last stage's
        (B, K, D) hidden. ``microbatched``: the µ-batch schedule on a
        pipelined runtime, each µ-batch over its own cache rows."""
        pos, kq, capacity = int(cache["length"]), token_ids.shape[1], cache["capacity"]
        if pos + kq > capacity:
            raise ValueError(f"cache capacity overflow: {pos} filled + {kq} new > "
                             f"capacity {capacity}")
        hidden = embed(placed["first"], token_ids.to(self.devices[0]))
        rope = {d: precompute_rope(self.cfg, capacity, device=d) for d in set(self.devices)}
        rows = token_ids.shape[0] // (self.pipeline.num_microbatches
                                      if microbatched and self.pipelined else 1)

        def run_stage(s, h, mb=None):
            cos, sin = rope[self.devices[s]]
            kc, vc = cache["k"][s], cache["v"][s]
            if mb is not None:  # this µ-batch's cache rows, written in place
                kc, vc = kc[:, mb * rows:(mb + 1) * rows], vc[:, mb * rows:(mb + 1) * rows]
            for i, lp in enumerate(placed["stages"][s]):
                h = block_fn(self.cfg, lp, h, cos[pos:pos + kq], sin[pos:pos + kq],
                             kc[i], vc[i], pos)
            return h

        return self._run_stages(run_stage, hidden, None, self._step_key(pos), microbatched)

    def prefill_decode(self, placed: dict, input_ids: torch.Tensor, capacity: int,
                       fault_step: int = 0) -> tuple:
        """Pipeline-split prefill that also fills the per-stage KV caches ->
        (logits (B, S, V) float32, cache). The cache dict holds ``k`` and
        ``v`` (one (layers_of_stage, B, capacity, KV, hd) tensor per stage, on
        the stage's device, in the embedding's dtype), ``length`` (S) and
        ``capacity``; feed it to :meth:`decode_step` or :meth:`verify_step`.
        ``fault_step`` folds the link's prefill key (ignored without one)."""
        self._check_decode_supported()
        b, s = input_ids.shape
        capacity = int(capacity)
        if not 0 < s <= capacity:
            raise ValueError(f"prompt length {s} must be in [1, capacity={capacity}]")
        hidden = embed(placed["first"], input_ids.to(self.devices[0]))
        cache_dtype = hidden.dtype
        ks, vs = [], []

        def run_stage(st, h):
            start, stop = self.bounds[st]
            out, aux = run_layers(self.cfg, {"layers": placed["stages"][st]}, h, start=start,
                                  stop=stop, first=start, collect_kv=True)
            k, v = aux["kv"]  # (layers, B, S, KV, hd)
            shape = k.shape[:2] + (capacity,) + k.shape[3:]
            kc = torch.zeros(shape, dtype=cache_dtype, device=k.device)
            vc = torch.zeros(shape, dtype=cache_dtype, device=v.device)
            kc[:, :, :s] = k
            vc[:, :, :s] = v
            ks.append(kc)
            vs.append(vc)
            return out

        out = self._run_stages(run_stage, hidden, None, lambda seed: fold(
            fault_key(seed, PREFILL_FAULT_FOLD), fault_step))
        logits = unembed(self.cfg, placed["last"], out)
        return logits, {"k": ks, "v": vs, "length": s, "capacity": capacity,
                        "prefill_len": s}

    def cache_state(self, cache: dict) -> dict:
        """A decode cache as host arrays in the reference's layout: ``k`` /
        ``v`` (n_stages, stage_size, B, capacity, KV, hd) in the cache dtype
        (bf16 as a CPU bf16 tensor), ``length`` int32. The layers that pad a
        shorter stage hold what the reference's zero layers write: zero V
        rows, and K rows that are the rotary embedding of a zero key at each
        prefilled position (+0 or -0 by the signs of cos and sin); a restored
        cache gives its loaded padding rows back."""
        bf16 = cache["k"][0].dtype == torch.bfloat16
        host = lambda t: (t.view(torch.int16) if bf16 else t).cpu().numpy()  # noqa: E731
        out = {}
        for name in ("k", "v"):
            padded = self._padded([host(t) for t in cache[name]])
            for s, rows in enumerate(self._padding_rows(cache, name)):
                if rows is not None:
                    padded[s, self._layers(s):] = host(rows)
            out[name] = torch.from_numpy(padded).view(torch.bfloat16) if bf16 else padded
        out["length"] = np.asarray(int(cache["length"]), np.int32)
        return out

    def _padding_rows(self, cache: dict, name: str) -> list:
        """Per stage, the (stage_size - layers, B, capacity, KV, hd) rows of
        its padding layers as the reference holds them, or None (zeros)."""
        if "padding" in cache:
            return cache["padding"][name]
        n_pre = cache.get("prefill_len", 0)
        out = []
        for s, t in enumerate(cache[name]):
            n_pad = self.stage_size - self._layers(s)
            if not n_pad or not n_pre or name == "v":
                out.append(None)
                continue
            rows = torch.zeros((n_pad,) + tuple(t.shape[1:]), dtype=t.dtype)
            cos, sin = precompute_rope(self.cfg, n_pre, device="cpu")
            rows[:, :, :n_pre] = apply_rotary(
                torch.zeros(t.shape[1:2] + (n_pre,) + tuple(t.shape[3:])), cos, sin,
                self.cfg.rotary_dim).to(t.dtype)
            out.append(rows)
        return out

    def load_cache_state(self, state: dict, placed: Optional[dict] = None) -> dict:
        """:meth:`cache_state` output (or a checkpoint's) back on the stage
        devices: each stage's own layer rows; the padding layers' rows are
        kept on the host, so the cache writes back the bytes it was given."""
        out = {"length": int(np.asarray(state["length"])),
               "capacity": int(state["k"].shape[3]), "padding": {}}
        for name in ("k", "v"):
            arr = state[name]
            arr = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(np.asarray(arr))
            out[name] = [arr[s, :self._layers(s)].to(self.devices[s], copy=True)
                         for s in range(self.split.n_stages)]
            out["padding"][name] = [arr[s, self._layers(s):].clone()
                                    if self._layers(s) < self.stage_size else None
                                    for s in range(self.split.n_stages)]
        return out

    # the (B, 1, D) hidden crosses each cut; the per-stage caches are
    # written in place
    @_hop_contract("split.decode_step", in_place=True)
    @_hop_contract("split.decode_step.fused", in_place=True)
    @_hop_contract("split.decode_step.pipelined", in_place=True)
    def decode_step(self, placed: dict, cache: dict, token_ids: torch.Tensor) -> tuple:
        """One decode position across the pipeline: (B,) token ids -> (logits
        (B, V) float32, the cache with ``length + 1``; its rows written in
        place). Each cut moves the (B, 1, D) hidden through its hop."""
        self._check_decode_supported()
        if self.pipelined:
            self.pipeline.validate_batch(int(cache["k"][0].shape[1]), "decode batch")
        out = self._run_cached(placed, cache, token_ids.reshape(-1, 1), block_decode,
                               microbatched=True)
        logits = unembed(self.cfg, placed["last"], out)[:, -1]
        return logits, {**cache, "length": int(cache["length"]) + 1}

    def decode_hop_bytes(self, batch: int) -> list:
        """Payload bytes per hop of one decode step's (batch, 1, D) hidden."""
        return hop_payload_bytes(self.codecs, self.cfg, batch, 1)

    def pipelined_decode_hop_bytes(self, batch: int) -> list:
        """:meth:`decode_hop_bytes` under the µ-batch schedule: each cut
        moves M payloads of (batch / M, 1, D) a step (per-µ-batch scales
        replicate M-fold). The sequential accounting when pipelining is off
        or ``batch`` does not µ-batch."""
        if not self.pipelined or batch % self.pipeline.num_microbatches or batch < 1:
            return self.decode_hop_bytes(batch)
        m = self.pipeline.num_microbatches
        return [m * b for b in hop_payload_bytes(self.codecs, self.cfg, batch // m, 1)]

    # ---------- speculative verify ----------

    # ONE (B, k, D) block crosses each cut a burst, not k single-token hops
    @_hop_contract("split.verify_step", in_place=True)
    @_hop_contract("split.verify_step.fused", in_place=True)
    def verify_step(self, placed: dict, cache: dict, token_ids: torch.Tensor) -> tuple:
        """Verify k drafted positions in one split pass: ``token_ids`` (B, k)
        is the last committed token and the k - 1 drafts; each cut moves ONE
        (B, k, D) block. All k K/V rows are written at ``length`` and the
        returned cache claims them (``length + k``); the caller commits the
        accepted prefix by rewriting ``length`` (rows past it are masked).
        Returns (logits (B, k, V) float32, cache)."""
        self._check_decode_supported()
        out = self._run_cached(placed, cache, token_ids, block_verify)
        logits = unembed(self.cfg, placed["last"], out)
        return logits, {**cache, "length": int(cache["length"]) + token_ids.shape[1]}

    def verify_hop_bytes(self, batch: int, k: int) -> list:
        """Payload bytes per hop of one verify burst's (batch, k, D) block."""
        return hop_payload_bytes(self.codecs, self.cfg, batch, k)

    # ---------- paged incremental decode ----------
    #
    # The continuous-batching twin of the block above: each stage's layers
    # page like the local pool (fixed-size pages, one page table, trash page
    # 0), so streams of any fill level share one ragged step while every cut
    # still moves its (max_slots, 1, D) hidden through its hop.

    def init_paged_pool(self, num_pages: int, page_size: int,
                        dtype: torch.dtype = torch.float32, kv_codec: str = "fp") -> dict:
        """Zeroed per-stage paged KV pools: ``{"k": [...], "v": [...]}``, one
        (layers_of_stage, num_pages, page_size, KV, hd) tensor per stage on
        its device in ``dtype``. Page 0 is the trash page: the host's page
        tables never hand it out. A quantized ``kv_codec`` tier holds codes
        (hd or hd / 2 lanes) under "k" / "v", fp32 per-row scales under
        "k_scale" / "v_scale", and the tier's name under "kv_codec"."""
        self._check_decode_supported()
        if num_pages < 2:
            raise ValueError("need num_pages >= 2 (page 0 is the trash page)")
        cfg, codec = self.cfg, resolve_kv_codec(kv_codec)
        lanes = codec.code_lanes(cfg.head_dim) if codec.quantized else cfg.head_dim
        names = ("k", "v", "k_scale", "v_scale") if codec.quantized else ("k", "v")
        pool = {name: [] for name in names}
        for (start, stop), dev in zip(self.bounds, self.devices):
            shape = (stop - start, num_pages, page_size, cfg.num_kv_heads, lanes)
            for name in names:
                if name.endswith("scale"):
                    pool[name].append(torch.zeros(shape[:-1], dtype=torch.float32, device=dev))
                else:
                    pool[name].append(torch.zeros(
                        shape, dtype=codec.code_dtype if codec.quantized else dtype,
                        device=dev))
        if codec.quantized:
            pool["kv_codec"] = codec.name
        return pool

    @staticmethod
    def _pool_codec(pool: dict) -> str:
        return pool.get("kv_codec", "fp") if "k_scale" in pool else "fp"

    @staticmethod
    def _pool_arrays(pool: dict) -> tuple:
        """The pool's per-stage lists: (k, v) or (k, v, k_scale, v_scale)."""
        names = ("k", "v", "k_scale", "v_scale") if "k_scale" in pool else ("k", "v")
        return tuple(pool[name] for name in names)

    def _stage_pool(self, pool: dict, s: int) -> tuple:
        return tuple(arrs[s] for arrs in self._pool_arrays(pool))

    def _index(self, idx, s: int) -> torch.Tensor:
        return torch.as_tensor(np.asarray(idx, np.int64)).to(self.devices[s])

    def _layers(self, s: int) -> int:
        return self.bounds[s][1] - self.bounds[s][0]

    def _write_rows(self, pool: dict, s: int, dest: torch.Tensor, k_rows, v_rows) -> None:
        """Stage ``s``'s (layers_of_stage, n, KV, hd) fp rows into its pool at
        flat token positions ``dest``, quantized on append on a quantized
        tier."""
        codec = self._pool_codec(pool)
        arrays = self._stage_pool(pool, s)
        if codec == "fp":
            _rows_set(arrays[0], dest, k_rows)
            _rows_set(arrays[1], dest, v_rows)
            return
        dev = self.devices[s]
        qk, sk = quantize_kv_rows(torch.as_tensor(k_rows).to(dev), codec)
        qv, sv = quantize_kv_rows(torch.as_tensor(v_rows).to(dev), codec)
        for arr, rows in zip(arrays, (qk, qv, sk, sv)):
            _rows_set(arr, dest, rows)

    def adopt_paged(self, pool: dict, cache: dict, row: int, dest, length: int, *,
                    start: int = 0) -> dict:
        """Move one stream's prefilled rows (``prefill_decode`` or
        ``verify_step`` cache row ``row``, positions ``start .. length``)
        into the pool pages at flat token indices ``dest`` ((length - start,)
        ints, from ``PagedKVCache._flat_indices``). In place; a quantized
        pool quantizes on append. Returns the pool."""
        self._check_decode_supported()
        for s in range(self.split.n_stages):
            self._write_rows(pool, s, self._index(dest, s),
                             cache["k"][s][:, row, start:length],
                             cache["v"][s][:, row, start:length])
        return pool

    def adopt_paged_rows(self, pool: dict, k_seq, v_seq, dest) -> dict:
        """Scatter a contiguous (n_stages, stage_size, n, KV, hd) K/V payload
        (a :meth:`gather_paged` payload, the re-admission half of an
        eviction) into the pool pages at flat token indices ``dest``; the
        padding layers' rows are dropped. A quantized pool requantizes the
        fp rows; the bit-exact resume is :meth:`adopt_paged_rows_packed`."""
        self._check_decode_supported()
        for s in range(self.split.n_stages):
            n = self._layers(s)
            self._write_rows(pool, s, self._index(dest, s), k_seq[s, :n], v_seq[s, :n])
        return pool

    def adopt_paged_rows_packed(self, pool: dict, k_codes, v_codes, k_scale, v_scale,
                                dest) -> dict:
        """Scatter a :meth:`gather_paged_packed` payload back: the raw codes
        and scales, no requantize, so evict -> re-admit is bit-exact."""
        self._check_decode_supported()
        codec = self._pool_codec(pool)
        if codec == "fp":
            raise KVTierMismatchError(
                offered="quantized", pool=codec, where="adopt_paged_rows_packed",
                detail="packed payloads need a quantized pool; fp pools adopt fp rows via "
                       "adopt_paged_rows")
        for s in range(self.split.n_stages):
            n, dest_s = self._layers(s), self._index(dest, s)
            for arr, rows in zip(self._stage_pool(pool, s),
                                 (k_codes, v_codes, k_scale, v_scale)):
                _rows_set(arr, dest_s, rows[s, :n])
        return pool

    def copy_paged_pages(self, pool: dict, src, dst) -> dict:
        """Apply prefix-cache COW forks to every stage's pool: pages ``src``
        copied to pages ``dst`` (parallel index lists of
        ``PagedKVCache.ensure_writable``'s (old, new) pairs). Codes and
        scales move as bytes on a quantized tier."""
        self._check_decode_supported()
        for s in range(self.split.n_stages):
            src_s, dst_s = self._index(src, s), self._index(dst, s)
            for arr in self._stage_pool(pool, s):
                arr[:, dst_s] = arr[:, src_s]
        return pool

    def _gather_rows(self, pool: dict, idx) -> list:
        """Every stage's (layers_of_stage, n, KV, hd) rows at flat token
        indices ``idx``, on its device: the pool dtype, dequantized to fp32
        on a quantized tier."""
        codec, out = self._pool_codec(pool), []
        for s in range(self.split.n_stages):
            rows = [_rows_get(arr, self._index(idx, s)) for arr in self._stage_pool(pool, s)]
            if codec != "fp":
                rows = [dequantize_kv_rows(rows[0], rows[2], codec),
                        dequantize_kv_rows(rows[1], rows[3], codec)]
            out.append(rows[:2])
        return out

    def _padded(self, per_stage: list) -> np.ndarray:
        """Per-stage (layers_of_stage, ...) host arrays -> one (n_stages,
        stage_size, ...) array, zero rows for the padding layers."""
        first = per_stage[0]
        out = np.zeros((self.split.n_stages, self.stage_size) + first.shape[1:], first.dtype)
        for s, rows in enumerate(per_stage):
            out[s, :rows.shape[0]] = rows
        return out

    def gather_paged(self, pool: dict, idx) -> tuple:
        """One stream's K/V rows at flat token indices ``idx`` as host
        (k_seq, v_seq), each (n_stages, stage_size, n, KV, hd) (bf16 widened
        to fp32 exactly; a quantized tier dequantized to fp32): byte for byte
        the rows :meth:`adopt_paged` scattered. The pool is not consumed."""
        self._check_decode_supported()
        rows = self._gather_rows(pool, idx)
        return tuple(self._padded([_host(r[i]) for r in rows]) for i in (0, 1))

    def gather_paged_packed(self, pool: dict, idx) -> tuple:
        """A quantized pool's eviction form: host (k_codes, v_codes, k_scale,
        v_scale) at flat token indices ``idx``, the raw pool bytes, in the
        (n_stages, stage_size, n, ...) layout."""
        self._check_decode_supported()
        if self._pool_codec(pool) == "fp":
            raise KVTierMismatchError(
                offered="quantized", pool="fp", where="gather_paged_packed",
                detail="the packed gather form needs a quantized pool; fp pools use "
                       "gather_paged")
        per_stage = [[_rows_get(arr, self._index(idx, s)).cpu().numpy()
                      for arr in self._stage_pool(pool, s)]
                     for s in range(self.split.n_stages)]
        return tuple(self._padded([rows[i] for rows in per_stage]) for i in range(4))

    # the (max_slots, 1, D) hidden crosses each cut; the per-stage pools
    # are written in place
    @_hop_contract("split.decode_step_paged", "paged_decode_attention", in_place=True)
    @_hop_contract("split.decode_step_paged.pipelined", "paged_decode_attention",
                   in_place=True)
    def decode_step_paged(self, placed: dict, pool: dict, page_table, lengths,
                          token_ids) -> tuple:
        """One ragged decode position across the pipeline: every slot
        advances at its own fill level (``page_table`` (max_slots,
        pages_per_slot) and ``lengths`` (max_slots,) from the host's
        ``PagedKVCache``), each stage's layers run over its own pool (K13,
        or K14 on a quantized tier, on the card) and each cut moves the
        (max_slots, 1, D) hidden through its hop. Returns (logits
        (max_slots, V) float32, the pool, written in place)."""
        self._check_decode_supported()
        codec = self._pool_codec(pool)
        if self.pipelined and codec != "fp":
            raise ValueError("quantized paged decode composes with the unpipelined split "
                             "runtime only (n_micro must be 1)")
        page_table = torch.as_tensor(page_table)
        lengths = torch.as_tensor(lengths)
        rows = page_table.shape[0]
        if self.pipelined:
            rows = self.pipeline.validate_batch(rows, "paged decode slots")
        # the deepest slot's fill level keys the link (host lengths: no sync)
        deepest = int(lengths.max()) if self._link is not None else 0
        ids = torch.as_tensor(token_ids).reshape(-1, 1).to(self.devices[0], torch.long)
        hidden = embed(placed["first"], ids)  # (B, 1, D)
        tables = {d: (page_table.to(d, torch.int32), lengths.to(d, torch.int32))
                  for d in set(self.devices)}

        def run_stage(s, h, mb=None):
            # a µ-batch sees only its own slots' page-table rows and lengths
            # (contiguous row views); the pool is shared by every slot
            pt, ln = tables[self.devices[s]]
            if mb is not None:
                pt, ln = pt[mb * rows:(mb + 1) * rows], ln[mb * rows:(mb + 1) * rows]
            return run_layers_paged(self.cfg, placed["stages"][s], h, self._stage_pool(pool, s),
                                    pt, ln, codec)

        out = self._run_stages(run_stage, hidden, None, self._step_key(deepest),
                               microbatched=True)
        return unembed(self.cfg, placed["last"], out)[:, -1], pool
