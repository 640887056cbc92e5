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

Not ported yet: the link on the decode, verify and paged paths (they raise
under an active link), the micro-batch pipeline and the "data" / "model"
mesh axes (each raises naming its argument), the micro-batched decode
accounting (``pipelined_decode_hop_bytes``) and stage loss
(``mark_stage_lost``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..codecs.codec_kernels import pallas_variant
from ..codecs.faults import FaultyLink, LinkPolicy, fault_key, sum_counters
from ..codecs.fused_hop import fused_hop, fused_hop_plan
from ..codecs.packing import WireCodec, get_wire_codec
from ..models.configs import ModelConfig
from ..models.flash_attention import dequantize_kv_rows, quantize_kv_rows
from ..models.paged_kv import (KVTierMismatchError, _host, _rows_get, _rows_set,
                               resolve_kv_codec, run_layers_paged)
from ..models.transformer import (block_decode, block_verify, embed, precompute_rope,
                                  run_layers, unembed)

NOT_PORTED_MSG = "is not ported yet to edgellm_tpu_torch"


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
    moved = {k: v.to(dst, copy=True) for k, v in payload.items()}
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
    value then becomes ``(out, counters)``, this call's per-hop counters."""
    devices = devices if devices is not None else [hidden.device] * n_stages
    counters = link.init_counters(n_stages - 1) if link is not None else None
    for s in range(n_stages):
        hidden = run_stage(s, hidden)
        if s < n_stages - 1:
            if link is not None:
                imp = hop_imps[s] if codecs[s].needs_importance else None
                hidden = link.hop(codecs[s], hidden, s, devices[s + 1], fault_key, counters,
                                  hop_imp=imp)
                continue
            if fused_plans is not None and fused_plans[s] is not None:
                hidden = fused_hop(fused_plans[s], codecs[s], hidden, devices[s + 1])
                continue
            imp = hop_imps[s] if codecs[s].needs_importance else None
            decoded = _hop(codecs[s], hidden, imp, devices[s + 1])
            hidden = decoded.to(torch.promote_types(decoded.dtype, hidden.dtype))
    if link is None:
        return hidden
    return hidden, counters


def hop_payload_bytes(codecs, cfg: ModelConfig, batch: int, seq: int) -> list:
    """Measured payload bytes per hop for one (batch, seq, D) boundary
    activation."""
    shape = (batch, seq, cfg.hidden_size)
    return [c.payload_bytes(shape) for c in codecs]


def measure_hop_times(codecs, cfg: ModelConfig, batch: int, seq: int,
                      devices: Sequence, *, iters: int = 20, warmup: int = 1) -> list:
    """Per-hop boundary-transfer time (ms): encode -> copy to the next
    stage's device -> decode of one random (batch, seq, D) float32
    activation, apart from the stage compute. ``warmup`` is clamped to >= 1
    (the first call builds and loads the kernels). On one CUDA device the
    time is CUDA events around ``iters`` hops; across devices or on the CPU
    it is the host clock between synchronisations."""
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
                 devices: Optional[Sequence] = None, *,
                 faults=None, policy=None, fec=None, hedge=None, pipeline=None,
                 n_data: int = 1, n_model: int = 1):
        if pipeline is not None:
            raise ValueError(f"SplitRuntime pipeline {NOT_PORTED_MSG}")
        for name, value in (("n_data", n_data), ("n_model", n_model)):
            if value != 1:
                raise ValueError(f"SplitRuntime {name} > 1 (the {name[2:]!r} mesh axis) "
                                 f"{NOT_PORTED_MSG}")
        self.cfg = cfg
        self.split = split
        # an all-zero-rate config builds no link: the hop is the fault-free one
        self._link = (FaultyLink(faults, policy if policy is not None else LinkPolicy(),
                                 fec=fec, hedge=hedge)
                      if faults is not None and faults.enabled else None)
        self._counter_accum: list = []
        n_stages = split.n_stages
        devices = ["cuda"] * n_stages if devices is None else list(devices)
        if len(devices) != n_stages:
            raise ValueError(f"{len(devices)} stage devices given, split needs {n_stages}")
        self.devices = [torch.device(d) for d in devices]
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

    # ---------- parameter placement ----------

    def place_params(self, params: dict) -> dict:
        """Each stage's layer slice on its device, the embedding on the first
        stage's and the final norm and head on the last stage's. A stage
        behind a separate (unfused) hop computes in float32 (see the module
        note), so its floating weights are held in float32; an unchanged
        slice on its own device is a view, not a copy."""
        layers = params["layers"]
        stages = []
        for s, ((start, stop), dev) in enumerate(zip(self.bounds, self.devices)):
            promoted = any(plan is None for plan in self.fused_plans[:s])
            stage = {}
            for name, t in layers.items():
                dtype = (torch.promote_types(t.dtype, torch.float32)
                         if promoted and t.is_floating_point() else None)
                stage[name] = t[start:stop].to(device=dev, dtype=dtype)
            stages.append(stage)
        rest = {k: v for k, v in params.items() if k != "layers"}
        return {"stages": stages,
                "first": {k: v.to(self.devices[0]) for k, v in rest.items()},
                "last": {k: v.to(self.devices[-1]) for k, v in rest.items()}}

    # ---------- forward ----------

    def _stacked_importance(self, hop_importance, batch: int, seq: int) -> list:
        """Validate the per-hop importance entries and shape them as the
        reference stacks them: every entry (S,), or every entry (B, S) when
        any is per-row or a token-selective hop runs at batch > 1."""
        n_hops = len(self.codecs)
        imps = list(hop_importance) if hop_importance is not None else [None] * n_hops
        if len(imps) != n_hops:
            raise ValueError(f"expected {n_hops} hop_importance entries, got {len(imps)}")
        imps = [None if i is None else torch.as_tensor(i) for i in imps]
        for c, imp in zip(self.codecs, imps):
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
            batch > 1 and any(c.needs_importance for c in self.codecs))
        shape = (batch, seq) if per_row else (seq,)
        return [torch.zeros(shape, dtype=torch.float32, device=dev) if i is None
                else torch.broadcast_to(i.to(device=dev, dtype=torch.float32), shape)
                for i, dev in zip(imps, self.devices)]

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
        per-hop counters accumulate on the runtime (:meth:`link_counters`)."""
        batch, seq = input_ids.shape
        imps = self._stacked_importance(hop_importance, batch, seq)
        hidden = embed(placed["first"], input_ids.to(self.devices[0]))

        def run_stage(s, h):
            stage = placed["stages"][s]
            n_layers = self.bounds[s][1] - self.bounds[s][0]
            return run_layers(self.cfg, {"layers": stage}, h, start=0, stop=n_layers)[0]

        if self._link is None:
            out = run_pipeline_stages(self.split.n_stages, self.codecs, run_stage, hidden,
                                      imps, self.devices, self.fused_plans)
            return unembed(self.cfg, placed["last"], out)
        out, counters = run_pipeline_stages(
            self.split.n_stages, self.codecs, run_stage, hidden, imps, self.devices,
            link=self._link, fault_key=fault_key(self._link.faults.seed, fault_step))
        self._counter_accum.append(counters)
        return unembed(self.cfg, placed["last"], out)

    # ---------- the faulty link's accounting ----------

    @property
    def link(self) -> Optional[FaultyLink]:
        """The faulty link, or None when faults are off."""
        return self._link

    def link_counters(self, reset: bool = False) -> Optional[dict]:
        """Per-hop fault counters accumulated over every forward so far:
        {name: (n_hops,) int64}. None when faults are off."""
        if self._link is None:
            return None
        tot = sum_counters(self._counter_accum)
        if tot is None:
            tot = self._link.init_counters(len(self.codecs))
        if reset:
            self._counter_accum = []
        return tot

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
        if self._link is not None:
            raise ValueError("SplitRuntime decode, verify and paged steps under an active "
                             f"faulty link: the link there {NOT_PORTED_MSG}")
        bad = [c.name for c in self.codecs if c.needs_importance]
        if bad:
            raise ValueError(
                f"token-selective hop codecs {bad} have no importance source "
                f"for a single decode position; use per-token/channel codecs")

    def _run_cached(self, placed: dict, cache: dict, token_ids: torch.Tensor, block_fn):
        """Embed the (B, K) ids at positions ``length ..``, run every stage's
        layers through ``block_fn`` (:func:`block_decode` or
        :func:`block_verify`: each writes its rows into the stage's cache in
        place), crossing each cut as the forward does -> the last stage's
        (B, K, D) hidden."""
        pos, kq, capacity = int(cache["length"]), token_ids.shape[1], cache["capacity"]
        if pos + kq > capacity:
            raise ValueError(f"cache capacity overflow: {pos} filled + {kq} new > "
                             f"capacity {capacity}")
        hidden = embed(placed["first"], token_ids.to(self.devices[0]))

        def run_stage(s, h):
            cos, sin = precompute_rope(self.cfg, capacity, device=h.device)
            kc, vc = cache["k"][s], cache["v"][s]
            for i in range(kc.shape[0]):
                lp = {name: t[i] for name, t in placed["stages"][s].items()}
                h = block_fn(self.cfg, lp, h, cos[pos:pos + kq], sin[pos:pos + kq],
                             kc[i], vc[i], pos)
            return h

        return run_pipeline_stages(self.split.n_stages, self.codecs, run_stage, hidden,
                                   None, self.devices, self.fused_plans)

    def prefill_decode(self, placed: dict, input_ids: torch.Tensor, capacity: int) -> tuple:
        """Pipeline-split prefill that also fills the per-stage KV caches ->
        (logits (B, S, V) float32, cache). The cache dict holds ``k`` and
        ``v`` (one (layers_of_stage, B, capacity, KV, hd) tensor per stage, on
        the stage's device, in the embedding's dtype), ``length`` (S) and
        ``capacity``; feed it to :meth:`decode_step` or :meth:`verify_step`."""
        self._check_decode_supported()
        b, s = input_ids.shape
        capacity = int(capacity)
        if not 0 < s <= capacity:
            raise ValueError(f"prompt length {s} must be in [1, capacity={capacity}]")
        hidden = embed(placed["first"], input_ids.to(self.devices[0]))
        cache_dtype = hidden.dtype
        ks, vs = [], []

        def run_stage(st, h):
            n_layers = self.bounds[st][1] - self.bounds[st][0]
            out, aux = run_layers(self.cfg, {"layers": placed["stages"][st]}, h,
                                  stop=n_layers, collect_kv=True)
            k, v = aux["kv"]  # (layers, B, S, KV, hd)
            shape = k.shape[:2] + (capacity,) + k.shape[3:]
            kc = torch.zeros(shape, dtype=cache_dtype, device=k.device)
            vc = torch.zeros(shape, dtype=cache_dtype, device=v.device)
            kc[:, :, :s] = k
            vc[:, :, :s] = v
            ks.append(kc)
            vs.append(vc)
            return out

        out = run_pipeline_stages(self.split.n_stages, self.codecs, run_stage, hidden,
                                  None, self.devices, self.fused_plans)
        logits = unembed(self.cfg, placed["last"], out)
        return logits, {"k": ks, "v": vs, "length": s, "capacity": capacity}

    def decode_step(self, placed: dict, cache: dict, token_ids: torch.Tensor) -> tuple:
        """One decode position across the pipeline: (B,) token ids -> (logits
        (B, V) float32, the cache with ``length + 1``; its rows written in
        place). Each cut moves the (B, 1, D) hidden through its hop."""
        self._check_decode_supported()
        out = self._run_cached(placed, cache, token_ids.reshape(-1, 1), block_decode)
        logits = unembed(self.cfg, placed["last"], out)[:, -1]
        return logits, {**cache, "length": int(cache["length"]) + 1}

    def decode_hop_bytes(self, batch: int) -> list:
        """Payload bytes per hop of one decode step's (batch, 1, D) hidden."""
        return hop_payload_bytes(self.codecs, self.cfg, batch, 1)

    # ---------- speculative verify ----------

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
        page_table = torch.as_tensor(page_table)
        lengths = torch.as_tensor(lengths)
        ids = torch.as_tensor(token_ids).reshape(-1, 1).to(self.devices[0], torch.long)
        hidden = embed(placed["first"], ids)  # (B, 1, D)

        def run_stage(s, h):
            dev = self.devices[s]
            return run_layers_paged(self.cfg, placed["stages"][s], h, self._stage_pool(pool, s),
                                    page_table.to(dev, torch.int32),
                                    lengths.to(dev, torch.int32), codec)

        out = run_pipeline_stages(self.split.n_stages, self.codecs, run_stage, hidden,
                                  None, self.devices, self.fused_plans)
        return unembed(self.cfg, placed["last"], out)[:, -1], pool
