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

Not ported yet: the faulty link, FEC, hedging, the micro-batch pipeline and
the "data" / "model" mesh axes (each raises naming its argument), and the
decode, verify and paged methods.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import torch

from ..codecs.codec_kernels import pallas_variant
from ..codecs.fused_hop import fused_hop, fused_hop_plan
from ..codecs.packing import WireCodec, get_wire_codec
from ..models.configs import ModelConfig
from ..models.transformer import embed, run_layers, unembed

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
                        fused_plans: Optional[Sequence] = None):
    """Run ``run_stage(s, hidden)`` for every stage in order, crossing each
    cut as encode -> copy to ``devices[s + 1]`` -> decode. After a cut the
    hidden takes the promotion of its dtype and the decoded float32, as the
    reference's select does. ``fused_plans`` (one ``FusedHopPlan`` or None
    per cut) routes a hop through :func:`~..codecs.fused_hop.fused_hop`
    instead, which keeps the hidden's dtype."""
    devices = devices if devices is not None else [hidden.device] * n_stages
    for s in range(n_stages):
        hidden = run_stage(s, hidden)
        if s < n_stages - 1:
            if fused_plans is not None and fused_plans[s] is not None:
                hidden = fused_hop(fused_plans[s], codecs[s], hidden, devices[s + 1])
                continue
            imp = hop_imps[s] if codecs[s].needs_importance else None
            decoded = _hop(codecs[s], hidden, imp, devices[s + 1])
            hidden = decoded.to(torch.promote_types(decoded.dtype, hidden.dtype))
    return hidden


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
        for name, value in (("faults", faults), ("policy", policy), ("fec", fec),
                            ("hedge", hedge), ("pipeline", pipeline)):
            if value is not None:
                raise ValueError(f"SplitRuntime {name} {NOT_PORTED_MSG}")
        for name, value in (("n_data", n_data), ("n_model", n_model)):
            if value != 1:
                raise ValueError(f"SplitRuntime {name} > 1 (the {name[2:]!r} mesh axis) "
                                 f"{NOT_PORTED_MSG}")
        self.cfg = cfg
        self.split = split
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
        # EDGELLM_FUSED_HOP now
        self.fused_plans: list = [fused_hop_plan(c, device=self.devices[s])
                                  for s, c in enumerate(self.codecs)]

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
                hop_importance: Optional[Sequence] = None) -> torch.Tensor:
        """ids (B, S) -> float32 logits (B, S, V) on the last stage's device,
        every cut crossed as a packed payload.

        ``hop_importance``: one entry per hop, required for token-selective
        hops (None elsewhere); each (S,), or (B, S) when batching evaluation
        windows so every window keeps its own ordering and codec scale."""
        batch, seq = input_ids.shape
        imps = self._stacked_importance(hop_importance, batch, seq)
        hidden = embed(placed["first"], input_ids.to(self.devices[0]))

        def run_stage(s, h):
            stage = placed["stages"][s]
            n_layers = self.bounds[s][1] - self.bounds[s][0]
            return run_layers(self.cfg, {"layers": stage}, h, start=0, stop=n_layers)[0]

        out = run_pipeline_stages(self.split.n_stages, self.codecs, run_stage, hidden,
                                  imps, self.devices, self.fused_plans)
        return unembed(self.cfg, placed["last"], out)

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
