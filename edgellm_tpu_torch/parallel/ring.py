"""Ring attention and the stage x seq split runtime: long contexts with the
sequence sharded into ``n_seq`` blocks (PyTorch counterpart of
``edgellm_tpu/parallel/ring.py``).

The reference shards the sequence over a "seq" mesh axis: every device
holds 1/n of the tokens, attention runs blockwise while the K/V blocks
rotate around the ring (``lax.ppermute``), and an online softmax keeps
(max, denominator, accumulator) per query, so no device holds the S x S
scores. Here the n shards of a stage run in turn on one device, as the
split's stages do (``parallel/split.py``): a stage's activation is a list
of n (B, S_loc, D) shard tensors, the per-token parts of a block (norms,
projections, MLP) run shard by shard, and :func:`ring_attention` takes the
lists of every shard's q, k and v and merges the blocks in the order the
ring delivers them. Every report of a ring result says so: on one card the
shards share the device, and nothing crosses a link between them.

Shard i at ring step t takes key block ``(i - t) mod n``. A block whose
every key lies after every query of the shard (source > i) adds exactly 0
to the denominator and the accumulator and leaves the max as it is (its
correction is exp(0) = 1), so ``skip_masked`` (the default) leaves those
blocks out: the same bits at about half the work. The statistics pass
(``capture_stats``) is the reference's second rotation: block j's
column-sum accumulator visits the query shards j, j+1, ..., j+n-1 (mod n)
in that order (the shards before j add exact zeros and are left out the
same way), and the last row comes from shard n - 1 alone. The reference
has no kernel for any of this: its blocks are einsums and its merge is
plain ops, and so are the port's (K-attn is causal inside one block and
cannot compute the ring's off-diagonal blocks).

:class:`SplitRingRuntime` composes the ring with the pipeline split: the
layer stack is cut into stages, within each stage the sequence is
ring-sharded, and each shard crosses every cut with its own payload
(``run_pipeline_stages`` over the list of shards): a per-token codec
encodes the shard's rows (K1 / K2, K3 / K4 on the card, one launch a shard
a hop), a ring codec (``codecs/ring_codecs.py``) agrees on the token
selection and scale across the shards first. Under the faulty link shard i
of a call draws its faults from ``fold_in(fold_in(key(seed), fault_step),
i)`` and the counters add up over the shards.

Every entry point runs on ``device`` ("cuda" unless the caller asks for
the CPU).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..codecs.faults import FaultyLink, LinkPolicy, fault_key, sum_counters
from ..codecs.ring_codecs import RingWireCodec
from ..codecs.wire_format import flatten_bytes, unflatten_bytes
from ..importance.metrics import importance_per_layer
from ..models.configs import ModelConfig
from ..models.transformer import (AttnStats, _block_norm, apply_rotary, embed, mlp,
                                  params_to, precompute_rope, project_out, project_qkv,
                                  unembed)
from ..serve.recovery import StageLostError
from .split import (SplitConfig, apply_default_codec_backend, hop_payload_bytes,
                    measure_hop_times, place_stage_params, run_pipeline_stages,
                    stacked_importance)

NEG_INF = -1e30  # finite mask value: keeps exp() well defined for masked scores


def _heads(x: torch.Tensor, rep: int) -> torch.Tensor:
    """GQA: each KV head repeated ``rep`` times in place (``jnp.repeat``)."""
    return x.repeat_interleave(rep, dim=2) if rep > 1 else x


def _block_source(ks: list, vs: list, kv_codec):
    """``source(j, want_v)`` -> key block j (and its values): the blocks as
    they are, or with ``kv_codec`` each home block encoded once into one flat
    byte buffer (K and V payloads together; K alone for the statistics pass)
    and every use decoding that buffer, as the reference circulates it."""
    if kv_codec is None:
        return lambda j, want_v=True: (ks[j], vs[j] if want_v else None)
    b, s_loc, kv, hd = ks[0].shape
    payloads = [{"k": kv_codec.encode(k.reshape(b, s_loc, kv * hd)),
                 "v": kv_codec.encode(v.reshape(b, s_loc, kv * hd))}
                for k, v in zip(ks, vs)]
    kv_wires = [flatten_bytes(p) for p in payloads]
    k_wires = [flatten_bytes(p["k"]) for p in payloads]

    def decode(payload, like):
        return kv_codec.decode(payload).reshape(b, s_loc, kv, hd).to(like.dtype)

    def source(j, want_v=True):
        if want_v:
            p = unflatten_bytes(kv_wires[j], payloads[j])
            return decode(p["k"], ks[j]), decode(p["v"], vs[j])
        return decode(unflatten_bytes(k_wires[j], payloads[j]["k"]), ks[j]), None

    return source


def ring_attention(qs: list, ks: list, vs: list, capture_stats: bool = False,
                   kv_codec=None, skip_masked: bool = True):
    """Causal ring attention over n sequence shards: ``qs`` the shards'
    (B, S_loc, H, hd) queries, ``ks`` / ``vs`` their (B, S_loc, KV, hd) keys
    and values (KV may divide H: grouped-query heads repeat per block) ->
    the list of (B, S_loc, H, hd) outputs in the query dtype.

    Scores and the merge are float32 (the reference's einsums with a float32
    result). ``capture_stats`` also returns each key block's reduced
    statistics, ``[(col_sum / S, last_row)]`` (B, H, S_loc) float32, from a
    second pass over the final (max, denominator) of every query row.
    ``kv_codec`` (a per-token ``WireCodec``, opt-in and lossy) encodes each
    home K / V block once into one flat byte buffer and decodes it at every
    use. ``skip_masked`` leaves out the blocks that lie wholly after a
    shard's queries (see the module note: the same bits)."""
    n = len(qs)
    b, s_loc, h, hd = qs[0].shape
    rep = h // ks[0].shape[2]
    scale = float(np.float32(1.0) / np.sqrt(np.float32(hd)))
    dev = qs[0].device
    pos = torch.arange(s_loc, device=dev)
    source = _block_source(ks, vs, kv_codec)

    def scores_for(i, k_blk, src):
        q_pos, k_pos = i * s_loc + pos, src * s_loc + pos
        scores = torch.einsum("bshd,bthd->bhst", qs[i].float(),
                              _heads(k_blk, rep).float()) * scale
        mask = q_pos[:, None] >= k_pos[None, :]  # global causal
        return torch.where(mask, scores, NEG_INF), mask

    outs, finals = [], []
    for i in range(n):
        m = torch.full((b, h, s_loc), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((b, h, s_loc), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, h, s_loc, hd), dtype=torch.float32, device=dev)
        for t in range(n):
            src = (i - t) % n  # which global block arrives at this step
            if skip_masked and src > i:
                break  # every later step brings a block after the queries too
            k_blk, v_blk = source(src)
            scores, mask = scores_for(i, k_blk, src)
            m_new = torch.maximum(m, scores.amax(dim=-1))
            p = torch.exp(scores - m_new[..., None]) * mask
            correction = torch.exp(m - m_new)
            l = l * correction + p.sum(dim=-1)
            acc = acc * correction[..., None] + torch.einsum(
                "bhst,bthd->bhsd", p, _heads(v_blk, rep).float())
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]  # (B, H, S_loc, hd)
        outs.append(out.permute(0, 2, 1, 3).to(qs[i].dtype))
        finals.append((m, torch.clamp(l, min=1e-30)))
    if not capture_stats:
        return outs

    # the second rotation: exact probabilities from the final (m, l); block
    # j's accumulators meet the query shards j, j+1, ... in the ring's order
    s_total = n * s_loc
    stats = []
    for j in range(n):
        k_blk = source(j, want_v=False)[0]
        col = torch.zeros((b, h, s_loc), dtype=torch.float32, device=dev)
        last = torch.zeros((b, h, s_loc), dtype=torch.float32, device=dev)
        for t in range(n):
            i = (j + t) % n  # the query shard block j visits at this step
            if skip_masked and i < j:
                break  # the queries before block j see none of its keys
            scores, mask = scores_for(i, k_blk, j)
            m, l_safe = finals[i]
            probs = torch.exp(scores - m[..., None]) * mask / l_safe[..., None]
            col = col + probs.sum(dim=2)
            if i == n - 1:  # the shard holding the globally last query row
                last = last + probs[:, :, -1, :]
        stats.append((col / s_total, last))
    return outs, stats


def _sp_attention(cfg: ModelConfig, lp: dict, xs: list, ropes: list,
                  capture_stats: bool = False, kv_codec=None):
    """One layer's attention over the shards' (B, S_loc, D) inputs -> (the
    shards' (B, S_loc, D) outputs, the blocks' stats or None)."""
    qs, ks, vs = [], [], []
    for x, (cos, sin) in zip(xs, ropes):
        q, k, v = project_qkv(cfg, lp, x)
        qs.append(apply_rotary(q, cos, sin, cfg.rotary_dim))
        ks.append(apply_rotary(k, cos, sin, cfg.rotary_dim))
        vs.append(v)
    # GQA: the unexpanded KV-head blocks make the ring; heads repeat per block
    got = ring_attention(qs, ks, vs, capture_stats=capture_stats, kv_codec=kv_codec)
    outs, stats = got if capture_stats else (got, None)
    return [project_out(lp, o) for o in outs], stats


def _sp_block(cfg: ModelConfig, lp: dict, hiddens: list, ropes: list,
              capture_stats: bool = False, kv_codec=None):
    """A decoder block with ring attention; norms and the MLP are per token,
    so they run shard by shard -> (the shards' hiddens, stats or None).
    GPT-NeoX: parallel residual; Qwen2 / Llama: sequential."""
    attn, stats = _sp_attention(cfg, lp, [_block_norm(cfg, lp, h, 1) for h in hiddens],
                                ropes, capture_stats, kv_codec)
    if cfg.family == "gpt_neox":
        return [h + a + mlp(cfg, lp, _block_norm(cfg, lp, h, 2))
                for h, a in zip(hiddens, attn)], stats
    hiddens = [h + a for h, a in zip(hiddens, attn)]
    return [h + mlp(cfg, lp, _block_norm(cfg, lp, h, 2)) for h in hiddens], stats


def _shards(cfg: ModelConfig, embed_params: dict, input_ids: torch.Tensor, n_seq: int,
            device) -> tuple:
    """ids (B, S) -> (the n shards' embedded (B, S / n, D) hiddens, their
    rotary (cos, sin) slices); S must split into n equal blocks."""
    seq = input_ids.shape[1]
    if seq % n_seq:
        raise ValueError(f"sequence length {seq} not divisible by seq axis size {n_seq}")
    s_loc = seq // n_seq
    ids = torch.as_tensor(input_ids).to(device)
    cos, sin = precompute_rope(cfg, seq, device=device)
    blocks = [slice(i * s_loc, (i + 1) * s_loc) for i in range(n_seq)]
    return ([embed(embed_params, ids[:, blk]) for blk in blocks],
            [(cos[blk], sin[blk]) for blk in blocks])


def forward_sp(cfg: ModelConfig, params: dict, input_ids, n_seq: int, *, device="cuda",
               kv_codec=None) -> torch.Tensor:
    """Sequence-parallel forward: ids (B, S), S split into ``n_seq`` shards
    -> float32 logits (B, S, V). Attention runs as the K/V ring; ``kv_codec``
    (opt-in, lossy) compresses the ring's K / V blocks (:func:`ring_attention`)."""
    cfg.require_uniform("forward_sp")
    params = params_to(params, device=device)
    hiddens, ropes = _shards(cfg, params, input_ids, n_seq, device)
    for lp in params["layers"]:
        hiddens, _ = _sp_block(cfg, lp, hiddens, ropes, kv_codec=kv_codec)
    return torch.cat([unembed(cfg, params, h) for h in hiddens], dim=1)


def importance_sp(cfg: ModelConfig, params: dict, input_ids, n_seq: int, method: str,
                  head_weights=None, *, device="cuda") -> torch.Tensor:
    """Sequence-parallel importance: the (L, B, S) scores of
    ``importance_per_layer``, from the attention statistics the ring's
    second pass accumulates, each shard's slice computed from its own key
    block's statistics (every method is per token over reduced stats). No
    S x S buffer is built; the values are the dense stats forward's up to
    the blockwise softmax's roundoff."""
    cfg.require_uniform("importance_sp")
    if method == "weighted_importance" and head_weights is None:
        raise ValueError("weighted_importance requires head_weights (L, H)")
    hw = (None if head_weights is None else
          torch.as_tensor(head_weights, dtype=torch.float32, device=device))
    params = params_to(params, device=device)
    hiddens, ropes = _shards(cfg, params, input_ids, n_seq, device)
    per_layer = []
    for lp in params["layers"]:
        hiddens, stats = _sp_block(cfg, lp, hiddens, ropes, capture_stats=True)
        per_layer.append(stats)
    layers = tuple(range(cfg.num_layers))
    return torch.cat([
        importance_per_layer(AttnStats(col_mean=torch.stack([st[j][0] for st in per_layer]),
                                       last_row=torch.stack([st[j][1] for st in per_layer]),
                                       layers=layers),
                             method, hw)
        for j in range(n_seq)], dim=-1)


class SplitRingRuntime:
    """The pipeline split with each stage's sequence ring-sharded into
    ``n_seq`` shards, every stage on ``device`` (the shards and the stages
    run in turn on it).

    Usage::

        rt = SplitRingRuntime(cfg, (11,), ("int4_per_token",), n_seq=4)
        placed = rt.place_params(params)
        logits = rt.forward(placed, ids)   # each shard crosses the cut alone

    Hop codecs must be per token (``batch_invariant``: encoding a shard's
    rows equals encoding them within the whole sequence) or ring-aware
    (:class:`~..codecs.ring_codecs.RingWireCodec`, built for the same
    ``n_seq``); others are refused, as in the reference. The faulty link
    (``faults``, ``policy``, ``fec``, ``hedge``) is the split runtime's, each
    shard keyed apart. No hop fuses, and there is no decode surface: the
    runtime is a whole-window forward."""

    def __init__(self, cfg: ModelConfig, cuts, hop_codecs, n_seq: int, device="cuda", *,
                 faults=None, policy=None, fec=None, hedge=None):
        if isinstance(n_seq, bool) or not isinstance(n_seq, int) or n_seq < 1:
            raise ValueError(f"n_seq must be a positive integer, got {n_seq!r}")
        cfg.require_uniform("SplitRingRuntime")
        self.cfg = cfg
        self.n_seq = n_seq
        self.faults = faults
        self.policy = policy if policy is not None else LinkPolicy()
        self.fec = fec
        self.hedge = hedge
        # an all-zero-rate config builds no link: the hop is the fault-free one
        self._link = (FaultyLink(faults, self.policy, fec=fec, hedge=hedge)
                      if faults is not None and faults.enabled else None)
        self._counter_accum: list = []
        self._lost_stage: Optional[int] = None
        self.split = SplitConfig(cuts=tuple(cuts), hop_codecs=tuple(hop_codecs))
        self.devices = [torch.device(device)] * self.split.n_stages
        self.codecs = apply_default_codec_backend(list(self.split.hop_codecs), self.devices[0])
        bad = [c.name for c in self.codecs
               if not c.batch_invariant and not isinstance(c, RingWireCodec)]
        if bad:
            raise ValueError(
                f"stage x seq hops need per-token or ring-aware codecs; {bad} "
                f"reduce over batch/sequence and would disagree across "
                f"sequence shards")
        for c in self.codecs:
            if isinstance(c, RingWireCodec) and c.n_seq != n_seq:
                raise ValueError(f"ring codec {c.name} was built for 'seq' x{c.n_seq}, "
                                 f"the runtime has 'seq' x{n_seq}")
        self.bounds = self.split.stage_bounds(cfg.num_layers)
        self.stage_size = max(stop - start for start, stop in self.bounds)

    def mark_stage_lost(self, stage: int) -> None:
        """As ``SplitRuntime.mark_stage_lost``: later forwards raise the typed
        :class:`~..serve.recovery.StageLostError`. The stage x seq ring has no
        failover re-planning (the eval refuses ``stage_failure`` with
        ``n_seq > 1``)."""
        if not 0 <= stage < self.split.n_stages:
            raise ValueError(f"stage {stage} out of range for {self.split.n_stages} stages")
        self._lost_stage = stage

    def place_params(self, params: dict) -> dict:
        """Each stage keeps only its own layers; every stage after the first
        sits behind a separate hop, whose float32 decode promotes the
        hidden, so its floating weights are held in float32."""
        return place_stage_params(params, self.bounds, self.devices,
                                  [None] * len(self.codecs))

    def forward(self, placed: dict, input_ids, hop_importance=None,
                fault_step: int = 0) -> torch.Tensor:
        """ids (B, S) -> float32 logits (B, S, V): layers stage-split, the
        sequence ring-sharded, each shard's payload crossing every cut.

        ``hop_importance``: one (S,) / (B, S) entry per hop for importance
        hops (:func:`importance_sp`'s slices), split over the shards beside
        the hidden. ``fault_step``: the link's per-call fold; each shard
        folds its index on top, and the counters accumulate on the runtime
        (:meth:`link_counters`)."""
        if self._lost_stage is not None:
            raise StageLostError(self._lost_stage)
        input_ids = torch.as_tensor(input_ids)
        batch, seq = input_ids.shape
        hiddens, ropes = _shards(self.cfg, placed["first"], input_ids, self.n_seq,
                                 self.devices[0])
        s_loc = seq // self.n_seq
        imps = [[imp[..., i * s_loc:(i + 1) * s_loc] for i in range(self.n_seq)]
                for imp in stacked_importance(self.codecs, hop_importance, batch, seq,
                                              self.devices)]

        def run_stage(s, shards):
            for lp in placed["stages"][s]:
                shards, _ = _sp_block(self.cfg, lp, shards, ropes)
            return shards

        link = self._link
        got = run_pipeline_stages(self.split.n_stages, self.codecs, run_stage, hiddens, imps,
                                  self.devices, link=link,
                                  fault_key=None if link is None else
                                  fault_key(link.faults.seed, fault_step))
        if link is not None:
            got, counters = got
            self._counter_accum.append(counters)
        return torch.cat([unembed(self.cfg, placed["last"], h) for h in got], dim=1)

    def link_counters(self, reset: bool = False) -> Optional[dict]:
        """Per-hop fault counters summed over every forward and every shard:
        {name: (n_hops,) int64}. None when faults are off."""
        if self._link is None:
            return None
        tot = sum_counters(self._counter_accum)
        if tot is None:
            tot = self._link.init_counters(len(self.codecs))
        if reset:
            self._counter_accum = []
        return tot

    def hop_bytes(self, batch: int, seq: int) -> list:
        """Payload bytes per hop for one (batch, seq, D) activation, summed
        over the ``n_seq`` shard payloads (per-token payloads add up over
        the sequence; a ring codec counts its own)."""
        return hop_payload_bytes(self.codecs, self.cfg, batch, seq)

    def bytes_per_token(self, seq: int) -> list:
        """Per-hop boundary bytes per token."""
        return [b / seq for b in self.hop_bytes(1, seq)]

    def decode_hop_bytes(self, batch: int) -> list:
        """Nothing crosses a wire per decode step: the ring runtime has no
        decode surface (here for the ``CounterSource`` protocol)."""
        return []

    def time_hops(self, batch: int, seq: int, iters: int = 20, warmup: int = 1) -> list:
        """Per-hop transfer time (ms) with the probe activation split into
        the ``n_seq`` shards the runtime's hops move: every shard's encode ->
        copy -> decode (on one card, in turn)."""
        if seq % self.n_seq:
            raise ValueError(f"seq {seq} not divisible by the seq axis ({self.n_seq})")
        return measure_hop_times(self.codecs, self.cfg, batch, seq, self.devices,
                                 iters=iters, warmup=warmup, n_seq=self.n_seq)


__all__ = ["NEG_INF", "ring_attention", "forward_sp", "importance_sp", "SplitRingRuntime"]
