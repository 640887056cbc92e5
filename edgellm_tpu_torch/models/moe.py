"""Sparse experts: LFM2's routed FFN (``Lfm2MoeSparseMoeBlock``), on a layer
told which experts it holds.

The router scores every one of the ``router_experts`` experts,
``s = sigmoid(x W_r)``, picks each token's ``num_experts_per_tok`` on the
biased score ``s + expert_bias``, and weights them with ``s`` at the picked
experts, divided by their sum (+ 1e-6) (``norm_topk_prob``) and scaled by
1.0 (``routed_scaling_factor``: LFM2-8B-A1B's values, constants here). Each
picked expert adds ``w * w2_e(silu(w1_e x) * w3_e x)``. No token is
dropped: there is no capacity.

Expert parallelism: a layer holds experts ``expert_offset`` ..
``expert_offset + num_experts - 1`` (``w13`` (E, D, 2F), gate then up, and
``w2`` (E, F, D), E = ``num_experts``). It routes over all of them and
computes only its held experts' part of the result, for the tokens routed
to them; what the others would add is another card's part. On one card
there is no exchange, and nothing stands in for the absent card.

The path never waits on the host: the (token, pick) pairs are sorted by
expert on the device (pairs for experts held elsewhere last), the per-expert
row offsets come from a ``searchsorted`` of the sorted ids, and both expert
products are one launch each of the grouped 3xTF32 kernel
(``gemm.grouped_gemm_tf32x3``), which reads the offsets itself. The
products run in float32 whatever the layer's dtype.

Spans (device-timed): ``moe.route`` (router product, sigmoid, biased top-k,
the sort and offsets, the gather of the rows), ``moe.experts`` (the two
grouped products and SiLU·up), ``moe.combine`` (the weighted sum back to the
tokens). Counters (:func:`read_counters`), kept only inside
:func:`counting`: rows routed to the held experts, rows of the busiest held
expert (each summed over layer calls), and dropped rows: pairs routed to a
held expert whose result no product wrote. Inside :func:`counting` both
products' outputs start as NaN, so a tile the kernel skipped, or a row left
out of every expert's range, reaches the combine as NaN and is counted.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from ..lint import graph_contract
from ..obs.tracing import device_span
from . import gemm
from .configs import ModelConfig

#: device-side sums over MoE layer calls inside :func:`counting`: (rows
#: routed to held experts, rows of each call's busiest held expert, rows
#: dropped), one per device
_COUNTS: dict = {}
_COUNTING = [False]
COUNTER_NAMES = ("moe_rows_routed", "moe_rows_busiest", "moe_rows_dropped")


def route(cfg: ModelConfig, lp: dict, x: torch.Tensor, linear):
    """x (T, D) -> (weights (T, k) float32, experts (T, k) int64): the
    router's picks over all ``router_experts`` and their weights. ``linear``
    is the model's product (``transformer.linear``)."""
    scores = torch.sigmoid(linear(x, lp["router"]).float())
    _, experts = torch.topk(scores + lp["expert_bias"].float(), cfg.num_experts_per_tok, dim=-1)
    weights = torch.gather(scores, 1, experts)
    return weights / (weights.sum(dim=-1, keepdim=True) + 1e-6), experts


def dispatch(experts: torch.Tensor, offset: int, held: int):
    """Pairs (token, pick) sorted by the held expert they go to -> (order
    (T k,) pair indices in expert order, offsets (held + 1,) int32 row
    offsets of each held expert in that order, held_mask (T, k)). Pairs
    routed elsewhere sort after every held expert's rows. No host sync."""
    local = experts.reshape(-1) - offset
    held_mask = (local >= 0) & (local < held)
    key = torch.where(held_mask, local, held)
    sorted_key, order = torch.sort(key, stable=True)
    bounds = torch.arange(held + 1, device=key.device, dtype=sorted_key.dtype)
    offsets = torch.searchsorted(sorted_key, bounds).to(torch.int32)
    return order, offsets, held_mask.reshape(experts.shape)


@contextlib.contextmanager
def counting():
    """Keep the counters over the MoE layer calls inside (each call then
    also fills its expert outputs with NaN and adds a few small launches)."""
    _COUNTING[0] = True
    try:
        yield
    finally:
        _COUNTING[0] = False


def _count(offsets: torch.Tensor, held_mask: torch.Tensor, picked: torch.Tensor):
    """picked (T, k, D): each pair's expert result, NaN where none was
    written."""
    rows = offsets[1:] - offsets[:-1]
    dropped = (held_mask & picked.isnan().any(dim=-1)).sum()
    step = torch.stack([held_mask.sum(), rows.max().to(torch.int64), dropped])
    key = str(offsets.device)
    _COUNTS[key] = _COUNTS[key] + step if key in _COUNTS else step


def read_counters(reset: bool = False) -> dict:
    """The counters summed over every device's MoE layer calls (a host
    read: it waits for the device)."""
    total = [0, 0, 0]
    for t in _COUNTS.values():
        total = [a + int(b) for a, b in zip(total, t.tolist())]
    if reset:
        _COUNTS.clear()
    return dict(zip(COUNTER_NAMES, total))


def experts_ffn(x: torch.Tensor, planes13: gemm.GroupedPlanes, planes2: gemm.GroupedPlanes,
                offsets: torch.Tensor, fill: float = None) -> torch.Tensor:
    """The held experts' SwiGLU over rows in expert order: x (M, D) ->
    (M, D) float32, each expert's rows through its own gate/up and down
    (two grouped launches); rows outside every held range are not written
    (they hold ``fill`` where one is given, else whatever the memory held)."""
    def out(n):
        return None if fill is None else x.new_full((x.shape[0], n), fill, dtype=torch.float32)

    h = gemm.grouped_gemm_tf32x3(x.float().contiguous(), planes13, offsets, out(planes13.rows))
    f = planes2.k
    act = F.silu(h[:, :f]) * h[:, f:]
    return gemm.grouped_gemm_tf32x3(act, planes2, offsets, out(planes2.rows))


# routing, the sort by expert and both grouped products on the device: no
# host sync, no hop, two grouped launches (gate / up, down)
@graph_contract("moe.experts", hops=0, launches={"grouped_gemm_tf32x3": 2})
def moe_ffn(cfg: ModelConfig, lp: dict, x: torch.Tensor, planes, linear) -> torch.Tensor:
    """The sparse FFN over x (B, S, D) -> (B, S, D) in x's dtype: the held
    experts' part of the routed sum. ``planes(w)`` returns the grouped planes
    of an expert weight (``transformer.prepared_grouped_planes``),
    ``linear`` the model's product (``transformer.linear``)."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    k = cfg.num_experts_per_tok
    counted = _COUNTING[0]
    with device_span("moe.route", x.device):
        weights, experts = route(cfg, lp, x2, linear)
        order, offsets, held_mask = dispatch(experts, cfg.expert_offset, lp["w13"].shape[0])
        rows = x2.index_select(0, order // k)
    with device_span("moe.experts", x.device):
        y = experts_ffn(rows, planes(lp["w13"]), planes(lp["w2"]), offsets,
                        float("nan") if counted else None)
    with device_span("moe.combine", x.device):
        pos = torch.empty_like(order)
        pos[order] = torch.arange(order.numel(), device=order.device)
        picked = y.index_select(0, pos).reshape(x2.shape[0], k, -1)
        if counted:
            _count(offsets, held_mask, picked)
        # rows of experts held elsewhere were never written: masked, not scaled
        part = torch.where(held_mask[..., None], picked * weights[..., None], 0.0)
        out = part.sum(dim=1)
    return out.to(x.dtype).reshape(shape)
