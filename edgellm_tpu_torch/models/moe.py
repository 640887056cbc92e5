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

The path never waits on the host and touches only the rows of pairs routed
to the held experts: the (token, pick) pairs are sorted by expert on the
device (pairs for experts held elsewhere last), the per-expert row offsets
come from a ``searchsorted`` of the sorted ids, one kernel
(:func:`gather_rows`, ``csrc/moe_rows.cu``) copies the held pairs' rows into
expert order and records each pair's row, both expert products are one
launch each of the grouped 3xTF32 kernel (``gemm.grouped_gemm_tf32x3``,
which reads the offsets itself; the gate / up launch stores silu(gate) * up
from its epilogue, over ``w13``'s glu planes), and one kernel
(:func:`combine_rows`) sums each token's held results, weighted, in pick
order. The products run in float32 whatever the layer's dtype. CPU tensors
take each kernel's plain version.

Spans (device-timed): ``moe.route`` (router product, sigmoid, biased top-k,
the sort and offsets, the gather of the rows), ``moe.experts`` (the two
grouped products, SiLU·up in the first), ``moe.combine`` (the weighted sum
back to the tokens). Counters (:func:`read_counters`), kept only inside
:func:`counting`: rows routed to the held experts, rows of the busiest held
expert, dropped rows (held rows whose result no product wrote) and all
(token, pick) pairs, held or not (each summed over layer calls), so that
routed / pairs is the share of pair rows the layer touches. Inside
:func:`counting` both products' outputs start as NaN, so a tile the kernel
skipped, or a held row left out of every expert's range, still holds NaN
after the down product and is counted.
"""
from __future__ import annotations

import contextlib
import ctypes

import torch

from ..lint import graph_contract
from ..obs.tracing import device_span
from ..utils import cuda_build
from . import gemm
from .configs import ModelConfig

#: device-side sums over MoE layer calls inside :func:`counting`: (rows
#: routed to held experts, rows of each call's busiest held expert, rows
#: dropped, (token, pick) pairs), one per device
_COUNTS: dict = {}
_COUNTING = [False]
COUNTER_NAMES = ("moe_rows_routed", "moe_rows_busiest", "moe_rows_dropped", "moe_pairs")


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
    offsets of each held expert in that order). Pairs routed elsewhere sort
    after every held expert's rows. No host sync."""
    local = experts.reshape(-1) - offset
    key = torch.where((local >= 0) & (local < held), local, held)
    sorted_key, order = torch.sort(key, stable=True)
    bounds = torch.arange(held + 1, device=key.device, dtype=sorted_key.dtype)
    offsets = torch.searchsorted(sorted_key, bounds).to(torch.int32)
    return order, offsets


@contextlib.contextmanager
def counting():
    """Keep the counters over the MoE layer calls inside (each call then
    also fills its expert outputs with NaN and adds a few small launches)."""
    _COUNTING[0] = True
    try:
        yield
    finally:
        _COUNTING[0] = False


def _count(offsets: torch.Tensor, y: torch.Tensor, pairs: int):
    """y (M, D): the down product's output, NaN where no product wrote; its
    rows below offsets[-1] are the held pairs'."""
    rows = offsets[1:] - offsets[:-1]
    held = torch.arange(y.shape[0], device=y.device) < offsets[-1]
    dropped = (held & y.isnan().any(dim=-1)).sum()
    step = torch.stack([(offsets[-1] - offsets[0]).to(torch.int64), rows.max().to(torch.int64),
                        dropped, torch.full((), pairs, dtype=torch.int64, device=y.device)])
    key = str(offsets.device)
    _COUNTS[key] = _COUNTS[key] + step if key in _COUNTS else step


def read_counters(reset: bool = False) -> dict:
    """The counters summed over every device's MoE layer calls (a host
    read: it waits for the device)."""
    total = [0] * len(COUNTER_NAMES)
    for t in _COUNTS.values():
        total = [a + int(b) for a, b in zip(total, t.tolist())]
    if reset:
        _COUNTS.clear()
    return dict(zip(COUNTER_NAMES, total))


def _lib() -> ctypes.CDLL:
    lib = cuda_build.library("moe_rows")
    if not getattr(lib, "_edgellm_declared", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.edgellm_moe_gather_rows.argtypes = [ptr] * 3 + [i32] * 4 + [ptr] * 3
        lib.edgellm_moe_gather_rows.restype = i32
        lib.edgellm_moe_combine.argtypes = [ptr] * 3 + [i32] * 3 + [ptr, i32, ptr]
        lib.edgellm_moe_combine.restype = i32
        lib.edgellm_moe_rows_error.argtypes = [i32]
        lib.edgellm_moe_rows_error.restype = ctypes.c_char_p
        lib._edgellm_declared = True
    return lib


def _launched(lib: ctypes.CDLL, what: str, err: int):
    if err:
        msg = lib.edgellm_moe_rows_error(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} ({msg})")


def _check_rows(name: str, t: torch.Tensor, dtype: torch.dtype, device: torch.device):
    if t.dtype != dtype or t.device != device or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous {dtype} on {device}, got "
                         f"{t.dtype} on {t.device}")


def gather_rows_plain(x: torch.Tensor, order: torch.Tensor, offsets: torch.Tensor,
                      k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`gather_rows` in plain PyTorch (rows past the held pairs' stay
    zero; reads offsets[-1] on the host)."""
    held = int(offsets[-1])
    rows = x.new_zeros((order.numel(), x.shape[1]), dtype=torch.float32)
    rows[:held] = x.float().index_select(0, order[:held] // k)
    pos = torch.full((order.numel(),), -1, dtype=torch.int32, device=x.device)
    pos[order[:held]] = torch.arange(held, dtype=torch.int32, device=x.device)
    return rows, pos


def gather_rows(x: torch.Tensor, order: torch.Tensor, offsets: torch.Tensor,
                k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The held pairs' rows in expert order: x (T, D), order (T k,) the pairs
    (t k + j) in expert order (:func:`dispatch`), offsets (held + 1,) ->
    (rows (T k, D) float32, row i = x[order[i] // k] for i < offsets[-1] and
    not written past it; pos (T k,) int32, pair p's row i, or -1 for a pair
    routed elsewhere). CUDA tensors launch ``moe_gather_rows_kernel``, which
    reads offsets[-1] on the device (``gather_rows.launches`` counts the
    launches); CPU tensors take :func:`gather_rows_plain`."""
    if x.device.type != "cuda":
        return gather_rows_plain(x, order, offsets, k)
    x = x.float().contiguous()
    (t, d), pairs = x.shape, order.numel()
    _check_rows("order", order, torch.int64, x.device)
    _check_rows("offsets", offsets, torch.int32, x.device)
    if pairs != t * k or d % 4 or x.data_ptr() % 16:
        raise ValueError(f"the gather takes T k = {t * k} pairs (got {pairs}) and 16-byte "
                         f"aligned rows of a multiple of 4 values (got {d})")
    rows = torch.empty((pairs, d), dtype=torch.float32, device=x.device)
    pos = torch.empty((pairs,), dtype=torch.int32, device=x.device)
    if pairs == 0:
        return rows, pos
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.edgellm_moe_gather_rows(
            x.data_ptr(), order.data_ptr(), offsets.data_ptr(), offsets.numel() - 1, t, k, d,
            rows.data_ptr(), pos.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
    _launched(lib, "moe gather", err)
    gather_rows.launches += 1
    return rows, pos


gather_rows.launches = 0

#: the combine's output dtypes, by the kernel's code
_OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def combine_rows_plain(y: torch.Tensor, pos: torch.Tensor, weights: torch.Tensor,
                       dtype: torch.dtype) -> torch.Tensor:
    """:func:`combine_rows` in plain PyTorch, the same adds in the same
    order."""
    out = y.new_zeros((weights.shape[0], y.shape[1]))
    pos = pos.reshape(weights.shape).long()
    for j in range(weights.shape[1]):
        held = pos[:, j] >= 0
        out[held] += y[pos[held, j]] * weights[held, j, None]
    return out.to(dtype)


def combine_rows(y: torch.Tensor, pos: torch.Tensor, weights: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    """The weighted sum back to the tokens: y (M, D) float32 held experts'
    results, pos (T k,) each pair's row of y or -1 (:func:`gather_rows`),
    weights (T, k) float32 -> (T, D) in ``dtype``: out[t] = sum over picks j
    with pos >= 0, in pick order, of weights[t, j] * y[pos[t k + j]] in
    float32. A row of a pair routed elsewhere is never read. CUDA tensors
    launch ``moe_combine_kernel`` (``combine_rows.launches`` counts the
    launches); CPU tensors take :func:`combine_rows_plain`."""
    if y.device.type != "cuda":
        return combine_rows_plain(y, pos, weights, dtype)
    (t, k), d = weights.shape, y.shape[1]
    _check_rows("y", y, torch.float32, y.device)
    _check_rows("pos", pos, torch.int32, y.device)
    _check_rows("weights", weights, torch.float32, y.device)
    if pos.numel() != t * k or k > 32 or d % 4 or y.data_ptr() % 16 or dtype not in _OUT_DTYPES:
        raise ValueError(f"the combine takes T k = {t * k} row indices (got {pos.numel()}), "
                         f"at most 32 picks (got {k}), 16-byte aligned rows of a multiple of 4 "
                         f"values (got {d}) and an output in {sorted(map(str, _OUT_DTYPES))}")
    out = torch.empty((t, d), dtype=dtype, device=y.device)
    if t == 0:
        return out
    lib = _lib()
    with torch.cuda.device(y.device):
        err = lib.edgellm_moe_combine(
            y.data_ptr(), pos.data_ptr(), weights.data_ptr(), t, k, d, out.data_ptr(),
            _OUT_DTYPES[dtype], torch.cuda.current_stream(y.device).cuda_stream)
    _launched(lib, "moe combine", err)
    combine_rows.launches += 1
    return out


combine_rows.launches = 0


def experts_ffn(x: torch.Tensor, planes13: gemm.GroupedPlanes, planes2: gemm.GroupedPlanes,
                offsets: torch.Tensor, fill: float = None) -> torch.Tensor:
    """The held experts' SwiGLU over rows in expert order: x (M, D) ->
    (M, D) float32, each expert's rows through its own gate/up, whose
    launch stores silu(gate) * up (``planes13`` prepared with glu), and
    down (two grouped launches); rows outside every held range are not
    written (they hold ``fill`` where one is given, else whatever the memory
    held)."""
    def out(n):
        return None if fill is None else x.new_full((x.shape[0], n), fill, dtype=torch.float32)

    act = gemm.grouped_gemm_tf32x3(x.float().contiguous(), planes13, offsets, out(planes13.rows))
    return gemm.grouped_gemm_tf32x3(act, planes2, offsets, out(planes2.rows))


# routing, the sort by expert, the gather, both grouped products and the
# combine on the device: no host sync, no hop, two grouped launches (gate /
# up with SiLU·up, down), one gather and one combine
@graph_contract("moe.experts", hops=0, launches={"grouped_gemm_tf32x3": 2, "gather_rows": 1,
                                                 "combine_rows": 1})
def moe_ffn(cfg: ModelConfig, lp: dict, x: torch.Tensor, planes, linear) -> torch.Tensor:
    """The sparse FFN over x (B, S, D) -> (B, S, D) in x's dtype: the held
    experts' part of the routed sum. ``planes(w, glu=False)`` returns the
    grouped planes of an expert weight (``transformer.prepared_grouped_planes``),
    ``linear`` the model's product (``transformer.linear``)."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    k = cfg.num_experts_per_tok
    counted = _COUNTING[0]
    with device_span("moe.route", x.device):
        weights, experts = route(cfg, lp, x2, linear)
        order, offsets = dispatch(experts, cfg.expert_offset, lp["w13"].shape[0])
        rows, pos = gather_rows(x2, order, offsets, k)
    with device_span("moe.experts", x.device):
        y = experts_ffn(rows, planes(lp["w13"], glu=True), planes(lp["w2"]), offsets,
                        float("nan") if counted else None)
    with device_span("moe.combine", x.device):
        if counted:
            _count(offsets, y, pos.numel())
        out = combine_rows(y, pos, weights, x.dtype)
    return out.reshape(shape)
