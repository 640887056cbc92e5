"""Causal prefill attention for the sweep: two hand-written Hopper kernels,
their plain PyTorch versions, and the shape envelope that decides which runs.

PyTorch counterpart of the prefill half of ``edgellm_tpu/models/flash_attention.py``.
The TPU package has four Pallas kernels here: the whole-sequence kernels
``_attn_packed`` / ``_attn_packed_stats`` and their query-blocked twins
``_attn_blocked`` / ``_attn_blocked_stats``. The whole/blocked split exists
only because of the TPU's VMEM; on Hopper one kernel per function covers both
plans:

- **K-attn** (``csrc/causal_attention.cu``), behind :func:`causal_attention`:
  flash-style exact causal attention, online softmax in fp32, q and the
  output in the packed (B, S, H*hd) layout, K/V read through their strides.
  In bf16 (one block per query tile of a head) both products run on the
  tensor cores (``wgmma``), fed by 16-byte ``cp.async`` copies into a
  4-stage shared-memory ring that one producer warp fills and the consumer
  warpgroups drain (``csrc/hopper_common.cuh``). In fp32 a block takes a
  query tile of a whole GQA group (each K/V tile read once for the group)
  and both products run on the tensor cores as fp32-accurate 3xTF32 splits
  (no plain TF32: the reference has none); a B=1 prefill's long rows are
  cut into key splits (:func:`attn_split_plan`) that a second kernel of the
  same call merges in split order.
- **K-stats** (``csrc/attention_stats.cu``), behind
  :func:`causal_attention_stats`: K-attn's forward also writes the row
  log-sum-exp, then a column pass (one block per 128-key block; ``K q^T`` by
  ``wgmma``, so column sums are accumulator row sums; in fp32 as 3xTF32
  products in the forward's term order) sums
  ``exp(s - lse)`` down the columns into ``col_sum / S`` and writes the last
  query row. Two passes, no atomics, deterministic.

The decode half: :func:`decode_attention` and :func:`verify_attention`
against a contiguous cache are plain PyTorch (the TPU package has no kernel
there either), and the continuous batcher's paged attention runs two more:

- **K13** (``csrc/paged_decode.cu``), behind :func:`paged_decode_attention`:
  q_len = 1 per slot over that slot's page list, online softmax in fp32,
  the span cut into splits (:func:`paged_split_plan`, from static shapes:
  one block per (split, KV head, slot), each streaming its page rows
  through a 2-stage shared-memory ring filled by bulk (TMA) copies), the
  splits' partials merged in split order by a second kernel of the same
  call;
- **K14** (the same source), behind :func:`paged_decode_attention_quant`:
  K13 over int8 or packed int4 codes with per-row scales, dequantized in
  registers.

A wrapper launches its kernel for CUDA tensors and takes the plain version
only for CPU tensors. Which shapes reach a kernel is decided by plan
(:func:`kernel_plan`, the TPU envelope: hd in {64, 128}, head-aligned GQA,
S <= 2048; :func:`decode_plan` for pages); the model sends a shape without a
plan to the plain version. A CUDA tensor outside the wrapper's checks raises:
the kernels also need every base pointer and batch, sequence and head stride
16-byte aligned (:func:`_check_copy_alignment`); there is no other body to
fall back to.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from ..utils import cuda_build

#: the whole-S and blocked plan constants of the TPU package, kept so the
#: port's plans (and therefore which shapes reach a kernel) match its plans
MAX_WHOLE_S = 1024
MAX_PACKED_DH = 1536
QBLOCK = 512
MAX_BLOCKED_S = 2048
VALIDATED_HD = (64, 128)
MAX_KV_BYTES = 2 * 1024 * 1024

#: dtype codes of the kernels' C interface
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _shape_plan(s: int, h: int, kv: int, hd: int, itemsize: int = 2):
    """The TPU package's plan for an (S, H, KV, hd) shape: ``("whole", None)``,
    ``("blocked", (qb, hps))`` or None. Both plans run the same Hopper kernel;
    the plan only says whether the shape is inside the envelope. Raises on
    ragged GQA."""
    if h % kv:
        raise ValueError(f"kernels need head-aligned GQA, got H={h}, KV={kv}")
    dh = h * hd
    scale = max(itemsize, 2) // 2
    if s <= MAX_WHOLE_S // scale and dh <= MAX_PACKED_DH // scale:
        return ("whole", None)
    if s > MAX_BLOCKED_S:
        return None
    qb = s if s <= MAX_WHOLE_S else QBLOCK
    if s % qb:
        return None
    rep = h // kv
    hps = next((c for c in range(h, 0, -1)
                if h % c == 0 and c % rep == 0 and c * hd <= MAX_PACKED_DH
                and (c // rep) * s * hd * itemsize <= MAX_KV_BYTES),
               None)
    if hps is None:
        return None
    return ("blocked", (qb, hps))


def kernel_plan(s: int, h: int, kv: int, hd: int, itemsize: int = 2):
    """The plan when a kernel should handle this shape, else None (the plain
    version): validated head dim, head-aligned GQA, a shape inside the
    envelope."""
    if hd not in VALIDATED_HD or h % kv:
        return None
    return _shape_plan(s, h, kv, hd, itemsize)


#: fp32 K-attn's tile by head dim as the committed source builds it: (query
#: rows a block, keys a tile, blocks an SM); the wrapper reads the built
#: library's own (``edgellm_attn_fwd_f32_tile``)
ATTN_F32_TILES = {64: (128, 64, 1), 128: (64, 32, 1)}
#: a split covers at least this many keys: a shorter one costs the merge
#: kernel (~0.003 ms) for little parallelism, and the serve prefills at
#: S = 12 and 72 stay one launch of one kernel
ATTN_F32_MIN_SPLIT_KEYS = 128


def attn_split_plan(b: int, s: int, h: int, kv: int, sms: Optional[int] = None,
                    tile: tuple = ATTN_F32_TILES[64]) -> tuple[int, int]:
    """The key-split schedule of fp32 K-attn from static shapes only (no
    host sync) -> (splits, key tiles a split).

    A block takes ``tile[0]`` rows of one (batch row, KV head)'s query rows,
    its heads packed position-major (``s * h / kv`` rows), and walks key
    tiles of ``tile[1]`` up to its last row's position; row tile ``t``'s key
    tiles are cut into runs of ``per``, one block each. ``per`` aims at
    ``tile[2]`` blocks an SM (as many as fit) over the row tiles, each run
    at least :data:`ATTN_F32_MIN_SPLIT_KEYS` keys; one split means no merge."""
    rows, keys, waves = tile
    sms = sms or H100_SMS
    row_tiles = -(-s * (h // kv) // rows)
    max_kt = -(-s // keys)
    want = max(1, -(-waves * sms // (b * kv * row_tiles)))
    per = min(max_kt, max(-(-ATTN_F32_MIN_SPLIT_KEYS // keys), -(-max_kt // want)))
    return -(-max_kt // per), per


def _resolve(q: torch.Tensor, k: torch.Tensor, plan):
    b, s, h, hd = q.shape
    if plan is None:
        plan = _shape_plan(s, h, k.shape[2], hd, itemsize=q.element_size())
        if plan is None:
            raise ValueError(
                f"no kernel covers S={s}, H={h}, KV={k.shape[2]}, hd={hd}")
    return plan


# ---------------------------------------------------------------------------
# Plain versions: the eager formulation of transformer.attention, the CPU
# path and the kernels' yardstick on the card.
# ---------------------------------------------------------------------------


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_blk: Optional[int] = None, stats: bool = True):
    """Eager causal attention from (B, S, H, hd) q and (B, S, KV, hd) K/V ->
    (out (B, S, H, hd), (col_sum / S, last_row) each (B, H, S) fp32, or None
    without ``stats``).

    Scores are fp32 (inputs widened, the products of bf16 values are exact in
    fp32), scaled after the dot, masked with ``finfo(f32).min``; the
    probabilities are cast to q's dtype before PV, which accumulates in fp32.
    ``q_blk`` streams query blocks (peak memory S/q_blk smaller); None or S
    is the single-block, full-probabilities formulation."""
    b, s, h, hd = q.shape
    rep = h // k.shape[2]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    q_blk = s if not q_blk else q_blk
    inv_scale = 1.0 / torch.sqrt(torch.tensor(hd, dtype=torch.float32, device=q.device))
    neg_inf = torch.finfo(torch.float32).min
    kf, vf = k.float(), v.float()
    key_pos = torch.arange(s, device=q.device)
    col_sum = torch.zeros((b, h, s), dtype=torch.float32, device=q.device) if stats else None
    outs, last_row = [], None
    for r0 in range(0, s, q_blk):
        rows = key_pos[r0:r0 + q_blk]
        sc = torch.einsum("bqhd,bthd->bhqt", q[:, r0:r0 + q_blk].float(), kf) \
            * inv_scale
        mask = rows[:, None] >= key_pos[None, :]
        probs = torch.softmax(torch.where(mask, sc, neg_inf), dim=-1)
        outs.append(torch.einsum("bhqt,bthd->bqhd", probs.to(q.dtype).float(), vf)
                    .to(q.dtype))
        if stats:
            col_sum += probs.sum(dim=2)
            if r0 + q_blk >= s:
                last_row = probs[:, :, -1, :]
    out = torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
    return out, ((col_sum / s, last_row) if stats else None)


def causal_attention_plain(q, k, v):
    """Plain version of :func:`causal_attention`."""
    return attention_plain(q, k, v, stats=False)[0]


def causal_attention_stats_plain(q, k, v):
    """Plain version of :func:`causal_attention_stats`."""
    return attention_plain(q, k, v)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _lib(name: str) -> ctypes.CDLL:
    lib = cuda_build.library(name)
    if not getattr(lib, "_edgellm_declared", False):
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        if name == "causal_attention":
            lib.edgellm_attn_fwd.argtypes = [ptr] * 6 + [i32] * 8 + [i64] * 10 + [ptr]
            lib.edgellm_attn_fwd.restype = i32
            lib.edgellm_attn_fwd_f32_tile.argtypes = [i32] + [ctypes.POINTER(i32)] * 3
            lib.edgellm_attn_fwd_f32_tile.restype = i32
            lib.edgellm_attn_fwd_error.argtypes = [i32]
            lib.edgellm_attn_fwd_error.restype = ctypes.c_char_p
        else:
            lib.edgellm_attn_col.argtypes = [ptr] * 5 + [i32] * 6 + [i64] * 5 + [ptr]
            lib.edgellm_attn_col.restype = i32
            lib.edgellm_attn_col_error.argtypes = [i32]
            lib.edgellm_attn_col_error.restype = ctypes.c_char_p
        lib._edgellm_declared = True
    return lib


def _check_inputs(q, k, v, plan):
    """Device, dtype, shape and stride checks of the kernels' contract."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"expected (B, S, H, hd) q and (B, S, KV, hd) k/v, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, hd = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, s) or k.shape[3] != hd:
        raise ValueError(f"k/v {tuple(k.shape)}/{tuple(v.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if not (q.device == k.device == v.device) or q.device.type != "cuda":
        raise ValueError(f"kernel inputs must share one CUDA device, got "
                         f"{q.device}, {k.device}, {v.device}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise ValueError(f"kernel takes float32 or bfloat16 inputs of one dtype, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if hd not in VALIDATED_HD or h % k.shape[2]:
        raise ValueError(f"kernel takes hd in {VALIDATED_HD} and H % KV == 0, "
                         f"got hd={hd}, H={h}, KV={k.shape[2]}")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous: the kernel reads it packed as "
                         "(B, S, H*hd)")
    if k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("k/v head dim must be contiguous (stride 1)")
    _check_copy_alignment(q, k, v)
    _resolve(q, k, plan)


def _check_copy_alignment(q, k, v):
    """The kernels copy rows in 16-byte chunks (``cp.async``; the fp32 body
    also reads q in 16-byte loads): each tensor's rows must be contiguous in
    hd and its base pointer and batch, sequence and head strides multiples of
    16 bytes. Raises otherwise. The model's q, K and V (``transformer.
    attention``: projections and rotary outputs, K/V as head slices of a
    fused projection) always are."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name} rows must be contiguous in hd (stride 1)")
        strides = [t.stride(i) * t.element_size() for i in range(3)]
        if t.data_ptr() % 16 or any(st % 16 for st in strides):
            raise ValueError(f"{name} is not 16-byte aligned for the kernel's copies: "
                             f"base {t.data_ptr() % 16} bytes off, byte strides {strides}")


def _raise_on(lib, err: int, what: str, errfn: str):
    if err:
        msg = getattr(lib, errfn)(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} ({msg})")


#: shared memory an H100 SM gives its blocks (228 KB less 1 KB a block)
_SM_SHARED_BYTES = 233472


def _f32_tile(lib, hd: int) -> tuple[int, int, int]:
    """(query rows a block, keys a tile, blocks an SM) of the fp32 body built
    into ``lib`` at head dim ``hd``."""
    cache = lib.__dict__.setdefault("_edgellm_f32_tiles", {})
    if hd not in cache:
        rows, keys, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        if lib.edgellm_attn_fwd_f32_tile(hd, ctypes.byref(rows), ctypes.byref(keys),
                                         ctypes.byref(smem)):
            raise ValueError(f"the fp32 kernel has no tile for hd={hd}")
        cache[hd] = (rows.value, keys.value,
                     max(1, _SM_SHARED_BYTES // (smem.value + 1024)))
    return cache[hd]


def _launch_fwd(q, k, v, with_lse: bool):
    b, s, h, hd = q.shape
    kv = k.shape[2]
    lib = _lib("causal_attention")
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
           if with_lse else None)
    splits, per, ws = 1, 1, None
    if q.dtype == torch.float32:
        tile = _f32_tile(lib, hd)
        splits, per = attn_split_plan(b, s, h, kv, _sm_count(q.device), tile)
        if splits > 1:
            nrt = -(-s * (h // kv) // tile[0])
            ws = torch.empty(b * kv * nrt * splits * tile[0] * (hd + 2), dtype=torch.float32,
                             device=q.device)
    with torch.cuda.device(q.device):
        err = lib.edgellm_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if lse is not None else None,
            ws.data_ptr() if ws is not None else None, splits, per,
            b, s, h, kv, hd, _DTYPE_CODE[q.dtype],
            q.stride(0), q.stride(1), k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2), out.stride(0), out.stride(1),
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(lib, err, "causal_attention", "edgellm_attn_fwd_error")
    return out, lse


def _launch_col(q, k, lse):
    b, s, h, hd = q.shape
    lib = _lib("attention_stats")
    col = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    last = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.edgellm_attn_col(
            q.data_ptr(), k.data_ptr(), lse.data_ptr(), col.data_ptr(),
            last.data_ptr(), b, s, h, k.shape[2], hd, _DTYPE_CODE[q.dtype],
            q.stride(0), q.stride(1), k.stride(0), k.stride(1), k.stride(2),
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(lib, err, "causal_attention_stats", "edgellm_attn_col_error")
    return col, last


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     plan=None) -> torch.Tensor:
    """Causal attention from the model's (B, S, H, hd) layout; K/V may carry
    fewer (grouped-query) heads. Returns (B, S, H, hd) in q's dtype.

    CUDA tensors launch K-attn (``causal_attention.launches`` counts the
    launches, ``causal_attention.launches_by_dtype`` the fp32 and bf16 ones
    apart; an fp32 launch with key splits, kernel and merge, counts once);
    CPU tensors take :func:`causal_attention_plain`. ``plan``
    (from :func:`kernel_plan`) is resolved from the shape when omitted; a
    shape without one raises."""
    if q.device.type == "cpu":
        _resolve(q, k, plan)
        return causal_attention_plain(q, k, v)
    _check_inputs(q, k, v, plan)
    causal_attention.launches += 1
    causal_attention.launches_by_dtype[str(q.dtype).split(".")[-1]] += 1
    return _launch_fwd(q, k, v, with_lse=False)[0]


def causal_attention_stats(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                           plan=None):
    """Causal attention + (col_sum / S, last_row) stats from (B, S, H, hd).
    Returns (out (B, S, H, hd), (col_sum (B, H, S), last_row (B, H, S))),
    the stats fp32.

    CUDA tensors launch K-stats, K-attn's forward with the row log-sum-exp
    and then the column pass (``causal_attention_stats.launches`` counts each
    such pair once, ``launches_by_dtype`` the fp32 and bf16 ones apart); CPU
    tensors take :func:`causal_attention_stats_plain`."""
    if q.device.type == "cpu":
        _resolve(q, k, plan)
        return causal_attention_stats_plain(q, k, v)
    _check_inputs(q, k, v, plan)
    causal_attention_stats.launches += 1
    causal_attention_stats.launches_by_dtype[str(q.dtype).split(".")[-1]] += 1
    out, lse = _launch_fwd(q, k, v, with_lse=True)
    return out, _launch_col(q, k, lse)


causal_attention.launches = 0
causal_attention.launches_by_dtype = {"float32": 0, "bfloat16": 0}
causal_attention_stats.launches = 0
causal_attention_stats.launches_by_dtype = {"float32": 0, "bfloat16": 0}


def causal_attention_bytes_flops(b: int, s: int, h: int, kv: int, hd: int,
                                 itemsize: int, stats: bool = False):
    """(bytes, FLOPs) the causal attention function needs at a shape: each
    input read once and each output written once; QK^T and PV over the
    S(S+1)/2 visible (query, key) pairs per head, 2 FLOPs per multiply-add.
    With ``stats`` the two (B, H, S) fp32 outputs are added to the bytes."""
    pairs = s * (s + 1) / 2
    flops = 2 * 2 * b * h * pairs * hd
    nbytes = itemsize * (2 * b * s * h * hd + 2 * b * s * kv * hd)
    if stats:
        nbytes += 2 * 4 * b * h * s
    return float(nbytes), float(flops)


def column_pass_bytes_flops(b: int, s: int, h: int, kv: int, hd: int, itemsize: int):
    """(bytes, FLOPs) of K-stats' column pass alone: q and K read once, the
    (B, H, S) fp32 LSE read once and col / last written once; the QK^T
    products over the S(S+1)/2 visible (query, key) pairs per head."""
    flops = 2 * b * h * (s * (s + 1) / 2) * hd
    nbytes = itemsize * (b * s * h * hd + b * s * kv * hd) + 3 * 4 * b * h * s
    return float(nbytes), float(flops)


#: H100 SXM published peaks (dense): bf16 tensor cores; for fp32 the fastest
#: fp32-accurate products the card offers: 67 TFLOP/s on the CUDA cores, or
#: the tensor cores' 494.7 TFLOP/s of TF32 over the 3 TF32 products of a
#: 3xTF32 split (plain TF32 is not fp32-accurate and the fp32 path allows
#: none), whichever is larger; HBM3 bytes/s
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: max(67e12, 494.7e12 / 3)}
PEAK_BYTES_PER_S = 3.35e12


def bound_ms(nbytes: float, flops: float, dtype: torch.dtype):
    """Roofline bound in ms on an H100 SXM: the larger of the bytes over the
    memory rate and the FLOPs over the peak rate for ``dtype`` ->
    (ms, "bytes" or "operations")."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# Decode attention: q_len = 1 against a length-masked KV cache, contiguous
# (no kernel, as in the TPU package) or paged (K13 / K14 on the card).
# ---------------------------------------------------------------------------

#: KV-at-rest storage tiers of the paged pool (models/paged_kv.py): pages hold
#: packed int codes plus one fp32 scale per (token row, KV head); "fp" stores
#: the cache dtype itself
KV_REST_TIERS = ("fp", "int8_per_channel", "int4_per_channel")
#: the paged plan's K/V byte budget per slot span (the TPU package's number,
#: kept so the same shapes reach a kernel)
MAX_PAGED_KV_BYTES = 4 * 1024 * 1024
#: page rows of a planned page must be a multiple of this. The TPU package
#: aligns quantized pages at 32 on its own chip (the int8 sublane tile of its
#: vector registers); that is a rule of the TPU's tiling, not of the
#: function, and the Hopper kernel reads rows one by one, so quantized pages
#: align at 8 here like fp pages (split14's page_size 8 reaches K14).
PAGE_ALIGN = 8


def _kv_quant_spec(kv_codec: str) -> float:
    """Integer span of a quantized KV tier (codes live in [-qmax, qmax])."""
    if kv_codec == "int8_per_channel":
        return 127.0
    if kv_codec == "int4_per_channel":
        return 7.0
    raise ValueError(f"unknown KV-at-rest tier {kv_codec!r}; quantized "
                     f"options: {[t for t in KV_REST_TIERS if t != 'fp']}")


def quantize_kv_rows(x: torch.Tensor, kv_codec: str):
    """Quantize K or V rows per (token, KV head) over the ``hd`` lanes:
    x (..., KV, hd) -> (codes, scales (..., KV) fp32). The scale is the row's
    absmax; int8 codes are (..., KV, hd) int8, int4 codes pack lane ``i``
    with lane ``i + hd/2`` into one uint8 (..., KV, hd // 2). An all-zero row
    quantizes to zero codes with scale 0 (the trash page stays finite)."""
    qmax = _kv_quant_spec(kv_codec)
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    safe = torch.where(amax > 0, amax, 1.0)
    codes = torch.round(xf / safe[..., None] * qmax).to(torch.int8)
    if kv_codec == "int4_per_channel":
        half = x.shape[-1] // 2
        u = (codes.to(torch.int32) + 8).to(torch.uint8)  # [-8, 7] -> [0, 15]
        codes = u[..., :half] | (u[..., half:] << 4)
    return codes, amax


def _dequant_factor(scales: torch.Tensor, kv_codec: str) -> torch.Tensor:
    """``scales / qmax`` as the jitted reference compiles it (and as K14
    computes it): a multiply by the float32 reciprocal of qmax."""
    inv = torch.tensor(np.float32(1.0 / _kv_quant_spec(kv_codec)), device=scales.device)
    return scales * inv


def dequantize_kv_rows(codes: torch.Tensor, scales: torch.Tensor, kv_codec: str,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Invert :func:`quantize_kv_rows`: codes (..., KV, hdc) + scales
    (..., KV) -> (..., KV, hd) in ``dtype``, ``code * (scale * (1/qmax))``.
    Elementwise per row, so gather-then-dequantize equals
    dequantize-then-gather bit for bit."""
    factor = _dequant_factor(scales, kv_codec)
    if kv_codec == "int4_per_channel":
        lo = (codes & 0xF).to(torch.int8) - 8
        hi = ((codes >> 4) & 0xF).to(torch.int8) - 8
        c = torch.cat([lo, hi], dim=-1).float()
    else:
        c = codes.float()
    return (c * factor[..., None]).to(dtype)


def decode_plan(capacity: int, h: int, kv: int, hd: int, itemsize: int = 2,
                pages: Optional[tuple] = None, kv_codec: Optional[str] = None):
    """Kernel plan for the q_len = 1 decode shape: ``("paged", (pps, ps))``,
    ``("paged_quant", (pps, ps))`` or None.

    Contiguous caches (``pages=None``) always return None: the TPU package
    has no contiguous decode kernel and none is owed. Paged caches
    (``pages=(pages_per_slot, page_size)``) get a plan inside the TPU
    package's shape gates: validated head dim, head-aligned GQA,
    ``pps * ps == capacity``, page rows a multiple of :data:`PAGE_ALIGN`,
    a span of at most ``MAX_BLOCKED_S`` and the :data:`MAX_PAGED_KV_BYTES`
    budget of the real per-row footprint (packed codes plus one fp32 scale
    per KV head, per K and per V, for the quantized tiers). On the card the
    plan dispatches the kernel by itself: there is no override option and
    no probe cache."""
    if hd not in VALIDATED_HD or h % kv:
        return None
    if pages is None:
        return None
    quant = kv_codec is not None and kv_codec != "fp"
    if quant:
        _kv_quant_spec(kv_codec)  # fail fast on an unknown tier name
        if hd % 2:
            return None
    pps, ps = pages
    if pps * ps != capacity or ps % PAGE_ALIGN or capacity > MAX_BLOCKED_S:
        return None
    code_bytes = (hd * itemsize if not quant
                  else (hd if kv_codec == "int8_per_channel" else hd // 2) + 4)
    if 2 * capacity * kv * code_bytes > MAX_PAGED_KV_BYTES:
        return None
    return ("paged_quant", (pps, ps)) if quant else ("paged", (pps, ps))


def paged_plan(q: torch.Tensor, k_pages: torch.Tensor, page_table: torch.Tensor,
               kv_codec: str = "fp"):
    """:func:`decode_plan` for the paged decode attention's inputs: q
    (B, 1, H, hd), one layer's pages (num_pages, ps, KV, hdc) and the
    (B, pages_per_slot) table -> the plan the wrappers take, or None."""
    pps, ps = page_table.shape[1], k_pages.shape[1]
    return decode_plan(pps * ps, q.shape[2], k_pages.shape[2], q.shape[3], q.element_size(),
                       pages=(pps, ps), kv_codec=kv_codec)


def _inv_sqrt_hd(hd: int) -> float:
    """The float32 1 / sqrt(hd) the reference multiplies scores by."""
    return float(np.float32(1.0 / np.sqrt(hd)))


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     length) -> torch.Tensor:
    """Single-position attention against a cache: q (B, 1, H, hd) against
    k/v_cache (B, capacity, KV, hd) of which the first ``length`` positions
    are valid. ``length`` is an int (one fill level for the batch) or a (B,)
    tensor (per-row levels: the gather path of the paged attention). Returns
    (B, 1, H, hd) in q's dtype; scores and softmax in fp32, probabilities in
    q's dtype before PV, as the reference. GQA: head ``j * rep + g`` attends
    KV group ``j``, read once per group."""
    b, s1, h, hd = q.shape
    kv = k_cache.shape[2]
    if s1 != 1:
        raise ValueError(f"decode_attention is q_len=1 only, got q_len={s1}")
    if h % kv:
        raise ValueError(f"ragged GQA: H={h}, KV={kv}")
    rep = h // kv
    qg = q[:, 0].reshape(b, kv, rep, hd)
    scores = torch.einsum("bgrd,bcgd->bgrc", qg.float(), k_cache.float()) * _inv_sqrt_hd(hd)
    pos = torch.arange(k_cache.shape[1], device=q.device)
    if isinstance(length, torch.Tensor) and length.dim():
        valid = pos[None, :] < length[:, None]
        valid = valid[:, None, None, :]
    else:
        valid = (pos < int(length))[None, None, None, :]
    scores = torch.where(valid, scores, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrc,bcgd->bgrd", probs.to(q.dtype).float(), v_cache.float())
    return out.to(q.dtype).reshape(b, 1, h, hd)


def verify_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     length: int) -> torch.Tensor:
    """q_len = K attention against a cache whose rows ``length .. length+K-1``
    hold the K new positions: query row ``j`` sees cache positions
    ``[0, length + j]``. The suffix prefill of a prefix-sharing admit runs
    through it. Returns (B, K, H, hd) in q's dtype; softmax in fp32."""
    b, kq, h, hd = q.shape
    kv = k_cache.shape[2]
    if h % kv:
        raise ValueError(f"ragged GQA: H={h}, KV={kv}")
    rep = h // kv
    qg = q.reshape(b, kq, kv, rep, hd)
    scores = torch.einsum("bqgrd,bcgd->bqgrc", qg.float(), k_cache.float()) * _inv_sqrt_hd(hd)
    pos = torch.arange(k_cache.shape[1], device=q.device)
    valid = pos[None, :] < (int(length) + torch.arange(kq, device=q.device)[:, None] + 1)
    scores = torch.where(valid[None, :, None, None, :], scores, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bqgrc,bcgd->bqgrd", probs.to(q.dtype).float(), v_cache.float())
    return out.to(q.dtype).reshape(b, kq, h, hd)


def _gather_span(pages: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """Each slot's pages in logical order as one contiguous span:
    (num_pages, ps, ...) pages and a (B, pps) table -> (B, pps * ps, ...)."""
    pn, ps = pages.shape[:2]
    b, pps = page_table.shape
    idx = (page_table.long()[:, :, None] * ps
           + torch.arange(ps, device=pages.device)[None, None, :]).reshape(b, pps * ps)
    return pages.reshape((pn * ps,) + tuple(pages.shape[2:]))[idx]


def paged_decode_attention_plain(q, k_pages, v_pages, page_table, lengths):
    """Plain version of :func:`paged_decode_attention`, the reference's
    gather path: each slot's span gathered through the page table, then
    :func:`decode_attention` with per-slot lengths (trash-page rows land
    only in masked positions, where the softmax gives exactly 0)."""
    return decode_attention(q, _gather_span(k_pages, page_table),
                            _gather_span(v_pages, page_table), lengths)


def paged_decode_attention_quant_plain(q, k_pages, v_pages, k_scale, v_scale, page_table,
                                       lengths, *, kv_codec: str):
    """Plain version of :func:`paged_decode_attention_quant`: codes and
    scales gathered through the page table, dequantized to q's dtype, then
    :func:`decode_attention`."""
    kg = dequantize_kv_rows(_gather_span(k_pages, page_table),
                            _gather_span(k_scale, page_table), kv_codec, q.dtype)
    vg = dequantize_kv_rows(_gather_span(v_pages, page_table),
                            _gather_span(v_scale, page_table), kv_codec, q.dtype)
    return decode_attention(q, kg, vg, lengths)


# ---------------------------------------------------------------------------
# The split schedule of K13 / K14 (flash-decoding): each slot's span is cut
# into runs of whole pages, one block per (split, KV head, slot), so that the
# blocks fill the card; the splits' partial softmax states are merged in
# split order.
# ---------------------------------------------------------------------------

#: query heads one block of K13 / K14 holds; a larger GQA group is cut into
#: chunks of this many, each its own block. The C entry point takes it and
#: refuses a value its kernel was not built for.
PAGED_HEADS_PER_BLOCK = 8
#: a split covers at least this many rows: shorter splits cost a merge for
#: little parallelism (the kernel takes any whole number of pages a split)
PAGED_MIN_SPLIT_ROWS = 64
#: blocks per SM the schedule aims for (8 read fastest on the H100 at the
#: serve geometries, beside 2, 4 and 16: PERF.md)
PAGED_WAVES = 8
#: streaming multiprocessors of an H100 SXM
H100_SMS = 132


def paged_split_plan(b: int, h: int, kv: int, ps: int, pps: int,
                     sms: int = H100_SMS) -> tuple[int, int]:
    """The split schedule of K13 / K14 from static shapes only (no length is
    read, so the step never syncs the host) -> (splits, pages per split).
    Split ``s`` covers logical pages ``s * per`` up to ``(s + 1) * per`` (the
    last up to ``pps``), rows past a slot's length masked; a split that
    starts at or past the length is not live.

    The grid holds ``b * kv * ceil(rep / 8) * splits`` blocks; the split
    count aims at :data:`PAGED_WAVES` blocks per SM, each split at least
    :data:`PAGED_MIN_SPLIT_ROWS` rows and whole pages, and at most ``pps``
    splits. One split means one launch and no merge."""
    chunks = -(-(h // kv) // PAGED_HEADS_PER_BLOCK)
    want = max(1, -(-PAGED_WAVES * sms // (b * kv * chunks)))
    per = min(pps, max(-(-PAGED_MIN_SPLIT_ROWS // ps), -(-pps // want)))
    return -(-pps // per), per


def _span_rows(q, k_pages, v_pages, k_scale, v_scale, page_table, kv_codec: str):
    """Each slot's K and V span gathered through the page table as fp32
    (dequantized for a quantized tier): what the kernel reads, widened."""
    k, v = _gather_span(k_pages, page_table), _gather_span(v_pages, page_table)
    if kv_codec == "fp":
        return k.float(), v.float()
    return (dequantize_kv_rows(k, _gather_span(k_scale, page_table), kv_codec),
            dequantize_kv_rows(v, _gather_span(v_scale, page_table), kv_codec))


def paged_split_partials(q: torch.Tensor, k_span: torch.Tensor, v_span: torch.Tensor,
                         lengths: torch.Tensor, split_rows: int):
    """Plain model of one launch's first kernel: the softmax state of every
    split of ``split_rows`` span rows, in fp32. q (B, 1, H, hd); k/v_span
    (B, span, KV, hd) -> (m (B, splits, H), l (B, splits, H), acc (B, splits,
    H, hd) unnormalized, live (B, splits)). A split past the slot's length
    is not live and holds m = -inf, l = 0, acc = 0."""
    b, _, h, hd = q.shape
    span, kv = k_span.shape[1], k_span.shape[2]
    splits = -(-span // split_rows)
    pad = splits * split_rows - span
    qg = q[:, 0].float().reshape(b, kv, h // kv, hd)
    s = torch.einsum("bgrd,bcgd->bgrc", qg, k_span.float()) * _inv_sqrt_hd(hd)
    pos = torch.arange(span, device=q.device)
    s = torch.where((pos[None, :] < lengths[:, None].long())[:, None, None, :], s, -torch.inf)
    s = torch.nn.functional.pad(s, (0, pad), value=-torch.inf)
    s = s.reshape(b, kv, h // kv, splits, split_rows)
    v = torch.nn.functional.pad(v_span.float(), (0, 0, 0, 0, 0, pad))
    v = v.reshape(b, splits, split_rows, kv, hd)
    m = s.amax(dim=-1)
    p = torch.where(torch.isfinite(m)[..., None], torch.exp(s - m[..., None]), 0.0)
    acc = torch.einsum("bgrsc,bscgd->bsgrd", p, v).reshape(b, splits, h, hd)
    m = m.permute(0, 3, 1, 2).reshape(b, splits, h)
    l = p.sum(dim=-1).permute(0, 3, 1, 2).reshape(b, splits, h)
    live = (torch.arange(splits, device=q.device)[None, :] * split_rows
            < lengths[:, None].long())
    return m, l, acc, live


def merge_split_partials(m, l, acc, live, dtype: torch.dtype) -> torch.Tensor:
    """Plain model of the merge kernel: the live splits' states of each slot
    combined in split order -> (B, H, hd) in ``dtype``; a split that is not
    live contributes nothing, whatever its state holds."""
    b, splits, h = m.shape
    big = torch.where(live[:, :, None], m, -torch.inf).amax(dim=1)
    out_l = torch.zeros((b, h), dtype=torch.float32, device=m.device)
    out = torch.zeros(acc.shape[:1] + acc.shape[2:], dtype=torch.float32, device=m.device)
    for s in range(splits):
        w = torch.where(live[:, s, None], torch.exp(m[:, s] - big), 0.0)
        out_l = out_l + torch.where(live[:, s, None], l[:, s] * w, 0.0)
        out = out + torch.where(live[:, s, None, None], acc[:, s] * w[..., None], 0.0)
    return (out / out_l[..., None]).to(dtype)


def paged_decode_split_plain(q, k_pages, v_pages, page_table, lengths, *, kv_codec: str = "fp",
                             k_scale=None, v_scale=None, sms: int = H100_SMS) -> torch.Tensor:
    """Plain model of K13 / K14's split schedule, a test aid (not on the
    card's path): :func:`paged_split_plan`'s splits, each split's partial
    state (:func:`paged_split_partials`), then :func:`merge_split_partials`
    -> (B, 1, H, hd) in q's dtype. Like the kernel it keeps the
    probabilities in fp32 and dequantizes codes to fp32."""
    b, _, h, hd = q.shape
    ps, kv = k_pages.shape[1], k_pages.shape[2]
    _, per = paged_split_plan(b, h, kv, ps, page_table.shape[1], sms)
    k_span, v_span = _span_rows(q, k_pages, v_pages, k_scale, v_scale, page_table, kv_codec)
    parts = paged_split_partials(q, k_span, v_span, lengths, per * ps)
    return merge_split_partials(*parts, q.dtype).reshape(b, 1, h, hd)


_PAGED_MODE = {"fp": 0, "int8_per_channel": 8, "int4_per_channel": 4}
_SM_COUNT: dict = {}


def _sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SM_COUNT[idx]


def _paged_lib() -> ctypes.CDLL:
    lib = cuda_build.library("paged_decode")
    if not getattr(lib, "_edgellm_declared", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.edgellm_paged_decode.argtypes = ([ptr] * 9 + [i32] * 10 + [ctypes.c_float]
                                             + [i32] * 2 + [ptr])
        lib.edgellm_paged_decode.restype = i32
        lib.edgellm_paged_decode_error.argtypes = [i32]
        lib.edgellm_paged_decode_error.restype = ctypes.c_char_p
        lib._edgellm_declared = True
    return lib


def _launch_paged(q, k_pages, v_pages, k_scale, v_scale, page_table, lengths, kv_codec: str,
                  plan):
    """Checks of the kernel's contract, then one call of the C entry point
    (the split kernel and, with more than one split, the merge) -> (B, 1, H,
    hd)."""
    b, s1, h, hd = q.shape
    pn, ps, kv = k_pages.shape[:3]
    pps = page_table.shape[1]
    tensors = [q, k_pages, v_pages, page_table, lengths] + (
        [k_scale, v_scale] if k_scale is not None else [])
    if any(t.device != q.device for t in tensors) or q.device.type != "cuda":
        raise ValueError("paged decode kernel inputs must share one CUDA device")
    if s1 != 1 or h % kv:
        raise ValueError(f"paged decode takes q_len=1 and H % KV == 0, got q {tuple(q.shape)}, "
                         f"KV={kv}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"paged decode takes float32 or bfloat16 q, got {q.dtype}")
    if (kv_codec == "fp" and k_pages.dtype != q.dtype) or k_pages.dtype != v_pages.dtype:
        raise ValueError(f"K13 takes pages in q's dtype, got q {q.dtype}, pages "
                         f"{k_pages.dtype}/{v_pages.dtype}")
    if kv_codec != "fp":
        want = torch.int8 if kv_codec == "int8_per_channel" else torch.uint8
        if k_pages.dtype != want or k_scale.dtype != torch.float32 \
                or v_scale.dtype != torch.float32:
            raise ValueError(f"K14 {kv_codec} takes {want} codes and float32 scales, got "
                             f"{k_pages.dtype}, {k_scale.dtype}/{v_scale.dtype}")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("page_table and lengths must be int32")
    # the kernel indexes every buffer by these extents without bounds checks
    if k_pages.dim() != 4 or v_pages.shape != k_pages.shape:
        raise ValueError(f"k/v pages must be one (num_pages, ps, KV, hdc) shape, got "
                         f"{tuple(k_pages.shape)} / {tuple(v_pages.shape)}")
    if kv_codec == "fp" and k_pages.shape[3] != hd:
        raise ValueError(f"page head dim {k_pages.shape[3]} does not match q's {hd}")
    if k_scale is not None and (k_scale.shape != (pn, ps, kv) or v_scale.shape != (pn, ps, kv)):
        raise ValueError(f"k/v scales must be {(pn, ps, kv)}, got {tuple(k_scale.shape)} / "
                         f"{tuple(v_scale.shape)}")
    if page_table.dim() != 2 or page_table.shape[0] != b or lengths.shape != (b,):
        raise ValueError(f"page_table must be ({b}, pages_per_slot) and lengths ({b},), got "
                         f"{tuple(page_table.shape)} and {tuple(lengths.shape)}")
    kind = "paged" if kv_codec == "fp" else "paged_quant"
    if plan is None or plan != (kind, (pps, ps)):
        raise ValueError(f"no kernel covers pps={pps}, ps={ps}, H={h}, KV={kv}, hd={hd} "
                         f"({kv_codec}): decode_plan refuses the shape")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged decode kernel inputs must be contiguous")
    # the kernel's bulk copies move whole page rows from 16-byte aligned addresses
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("k/v pages must start 16-byte aligned for the kernel's copies")
    splits, per = paged_split_plan(b, h, kv, ps, pps, _sm_count(q.device))
    ws = (torch.empty(b * splits * h * (hd + 2), dtype=torch.float32, device=q.device)
          if splits > 1 else None)
    lib = _paged_lib()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.edgellm_paged_decode(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            k_scale.data_ptr() if k_scale is not None else None,
            v_scale.data_ptr() if v_scale is not None else None,
            page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            ws.data_ptr() if ws is not None else None,
            b, h, kv, hd, ps, pps, pn, splits, per, PAGED_HEADS_PER_BLOCK, _inv_sqrt_hd(hd),
            _DTYPE_CODE[q.dtype],
            _PAGED_MODE[kv_codec], torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(lib, err, "paged_decode_attention", "edgellm_paged_decode_error")
    return out


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                           page_table: torch.Tensor, lengths: torch.Tensor, *,
                           plan) -> torch.Tensor:
    """Ragged single-position attention against a paged pool: q (B, 1, H, hd)
    per slot; k/v_pages (num_pages, page_size, KV, hd), one layer's pool;
    page_table (B, pages_per_slot) int32 names each slot's pages in logical
    order (0, the trash page, for unallocated tails); lengths (B,) int32
    counts each slot's valid positions, the one this step wrote included.
    Returns (B, 1, H, hd) in q's dtype.

    CUDA tensors launch K13 (``paged_decode_attention.launches`` counts the
    launches); CPU tensors take :func:`paged_decode_attention_plain`.
    ``plan`` is :func:`paged_plan`'s for these inputs; a CUDA call whose
    plan is None raises. K13 reads q in the pages' dtype: a bf16 q over
    float32 pages (bf16 weights over the batcher's default float32 cache)
    is widened exactly and the output rounded back to bf16, as the
    reference's kernel takes its scores and sums in float32."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pages, v_pages, page_table, lengths)
    if q.dtype == torch.bfloat16 and k_pages.dtype == torch.float32:
        out = _launch_paged(q.float(), k_pages, v_pages, None, None, page_table, lengths,
                            "fp", plan).to(q.dtype)
        paged_decode_attention.launches += 1
        return out
    out = _launch_paged(q, k_pages, v_pages, None, None, page_table, lengths, "fp", plan)
    paged_decode_attention.launches += 1
    return out


def paged_decode_attention_quant(q: torch.Tensor, k_pages: torch.Tensor,
                                 v_pages: torch.Tensor, k_scale: torch.Tensor,
                                 v_scale: torch.Tensor, page_table: torch.Tensor,
                                 lengths: torch.Tensor, *, kv_codec: str,
                                 plan) -> torch.Tensor:
    """:func:`paged_decode_attention` over a quantized pool: k/v_pages hold
    codes (num_pages, page_size, KV, hdc), hdc = hd for int8 and hd/2 for
    packed int4, with k/v_scale (num_pages, page_size, KV) fp32 per-row
    absmax scales, the layout :func:`quantize_kv_rows` writes.

    CUDA tensors launch K14, which dequantizes in registers
    (``paged_decode_attention_quant.launches`` counts the launches); CPU
    tensors take :func:`paged_decode_attention_quant_plain`. ``plan`` as
    for :func:`paged_decode_attention`."""
    hdc = k_pages.shape[3]
    hd = hdc * 2 if kv_codec == "int4_per_channel" else hdc
    if hd != q.shape[3]:
        raise ValueError(f"code width {hdc} does not match q head_dim {q.shape[3]} for "
                         f"tier {kv_codec!r}")
    if q.device.type == "cpu":
        return paged_decode_attention_quant_plain(q, k_pages, v_pages, k_scale, v_scale,
                                                  page_table, lengths, kv_codec=kv_codec)
    out = _launch_paged(q, k_pages, v_pages, k_scale, v_scale, page_table, lengths,
                        kv_codec, plan)
    paged_decode_attention_quant.launches += 1
    return out


paged_decode_attention.launches = 0
paged_decode_attention_quant.launches = 0


def paged_decode_bytes(q: torch.Tensor, k_pages: torch.Tensor, lengths: torch.Tensor,
                       kv_codec: str = "fp") -> float:
    """Bytes the paged decode attention must move for these inputs: the live
    K and V rows of every slot read once (codes plus scales on a quantized
    tier), q read once and the output written once."""
    kv, hdc = k_pages.shape[2], k_pages.shape[3]
    row = kv * (hdc * k_pages.element_size() + (4 if kv_codec != "fp" else 0))
    live = int(lengths.long().sum().item())
    return float(2 * live * row + 2 * q.numel() * q.element_size())


__all__ = ["MAX_BLOCKED_S", "VALIDATED_HD", "kernel_plan", "attn_split_plan", "causal_attention",
           "causal_attention_stats", "causal_attention_plain",
           "causal_attention_stats_plain", "attention_plain",
           "causal_attention_bytes_flops", "bound_ms",
           "KV_REST_TIERS", "MAX_PAGED_KV_BYTES", "quantize_kv_rows",
           "dequantize_kv_rows", "decode_plan", "paged_plan", "decode_attention", "verify_attention",
           "paged_decode_attention", "paged_decode_attention_quant",
           "paged_decode_attention_plain", "paged_decode_attention_quant_plain",
           "paged_decode_bytes", "paged_split_plan", "paged_split_partials", "merge_split_partials", "paged_decode_split_plain"]
