"""Causal prefill attention for the sweep: two hand-written Hopper kernels,
their plain PyTorch versions, and the shape envelope that decides which runs.

PyTorch counterpart of the prefill half of ``edgellm_tpu/models/flash_attention.py``.
The TPU package has four Pallas kernels here: the whole-sequence kernels
``_attn_packed`` / ``_attn_packed_stats`` and their query-blocked twins
``_attn_blocked`` / ``_attn_blocked_stats``. The whole/blocked split exists
only because of the TPU's VMEM; on Hopper one kernel per function covers both
plans:

- **K-attn** (``csrc/causal_attention.cu``), behind :func:`causal_attention`:
  flash-style exact causal attention, one block per (query tile, head, batch
  row), online softmax in fp32, q and the output in the packed (B, S, H*hd)
  layout, K/V read through their strides.
- **K-stats** (``csrc/attention_stats.cu``), behind
  :func:`causal_attention_stats`: K-attn's forward also writes the row
  log-sum-exp, then a column pass (one block per key tile) sums
  ``exp(s - lse)`` down the columns into ``col_sum / S`` and writes the last
  query row. Two passes, no atomics, deterministic.

A wrapper launches its kernel for CUDA tensors and takes the plain version
only for CPU tensors. Which shapes reach a kernel is decided by plan
(:func:`kernel_plan`, the TPU envelope: hd in {64, 128}, head-aligned GQA,
S <= 2048); ``transformer.attention`` sends a shape without a plan to the
plain version. A CUDA tensor outside the wrapper's checks raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

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
            lib.edgellm_attn_fwd.argtypes = [ptr] * 5 + [i32] * 6 + [i64] * 10 + [ptr]
            lib.edgellm_attn_fwd.restype = i32
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
    _resolve(q, k, plan)


def _raise_on(lib, err: int, what: str, errfn: str):
    if err:
        msg = getattr(lib, errfn)(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} ({msg})")


def _launch_fwd(q, k, v, with_lse: bool):
    b, s, h, hd = q.shape
    lib = _lib("causal_attention")
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
           if with_lse else None)
    with torch.cuda.device(q.device):
        err = lib.edgellm_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if lse is not None else None,
            b, s, h, k.shape[2], hd, _DTYPE_CODE[q.dtype],
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
    launches); CPU tensors take :func:`causal_attention_plain`. ``plan``
    (from :func:`kernel_plan`) is resolved from the shape when omitted; a
    shape without one raises."""
    if q.device.type == "cpu":
        _resolve(q, k, plan)
        return causal_attention_plain(q, k, v)
    _check_inputs(q, k, v, plan)
    causal_attention.launches += 1
    return _launch_fwd(q, k, v, with_lse=False)[0]


def causal_attention_stats(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                           plan=None):
    """Causal attention + (col_sum / S, last_row) stats from (B, S, H, hd).
    Returns (out (B, S, H, hd), (col_sum (B, H, S), last_row (B, H, S))),
    the stats fp32.

    CUDA tensors launch K-stats, K-attn's forward with the row log-sum-exp
    and then the column pass (``causal_attention_stats.launches`` counts each
    such pair once); CPU tensors take :func:`causal_attention_stats_plain`."""
    if q.device.type == "cpu":
        _resolve(q, k, plan)
        return causal_attention_stats_plain(q, k, v)
    _check_inputs(q, k, v, plan)
    causal_attention_stats.launches += 1
    out, lse = _launch_fwd(q, k, v, with_lse=True)
    return out, _launch_col(q, k, lse)


causal_attention.launches = 0
causal_attention_stats.launches = 0


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


#: H100 SXM published peaks (dense): bf16 tensor cores, fp32 outside the
#: tensor cores (the fp32 path allows no TF32), HBM3 bytes/s
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES_PER_S = 3.35e12


def bound_ms(nbytes: float, flops: float, dtype: torch.dtype):
    """Roofline bound in ms on an H100 SXM: the larger of the bytes over the
    memory rate and the FLOPs over the peak rate for ``dtype`` ->
    (ms, "bytes" or "operations")."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


__all__ = ["MAX_BLOCKED_S", "VALIDATED_HD", "kernel_plan", "causal_attention",
           "causal_attention_stats", "causal_attention_plain",
           "causal_attention_stats_plain", "attention_plain",
           "causal_attention_bytes_flops", "bound_ms"]
