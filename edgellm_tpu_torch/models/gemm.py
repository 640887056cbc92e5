"""The model's fp32 matrix products on the card: a hand-written 3xTF32
``wgmma`` GEMM (``csrc/gemm_tf32x3.cu``), its prepared weight planes, its
plain PyTorch version and the rule that decides which product takes it.

The kernel computes ``C = A @ B`` for fp32 operands as three TF32 products
on the tensor cores: every operand x is split as hi = tf32(x), lo = tf32(x -
hi), both rounded as ``cvt.rna`` rounds, and a.b = a_lo.b_hi + a_hi.b_lo +
a_hi.b_hi in fp32 (a_lo.b_lo, 2^-22 relative, dropped): the rule of fp32
K-attn and the K-stats column pass. It replaces no TPU kernel (the JAX
package leaves these dots to XLA); the source says what bounds it.

B is the weight, constant within a run, so it is split once into two
**planes** (:func:`prepare_planes`): the hi and lo parts of B^T (one row an
output column, K-major as TF32 ``wgmma`` reads B), in the order a
shared-memory stage holds them, so that the kernel copies a stage's B tile
as it lies. A is split in registers inside the kernel.

Which product takes the kernel (:func:`route`): fp32 CUDA operands of at
least :data:`MIN_ROWS` rows and :data:`MIN_TILES` output tiles. CPU
tensors, other dtypes and smaller products keep ``torch.matmul``. ``transformer.linear`` applies the rule and keeps the
planes of every weight; :func:`gemm_tf32x3` launches the kernel for CUDA
tensors or raises, and takes :func:`gemm_tf32x3_plain` only for CPU tensors.

The grouped form (:func:`grouped_gemm_tf32x3`, one launch a sparse-expert
product over the experts a layer holds, ``models/moe.py``) takes A's rows in
expert order, each expert's planes stacked (:func:`prepare_grouped_planes`)
and the experts' row offsets as a device tensor that only the kernel reads.
Planes of a gate / up weight prepared with ``glu`` carry their epilogue: each
128-column tile holds 64 features' gate and up columns, and the product
stores ``silu(gate) * up``, F features a row, never the (M, 2F) product.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..utils import cuda_build
from .flash_attention import _sm_count

#: output rows and columns of the kernel's tile, and K values of a stage
TILE_M, TILE_N, CHUNK_K = 128, 128, 32
#: the fewest rows, and output tiles, a product needs to take the kernel,
#: from the crossover measured on an H100 (chip_smoke.py, PERF.md). The
#: kernel does not split K: below a wave its time is one tile's whole K
#: loop, whatever the tiles. At a decode step's single row cuBLAS was 2.6-17x
#: the faster at every (N, K) of both configurations, at 8 rows 1.6-9x at 7
#: of 8; at 24-42 tiles it won at some (N, K) (by up to 1.24x at 36 tiles of
#: 384 x 1536 x 8960) and lost at others; from 48 tiles on the kernel won at
#: every (N, K). cuBLAS keeps the fp32 decode steps, verify bursts and
#: short prefills, and the narrow k / v products up to 6016 (N = 128) and
#: 2944 (N = 256) rows
MIN_ROWS, MIN_TILES = TILE_M, 48
#: inside each 32 K values (a stage), plane position p = 8 kk + c (k8 step
#: kk, fragment column c) holds reduction index PLANE_ORDER[p]: a kernel
#: thread (t = lane % 4) reads the four consecutive values of piece 2t + g
#: of its rows, which fill its columns t and t + 4 of k8 steps 2g and 2g + 1
PLANE_ORDER = tuple(8 * t + 4 * g + 2 * kk + half
                    for g in range(2) for kk in range(2) for half in range(2)
                    for t in range(4))


class Planes(NamedTuple):
    """A weight's prepared TF32 planes: ``hi`` and ``lo`` of shape
    (ceil(K / 32), R, 32), R the rows (output columns) rounded up to 8, each
    row's 16-byte pieces in their swizzled order; ``k`` the reduction length
    and ``rows`` the rows before rounding."""

    hi: torch.Tensor
    lo: torch.Tensor
    k: int
    rows: int


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> TF32 as ``cvt.rna.tf32.f32``: half of the last kept bit added
    to the magnitude, then the 13 low mantissa bits cleared (to nearest,
    ties away from zero)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo): x = hi + lo + O(2^-22 |x|), both TF32."""
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def _swizzle_index(device) -> tuple[torch.Tensor, torch.Tensor]:
    """Index pair that moves piece q of row r (r % 8 = a) to q ^ a, and back."""
    a = torch.arange(8, device=device)
    return a[:, None], a[None, :] ^ a[:, None]


def prepare_planes(rows: torch.Tensor) -> Planes:
    """The planes of ``rows`` (R, K), B^T of a product (row n: output column
    n's K weights), in fp32 (a copy; ``rows`` is not changed): K padded with
    zeros to a multiple of 32 and R to a multiple of 8, each 32 K values in
    :data:`PLANE_ORDER`, split into TF32 hi and lo, laid out chunk by chunk
    of 32 K values, and each row's eight 16-byte pieces swizzled (piece q of
    row r at q ^ (r % 8)), as the kernel's shared-memory stage holds B."""
    r, k = rows.shape
    kp, rp = -(-k // CHUNK_K) * CHUNK_K, -(-r // 8) * 8
    x = F.pad(rows.float(), (0, kp - k, 0, rp - r))
    x = x.view(rp, kp // CHUNK_K, 4, 2, 2, 2).permute(0, 1, 3, 4, 5, 2).reshape(rp, kp)
    ph, q = _swizzle_index(x.device)

    def lay(t):  # (R, kp) -> (kp / 32, R, 32), swizzled
        t = t.view(rp, kp // CHUNK_K, CHUNK_K).transpose(0, 1).reshape(
            kp // CHUNK_K, rp // 8, 8, 8, 4)
        return t[:, :, ph, q, :].reshape(kp // CHUNK_K, rp, CHUNK_K).contiguous()

    hi, lo = split_tf32(x)
    return Planes(lay(hi), lay(lo), k, r)


def unpack_planes(planes: Planes, n0: int = 0, n: Optional[int] = None):
    """The (hi, lo) rows n0 .. n0 + n - 1 of ``planes`` as (n, K) tensors in
    the reduction's own order: :func:`prepare_planes` undone."""
    kc, rp, _ = planes.hi.shape
    n = planes.rows - n0 if n is None else n
    ph, q = _swizzle_index(planes.hi.device)

    def unlay(t):
        t = t.view(kc, rp // 8, 8, 8, 4)[:, :, ph, q, :].reshape(kc, rp, CHUNK_K)
        t = t.transpose(0, 1).reshape(rp, kc, 2, 2, 2, 4).permute(0, 1, 5, 2, 3, 4)
        return t.reshape(rp, kc * CHUNK_K)[n0:n0 + n, :planes.k]

    return unlay(planes.hi), unlay(planes.lo)


def gemm_tf32x3_plain(a: torch.Tensor, planes: Planes, n0: int = 0,
                      n: Optional[int] = None) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: A split into TF32 (hi, lo),
    the planes' rows n0 .. n0 + n - 1 as B^T, a_lo.b_hi + a_hi.b_lo +
    a_hi.b_hi summed in fp32 (each product of two TF32 values is exact in
    fp32; the sums run in another order than the kernel's)."""
    b_hi, b_lo = unpack_planes(planes, n0, n)
    a_hi, a_lo = split_tf32(a.float())
    return a_lo @ b_hi.T + a_hi @ b_lo.T + a_hi @ b_hi.T


def route(device_type: str, a_dtype: torch.dtype, b_dtype: torch.dtype,
          rows: int, cols: int) -> Optional[str]:
    """None where a (rows, cols) product takes the kernel, else why
    ``torch.matmul`` keeps it: "cpu" (not a CUDA tensor), "bf16" (an operand
    not fp32: the bf16 paths keep their cuBLAS bf16 GEMMs) or "small_m"
    (fewer than :data:`MIN_ROWS` rows, or than :data:`MIN_TILES` tiles)."""
    if device_type != "cuda":
        return "cpu"
    if a_dtype != torch.float32 or b_dtype != torch.float32:
        return "bf16"
    if rows < MIN_ROWS or -(-rows // TILE_M) * -(-cols // TILE_N) < MIN_TILES:
        return "small_m"
    return None


def _lib() -> ctypes.CDLL:
    lib = cuda_build.library("gemm_tf32x3")
    if not getattr(lib, "_edgellm_declared", False):
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.edgellm_gemm_tf32x3.argtypes = [ptr] * 4 + [i32] * 3 + [i64] * 2 + [i32] * 3 + [ptr]
        lib.edgellm_gemm_tf32x3.restype = i32
        lib.edgellm_gemm_tf32x3_grouped.argtypes = ([ptr] * 4 + [i32] * 3 + [i64] * 2 + [i32]
                                                    + [i64, ptr, i32, i32, i32, ptr])
        lib.edgellm_gemm_tf32x3_grouped.restype = i32
        lib.edgellm_gemm_tf32x3_error.argtypes = [i32]
        lib.edgellm_gemm_tf32x3_error.restype = ctypes.c_char_p
        lib._edgellm_declared = True
    return lib


def _check(a: torch.Tensor, planes: Planes, n0: int, n: int):
    """The kernel's contract; raises on what it does not take."""
    if a.dim() != 2 or a.dtype != torch.float32 or a.device.type != "cuda":
        raise ValueError(f"the 3xTF32 GEMM takes a 2-D float32 CUDA A, got "
                         f"{tuple(a.shape)} {a.dtype} on {a.device}")
    if not a.is_contiguous():
        raise ValueError("A must be contiguous (rows of K values, 16-byte copies)")
    if a.shape[1] != planes.k or planes.k % 4:
        raise ValueError(f"A has K = {a.shape[1]}, the planes {planes.k}; the kernel "
                         f"copies rows in 16-byte pieces, so K must be a multiple of 4")
    for t in (planes.hi, planes.lo):
        if t.device != a.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("the planes must be contiguous float32 on A's device")
    if a.data_ptr() % 16:
        raise ValueError("A's base must be 16-byte aligned for the kernel's copies")
    if not (0 <= n0 and n > 0 and n0 + n <= planes.rows):
        raise ValueError(f"columns {n0} .. {n0 + n - 1} outside the planes' "
                         f"{planes.rows} rows")


def gemm_tf32x3(a: torch.Tensor, planes: Planes, n0: int = 0,
                n: Optional[int] = None) -> torch.Tensor:
    """``a @ B`` (M, n) float32, B^T being rows n0 .. n0 + n - 1 of
    ``planes``. CUDA tensors launch the kernel (``gemm_tf32x3.launches``
    counts the launches) or raise; CPU tensors take
    :func:`gemm_tf32x3_plain`."""
    n = planes.rows - n0 if n is None else n
    if a.device.type == "cpu":
        return gemm_tf32x3_plain(a, planes, n0, n)
    _check(a, planes, n0, n)
    m = a.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if m == 0:
        return out
    lib = _lib()
    with torch.cuda.device(a.device):
        err = lib.edgellm_gemm_tf32x3(
            a.data_ptr(), planes.hi.data_ptr(), planes.lo.data_ptr(), out.data_ptr(),
            m, n, planes.k, a.stride(0), out.stride(0), planes.hi.shape[1], n0,
            _sm_count(a.device), torch.cuda.current_stream(a.device).cuda_stream)
    if err:
        msg = lib.edgellm_gemm_tf32x3_error(err).decode()
        raise RuntimeError(f"gemm_tf32x3 kernel launch failed: CUDA error {err} ({msg})")
    gemm_tf32x3.launches += 1
    return out


gemm_tf32x3.launches = 0


#: experts one grouped launch holds (the kernel's ``kMaxExperts``)
MAX_EXPERTS = 256
#: features of a gate / up tile in glu planes: half the kernel's N tile
GLU_FEATURES = TILE_N // 2


class GroupedPlanes(NamedTuple):
    """The planes of E experts' weights, one :class:`Planes` layout each,
    stacked: ``hi`` and ``lo`` (E, ceil(K / 32), R, 32); ``k`` the reduction
    length, ``rows`` the output's columns N; ``glu``: a gate / up weight's
    planes, whose product stores silu(gate) * up, ``rows`` features."""

    hi: torch.Tensor
    lo: torch.Tensor
    k: int
    rows: int
    glu: bool = False

    @property
    def cols(self) -> int:
        """Columns of the product the kernel computes: ``rows``, or with
        ``glu`` a gate and an up column a feature, features padded to
        :data:`GLU_FEATURES`."""
        return 2 * -(-self.rows // GLU_FEATURES) * GLU_FEATURES if self.glu else self.rows

    def expert(self, e: int) -> Planes:
        return Planes(self.hi[e], self.lo[e], self.k, self.cols)


def _glu_columns(w: torch.Tensor) -> torch.Tensor:
    """A gate / up weight (K, 2F), gate then up, as (K, 2 Fp): Fp = F padded
    with zero columns to :data:`GLU_FEATURES`, and each GLU_FEATURES features'
    gate columns followed by the same features' up columns."""
    f = w.shape[1] // 2
    fp = -(-f // GLU_FEATURES) * GLU_FEATURES
    gate, up = (F.pad(h, (0, fp - f)).view(w.shape[0], -1, GLU_FEATURES)
                for h in (w[:, :f], w[:, f:]))
    return torch.stack([gate, up], dim=2).reshape(w.shape[0], 2 * fp)


def glu_epilogue(h: torch.Tensor, f: int) -> torch.Tensor:
    """The glu kernel's epilogue in plain PyTorch: a product over glu planes'
    columns (M, 2 Fp) -> silu(gate) * up (M, f)."""
    gate, up = h.view(h.shape[0], -1, 2, GLU_FEATURES).unbind(2)
    return (F.silu(gate) * up).reshape(h.shape[0], -1)[:, :f]


def prepare_grouped_planes(w: torch.Tensor, glu: bool = False) -> GroupedPlanes:
    """The planes of experts' weights ``w`` (E, K, N) in the ``x @ W``
    layout: expert e's B^T prepared as :func:`prepare_planes` prepares one
    weight, one expert at a time (so the transient copies stay one
    expert's), stacked. ``glu``: ``w`` is a gate / up weight (N = 2F, gate
    then up), laid out by :func:`_glu_columns` for the kernel's silu(gate) *
    up epilogue."""
    if glu and w.shape[2] % 2:
        raise ValueError(f"a gate / up weight has 2F columns, got {w.shape[2]}")
    parts = [prepare_planes((_glu_columns(w[e]) if glu else w[e]).T) for e in range(w.shape[0])]
    return GroupedPlanes(torch.stack([p.hi for p in parts]), torch.stack([p.lo for p in parts]),
                         w.shape[1], w.shape[2] // 2 if glu else w.shape[2], glu)


def grouped_gemm_tf32x3_plain(a: torch.Tensor, planes: GroupedPlanes,
                              offsets: torch.Tensor, out: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """The grouped kernel's arithmetic in plain PyTorch: rows offsets[e] ..
    offsets[e + 1] - 1 of A times expert e's B by :func:`gemm_tf32x3_plain`
    (with ``planes.glu`` through :func:`glu_epilogue`), written into ``out``
    (M, N) float32 where given, else into zeros; rows outside every expert's
    range are left as they are (the kernel leaves them unwritten). Reads the
    offsets on the host."""
    if out is None:
        out = a.new_zeros((a.shape[0], planes.rows), dtype=torch.float32)
    bounds = offsets.tolist()
    for e in range(len(bounds) - 1):
        r0, r1 = bounds[e], bounds[e + 1]
        if r1 > r0:
            h = gemm_tf32x3_plain(a[r0:r1], planes.expert(e))
            out[r0:r1] = glu_epilogue(h, planes.rows) if planes.glu else h
    return out


def grouped_gemm_tf32x3(a: torch.Tensor, planes: GroupedPlanes,
                        offsets: torch.Tensor, out: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """(M, N) float32: rows offsets[e] .. offsets[e + 1] - 1 of ``a`` (M, K)
    times expert e's B (glu planes: silu(gate) * up of the product, N =
    ``planes.rows`` features), for the E experts of ``planes``; ``offsets``
    (E + 1,) int32 on ``a``'s device, non-decreasing in [0, M]. On CUDA one
    launch of the grouped kernel, whose grid is the SM count and which
    reads the offsets itself: nothing here waits on the device, and rows
    outside every expert's range are left unwritten, in ``out`` (contiguous
    (M, N) float32) where one is given (``grouped_gemm_tf32x3.launches``
    counts the launches). CPU tensors take :func:`grouped_gemm_tf32x3_plain`."""
    n_exp = planes.hi.shape[0]
    if tuple(offsets.shape) != (n_exp + 1,):
        raise ValueError(f"{n_exp} experts need {n_exp + 1} offsets, got {tuple(offsets.shape)}")
    m = a.shape[0]
    if out is not None and (tuple(out.shape) != (m, planes.rows) or out.dtype != torch.float32
                            or out.device != a.device or not out.is_contiguous()):
        raise ValueError(f"out must be contiguous ({m}, {planes.rows}) float32 on A's device")
    if a.device.type == "cpu":
        return grouped_gemm_tf32x3_plain(a, planes, offsets, out)
    _check(a, planes.expert(0), 0, planes.cols)
    if offsets.dtype != torch.int32 or offsets.device != a.device or not offsets.is_contiguous():
        raise ValueError("the offsets must be contiguous int32 on A's device")
    if n_exp > MAX_EXPERTS:
        raise ValueError(f"{n_exp} experts: one grouped launch holds at most {MAX_EXPERTS}")
    if out is None:
        out = torch.empty((m, planes.rows), dtype=torch.float32, device=a.device)
    if m == 0:
        return out
    lib = _lib()
    with torch.cuda.device(a.device):
        err = lib.edgellm_gemm_tf32x3_grouped(
            a.data_ptr(), planes.hi.data_ptr(), planes.lo.data_ptr(), out.data_ptr(),
            m, planes.rows, planes.k, a.stride(0), out.stride(0), planes.hi.shape[2],
            planes.hi[0].numel(), offsets.data_ptr(), n_exp, int(planes.glu),
            _sm_count(a.device), torch.cuda.current_stream(a.device).cuda_stream)
    if err:
        msg = lib.edgellm_gemm_tf32x3_error(err).decode()
        raise RuntimeError(f"grouped gemm_tf32x3 kernel launch failed: CUDA error {err} ({msg})")
    grouped_gemm_tf32x3.launches += 1
    return out


grouped_gemm_tf32x3.launches = 0
