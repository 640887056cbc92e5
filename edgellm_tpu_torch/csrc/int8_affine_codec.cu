// K3 / K4: per-token affine int8 wire codec (the split path's default hop
// codec, int8_per_token), quantize and dequantize.
//
// Replaces the TPU kernels _int8_affine_encode_kernel (behind
// int8_affine_encode_pallas) and _int8_affine_decode_kernel (behind
// int8_affine_decode_pallas) of edgellm_tpu/codecs/pallas_kernels.py. The
// TPU version tiles the token axis in VMEM blocks; here one warp owns a
// token row and a block holds kRowsPerBlock rows:
//
// - encode: the row is read once, 16 bytes a lane (4 float32 or 8 bf16 /
//   fp16 values), and kept in registers. Each value is widened exactly to
//   float32 there and, when the caller asks, saturated as sanitize_hidden
//   does (clamp to +-bound, bound = max_mag rounded to the input's dtype,
//   then NaN -> 0), so the twin's saturate -> widen -> encode is this one
//   launch. min and max are reduced by warp shuffles alone (no shared
//   memory, no block barrier), then the row is quantized from registers:
//   scale = (max - min) * f32(1/255) (a multiply, as the reference writes
//   it), safe = scale > 0 ? scale : 1, zp = rint(-128 - min / safe),
//   q = clip(rint(x / safe) + zp, -128, 127). Codes leave in 4-byte (float32
//   input) or 8-byte (16-bit input) stores, coalesced across the warp; lane
//   0 writes scale and min. The body is a template on NV, the 16-byte
//   vectors a lane holds (NV = 7 at D = 896 in float32). A row that is not
//   whole 16-byte vectors on a 16-byte boundary, or wider than 32 vectors a
//   lane, takes the scalar body: the same math in two passes over the row,
//   the second from L2.
// - decode: safe and zp once a row; codes read 16 bytes a lane, up to
//   kDecodePrefetch loads in flight, each staged in 512 bytes of shared
//   memory a warp (no block barrier) so that each lane's float4 stores sit
//   beside its neighbours': (q - zp) * safe, and rows whose scale is 0
//   (constant tokens) reconstructed as exactly min. Rows with D % 16 != 0 or
//   off a 16-byte boundary take a scalar body.
//
// The encode's arithmetic, not its bytes, bounded a first body of this
// design: IEEE division, rintf and the float-to-int cast run on the card's
// special-function and conversion units at an eighth of the FMA rate or
// less, and cost more than the row's loads. So where a row's range allows,
// RowQuant divides by the row's reciprocal with two exact corrections and
// rounds and casts with adds, on the FMA pipe, to the same bits.
//
// NaN: min and max are taken NaN-ignoring, beside a NaN flag
// (row_extremes). Saturating, a NaN counts as 0; else it makes min and max
// NaN, as jnp.min and torch.amin propagate it, and the clip keeps a NaN (as
// jnp.clip and torch.clamp do) that the integer cast then makes 0, as
// PyTorch's cast on the card does: without saturation a NaN row gives the
// plain version's payload too.
//
// Bound on this card: device memory. Encode reads 4 N D bytes (2 N D from a
// 16-bit hidden) and writes N D + 8 N; decode reads N D + 8 N and writes
// 4 N D. At Qwen2-0.5B's split shape (N = 4096, D = 896) that is 18.4 MB,
// 5.5 us at 3.35 TB/s (11.0 MB, 3.3 us, for the encode of a bf16 hidden).
#include "codec_common.cuh"

#include <cuda_fp16.h>

namespace edgellm {

constexpr int kRowsPerBlock = kCodecThreads / 32;  // one warp a row
constexpr int kDecodePrefetch = 4;  // a decode lane's 16-byte loads in flight

// 16-bit inputs by their bits: widening is exact, so no rounding mode enters
struct Bf16 {
  unsigned short bits;
};
struct F16 {
  unsigned short bits;
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(Bf16 v) { return __uint_as_float((unsigned)v.bits << 16); }
__device__ __forceinline__ float widen(F16 v) { return __half2float(__ushort_as_half(v.bits)); }

// one 16-byte vector of T, widened to float32
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  static constexpr int kElems = 4;
  static __device__ __forceinline__ void widen(uint4 raw, float* v) {
    v[0] = __uint_as_float(raw.x);
    v[1] = __uint_as_float(raw.y);
    v[2] = __uint_as_float(raw.z);
    v[3] = __uint_as_float(raw.w);
  }
};
template <>
struct Vec16<Bf16> {
  static constexpr int kElems = 8;
  static __device__ __forceinline__ void widen(uint4 raw, float* v) {
    const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // element 2k in the low half of word k
      v[2 * k] = __uint_as_float(w[k] << 16);
      v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
};
template <>
struct Vec16<F16> {
  static constexpr int kElems = 8;
  static __device__ __forceinline__ void widen(uint4 raw, float* v) {
    const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[2 * k] = __half2float(__ushort_as_half((unsigned short)(w[k] & 0xffffu)));
      v[2 * k + 1] = __half2float(__ushort_as_half((unsigned short)(w[k] >> 16)));
    }
  }
};

// sanitize_hidden on a widened value: clamp to [-bound, bound], NaN -> 0
__device__ __forceinline__ float saturate(float v, float bound) {
  return isnan(v) ? 0.f : fminf(fmaxf(v, -bound), bound);
}

// clip(rint(v / safe) + zp, -128, 127) as an int8 code, the reference's
// float32 steps one by one: IEEE division, rint (half to even)
__device__ __forceinline__ unsigned code(float v, float safe, float zp) {
  float c = __fadd_rn(rintf(__fdiv_rn(v, safe)), zp);
  c = c < -128.f ? -128.f : (c > 127.f ? 127.f : c);  // a NaN stays NaN...
  return (unsigned)(int)c & 0xffu;                     // ...and converts to 0
}

// 1.5 * 2^23: for |v| <= 2^22, (v + it) - it is rint(v) (the add rounds
// half to even), and for an integer c in [-128, 127] the low byte of
// c + it is c's two's complement byte
constexpr float kRoundMagic = 12582912.f;

// The row's (min, max) as the encode sees it, from the widened values'
// NaN-ignoring min and max and whether any value was NaN. Saturating, the
// clamp is monotone, so the saturated row's extremes are the clamped
// extremes, and a NaN joins them as 0; else a NaN makes both NaN, as jnp.min
// and torch.amin propagate it. Returns whether the values themselves need
// saturating (the same for the whole warp).
__device__ __forceinline__ bool row_extremes(float& mn, float& mx, bool has_nan, float bound,
                                             int saturating) {
  if (!saturating) {
    if (has_nan) mn = mx = __int_as_float(0x7fffffff);
    return false;
  }
  const bool clamp = has_nan || mn < -bound || mx > bound;
  mn = fminf(fmaxf(mn, -bound), bound);
  mx = fminf(fmaxf(mx, -bound), bound);
  if (has_nan) {
    mn = fminf(mn, 0.f);
    mx = fmaxf(mx, 0.f);
  }
  return clamp;
}

// One row's quantizer. scale, safe and zp as the reference computes them.
// Where the row's range allows (safe in [2^-100, 2^100] and |min| + |max| <=
// 2^22 safe: no overflow or underflow on the way, every |v / safe| <= 2^22),
// v / safe is taken from the row's correctly rounded reciprocal inv =
// RN(1 / safe): q0 = v * inv is within 1.5 ulp of v / safe, one correction
// q1 = q0 + (v - safe q0) inv makes it faithful, and a second (Markstein's
// theorem: inv within half an ulp of 1 / safe, q1 within an ulp) gives
// RN(v / safe), the IEEE quotient, with the residuals exact in an FMA. A
// value below 2^-103 (whose residual may underflow) has |v / safe| < 2^-3,
// so its code is zp's whatever the last bits. Then q + kRoundMagic rounds
// q half to even and holds rint(q) + 0x4B400000 in its bits; rint(q) + zp
// is an integer under 2^24 in magnitude, exact in float32 as in int, so the
// reference's add, clip and cast are an integer add and clamp. A row
// outside the range (NaN, Inf, an offset over 2^22 steps) divides value by
// value.
struct RowQuant {
  float scale, safe, zp, inv;
  int zp_bits;  // zp less the bits of kRoundMagic
  bool fast;
  __device__ __forceinline__ RowQuant(float mn, float mx) {
    scale = __fmul_rn(__fsub_rn(mx, mn), kInv255);
    safe = scale > 0.f ? scale : 1.f;
    zp = zero_point(mn, safe);
    inv = __frcp_rn(safe);
    // |min| + |max| bounds every |v| and is NaN where either is
    fast = safe >= 0x1p-100f && safe <= 0x1p100f &&
           __fadd_rn(fabsf(mn), fabsf(mx)) <= safe * 0x1p22f;
    zp_bits = fast ? (int)zp - (int)__float_as_uint(kRoundMagic) : 0;
  }
  // v's code in the low byte: through the reciprocal (kFast) or by division
  template <bool kFast>
  __device__ __forceinline__ unsigned code_of(float v) const {
    if constexpr (!kFast) {
      return code(v, safe, zp);
    } else {
      float q = __fmul_rn(v, inv);
      q = __fmaf_rn(__fmaf_rn(-safe, q, v), inv, q);  // faithful
      q = __fmaf_rn(__fmaf_rn(-safe, q, v), inv, q);  // RN(v / safe)
      const int c = (int)__float_as_uint(__fadd_rn(q, kRoundMagic)) + zp_bits;
      return (unsigned)min(max(c, -128), 127);
    }
  }
};

// four codes' low bytes, the first lowest
__device__ __forceinline__ unsigned pack4(unsigned a, unsigned b, unsigned c, unsigned d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// The vector body's second pass: each lane's vectors quantized from the
// registers, the codes stored 4 or 8 bytes at a time.
template <bool kFast, typename T, int NV>
__device__ __forceinline__ void quantize_row(const uint4 (&raw)[NV], int nvec, int lane,
                                             const RowQuant& quant, bool clamp, float bound,
                                             int8_t* qr) {
  constexpr int E = Vec16<T>::kElems;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int j = i * 32 + lane;
    if (j < nvec) {
      float v[E];
      Vec16<T>::widen(raw[i], v);
      unsigned c[E];
#pragma unroll
      for (int e = 0; e < E; ++e)
        c[e] = quant.code_of<kFast>(clamp ? saturate(v[e], bound) : v[e]);
      if constexpr (E == 4) {
        reinterpret_cast<unsigned*>(qr)[j] = pack4(c[0], c[1], c[2], c[3]);
      } else {
        reinterpret_cast<uint2*>(qr)[j] =
            make_uint2(pack4(c[0], c[1], c[2], c[3]), pack4(c[4], c[5], c[6], c[7]));
      }
    }
  }
}

template <typename T, int NV>
__global__ void __launch_bounds__(kCodecThreads)
int8_affine_encode_vec(const T* __restrict__ x, int8_t* __restrict__ q,
                       float* __restrict__ scale, float* __restrict__ mn_out, long long n,
                       int d, float bound, int saturating) {
  constexpr int E = Vec16<T>::kElems;
  const int lane = threadIdx.x % 32;
  const long long r = (long long)blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  if (r >= n) return;  // the whole warp: no barrier below
  const int nvec = d / E;
  const uint4* xr = reinterpret_cast<const uint4*>(x + r * d);
  uint4 raw[NV];  // the row, as it arrived
#pragma unroll
  for (int i = 0; i < NV; ++i)
    if (i * 32 + lane < nvec) raw[i] = __ldg(xr + i * 32 + lane);
  float mn = INFINITY, mx = -INFINITY;
  bool nan = false;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (i * 32 + lane < nvec) {
      float v[E];
      Vec16<T>::widen(raw[i], v);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        mn = fminf(mn, v[e]);
        mx = fmaxf(mx, v[e]);
        nan |= v[e] != v[e];
      }
    }
  }
  mn = warp_reduce(mn, MinOp());
  mx = warp_reduce(mx, MaxOp());
  const bool clamp = row_extremes(mn, mx, __any_sync(0xffffffffu, nan), bound, saturating);
  const RowQuant quant(mn, mx);
  if (quant.fast)  // the same for the whole warp
    quantize_row<true, T, NV>(raw, nvec, lane, quant, clamp, bound, q + r * d);
  else
    quantize_row<false, T, NV>(raw, nvec, lane, quant, clamp, bound, q + r * d);
  if (lane == 0) {
    scale[r] = quant.scale;
    mn_out[r] = mn;
  }
}

template <typename T>
__global__ void __launch_bounds__(kCodecThreads)
int8_affine_encode_scalar(const T* __restrict__ x, int8_t* __restrict__ q,
                          float* __restrict__ scale, float* __restrict__ mn_out, long long n,
                          int d, float bound, int saturating) {
  const int lane = threadIdx.x % 32;
  const long long r = (long long)blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  if (r >= n) return;
  const T* xr = x + r * d;
  float mn = INFINITY, mx = -INFINITY;
  bool nan = false;
  for (int i = lane; i < d; i += 32) {
    const float v = widen(xr[i]);
    mn = fminf(mn, v);
    mx = fmaxf(mx, v);
    nan |= v != v;
  }
  mn = warp_reduce(mn, MinOp());
  mx = warp_reduce(mx, MaxOp());
  const bool clamp = row_extremes(mn, mx, __any_sync(0xffffffffu, nan), bound, saturating);
  const RowQuant quant(mn, mx);
  int8_t* qr = q + r * d;
  for (int i = lane; i < d; i += 32) {
    const float w = widen(xr[i]), v = clamp ? saturate(w, bound) : w;
    qr[i] = (int8_t)(quant.fast ? quant.code_of<true>(v) : quant.code_of<false>(v));
  }
  if (lane == 0) {
    scale[r] = quant.scale;
    mn_out[r] = mn;
  }
}

// (q - zp) * safe, or the row's min where its scale is 0
struct RowDequant {
  float safe, zp, mn;
  bool live;
  __device__ __forceinline__ RowDequant(float sc, float m) {
    live = sc > 0.f;
    safe = live ? sc : 1.f;
    zp = zero_point(m, safe);
    mn = m;
  }
  __device__ __forceinline__ float operator()(int c) const {
    return live ? __fmul_rn(__fsub_rn((float)c, zp), safe) : mn;
  }
};

__global__ void __launch_bounds__(kCodecThreads)
int8_affine_decode_vec(const int8_t* __restrict__ q, const float* __restrict__ scale,
                       const float* __restrict__ mn, float* __restrict__ out, long long n,
                       int d) {
  __shared__ uint4 stage[kRowsPerBlock][32];  // 512 codes a warp
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const long long r = (long long)blockIdx.x * kRowsPerBlock + warp;
  if (r >= n) return;
  const float sc = scale[r], m = mn[r];
  const uint4* qr = reinterpret_cast<const uint4*>(q + r * d);
  float4* orow = reinterpret_cast<float4*>(out + r * d);
  const unsigned* words = reinterpret_cast<const unsigned*>(stage[warp]);
  const int nvec = d / 16, nout = d / 4;
  for (int base = 0; base < nvec; base += 32 * kDecodePrefetch) {
    uint4 codes[kDecodePrefetch];  // up to kDecodePrefetch 512-code steps in flight
#pragma unroll
    for (int p = 0; p < kDecodePrefetch; ++p)
      if (base + 32 * p + lane < nvec) codes[p] = __ldg(qr + base + 32 * p + lane);
    const RowDequant deq(sc, m);  // its division runs while the codes load
#pragma unroll
    for (int p = 0; p < kDecodePrefetch; ++p) {
      const int step = base + 32 * p;  // the step's first vector
      if (step >= nvec) break;
      stage[warp][lane] = codes[p];
      __syncwarp();
#pragma unroll
      for (int s = 0; s < 4; ++s) {  // float4 f holds codes 4f..4f+3: word f - 4 step
        const int f = 4 * step + 32 * s + lane;
        if (f < nout) {
          const unsigned w = words[32 * s + lane];
          orow[f] = make_float4(deq((int)(signed char)(w & 0xffu)),
                                deq((int)(signed char)((w >> 8) & 0xffu)),
                                deq((int)(signed char)((w >> 16) & 0xffu)),
                                deq((int)(signed char)(w >> 24)));
        }
      }
      __syncwarp();  // the stage is read before the next step overwrites it
    }
  }
}

__global__ void __launch_bounds__(kCodecThreads)
int8_affine_decode_scalar(const int8_t* __restrict__ q, const float* __restrict__ scale,
                          const float* __restrict__ mn, float* __restrict__ out, long long n,
                          int d) {
  const int lane = threadIdx.x % 32;
  const long long r = (long long)blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  if (r >= n) return;
  const RowDequant deq(scale[r], mn[r]);
  const int8_t* qr = q + r * d;
  float* orow = out + r * d;
  for (int i = lane; i < d; i += 32) orow[i] = deq(qr[i]);
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

inline unsigned row_blocks(long long n) {
  return (unsigned)((n + kRowsPerBlock - 1) / kRowsPerBlock);
}

template <typename T>
cudaError_t launch_encode(const T* x, int8_t* q, float* scale, float* mn, long long n, int d,
                          float bound, int saturating, cudaStream_t stream) {
  constexpr int E = Vec16<T>::kElems;
  const int per_lane = (d / E + 31) / 32;  // 16-byte vectors a lane holds
  const unsigned grid = row_blocks(n);
  if (d % E != 0 || !aligned16(x) || !aligned16(q) || per_lane > 32) {
    int8_affine_encode_scalar<T><<<grid, kCodecThreads, 0, stream>>>(x, q, scale, mn, n, d,
                                                                     bound, saturating);
    return cudaGetLastError();
  }
#define EDGELLM_ENCODE_NV(NV)                                                               \
  if (per_lane <= NV) {                                                                     \
    int8_affine_encode_vec<T, NV><<<grid, kCodecThreads, 0, stream>>>(x, q, scale, mn, n, d, \
                                                                      bound, saturating);   \
    return cudaGetLastError();                                                              \
  }
  // the presets' widths hold exactly NV vectors a lane: 512 / 896 / 1536 /
  // 4096 take 4 / 7 / 12 / 32 in float32 and 2 / 4 / 6 / 16 in bf16
  EDGELLM_ENCODE_NV(1)
  EDGELLM_ENCODE_NV(2)
  EDGELLM_ENCODE_NV(3)
  EDGELLM_ENCODE_NV(4)
  EDGELLM_ENCODE_NV(6)
  EDGELLM_ENCODE_NV(7)
  EDGELLM_ENCODE_NV(8)
  EDGELLM_ENCODE_NV(12)
  EDGELLM_ENCODE_NV(16)
  EDGELLM_ENCODE_NV(24)
  EDGELLM_ENCODE_NV(32)
#undef EDGELLM_ENCODE_NV
  return cudaErrorInvalidValue;  // unreachable: per_lane <= 32
}

}  // namespace edgellm

// x (N, D) float32 (dtype 0), bf16 (1) or fp16 (2) -> q (N, D) int8, scale
// (N, 1), mn (N, 1) float32. With `saturating` each widened value is first
// clamped to +-bound and NaN made 0. Returns the cudaError_t of the launch
// (0 on success).
extern "C" int edgellm_int8_affine_encode(const void* x, int dtype, int8_t* q, float* scale,
                                          float* mn, long long n, int d, float bound,
                                          int saturating, void* stream) {
  using namespace edgellm;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch_encode(static_cast<const float*>(x), q, scale, mn, n, d, bound,
                                saturating, s);
    case 1:
      return (int)launch_encode(static_cast<const Bf16*>(x), q, scale, mn, n, d, bound,
                                saturating, s);
    case 2:
      return (int)launch_encode(static_cast<const F16*>(x), q, scale, mn, n, d, bound,
                                saturating, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// q (N, D) int8 + scale (N, 1) + mn (N, 1) -> out (N, D) float32.
extern "C" int edgellm_int8_affine_decode(const int8_t* q, const float* scale, const float* mn,
                                          float* out, long long n, int d, void* stream) {
  using namespace edgellm;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d % 16 == 0 && aligned16(q) && aligned16(out))
    int8_affine_decode_vec<<<row_blocks(n), kCodecThreads, 0, s>>>(q, scale, mn, out, n, d);
  else
    int8_affine_decode_scalar<<<row_blocks(n), kCodecThreads, 0, s>>>(q, scale, mn, out, n, d);
  return (int)cudaGetLastError();
}

extern "C" const char* edgellm_int8_affine_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
