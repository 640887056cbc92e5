// The per-token affine int8 row codec that K3 / K4 (int8_affine_codec.cu)
// and the fused hop K8 (remote_hop.cu) share: one warp owns a token row,
// reads it as 16-byte vectors of float32, bf16 or fp16 kept in registers,
// saturates it as sanitize_hidden does where asked, and quantizes it with
// the reference's float32 steps (RowQuant: scale, safe, zp, and each code
// bit for bit that of clip(rint(x / safe) + zp, -128, 127)); RowDequant is
// the decode's (q - zp) * safe. int8_affine_codec.cu's header says why the
// quotient is taken through the row's reciprocal.
#pragma once

#include "codec_common.cuh"

#include <cuda_bf16.h>
#include <cuda_fp16.h>

namespace edgellm {

constexpr int kRowsPerBlock = kCodecThreads / 32;  // one warp a row

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
// registers and handed to `sink(j, words)` as the row's vector j: words
// holds its E codes' bytes, 4 a word, the first lowest.
template <bool kFast, typename T, int NV, typename Sink>
__device__ __forceinline__ void quantize_row(const uint4 (&raw)[NV], int nvec, int lane,
                                             const RowQuant& quant, bool clamp, float bound,
                                             Sink&& sink) {
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
      unsigned words[E / 4];
#pragma unroll
      for (int w = 0; w < E / 4; ++w)
        words[w] = pack4(c[4 * w], c[4 * w + 1], c[4 * w + 2], c[4 * w + 3]);
      sink(j, words);
    }
  }
}

// The vector body's first pass: lane `lane`'s 16-byte vectors of a row (NV
// at most, nvec in the row) into raw, and the row's (min, max) as the
// encode sees it (row_extremes) -> whether the values need saturating.
template <typename T, int NV>
__device__ __forceinline__ bool load_row(const uint4* __restrict__ xr, int nvec, int lane,
                                         float bound, int saturating, uint4 (&raw)[NV],
                                         float& mn, float& mx) {
  constexpr int E = Vec16<T>::kElems;
#pragma unroll
  for (int i = 0; i < NV; ++i)
    if (i * 32 + lane < nvec) raw[i] = __ldg(xr + i * 32 + lane);
  mn = INFINITY;
  mx = -INFINITY;
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
  return row_extremes(mn, mx, __any_sync(0xffffffffu, nan), bound, saturating);
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

// float32 -> T rounded to nearest even, as torch's .to(dtype) on the card
__device__ __forceinline__ float narrow(float v, float*) { return v; }
__device__ __forceinline__ Bf16 narrow(float v, Bf16*) {
  return Bf16{__bfloat16_as_ushort(__float2bfloat16_rn(v))};
}
__device__ __forceinline__ F16 narrow(float v, F16*) {
  return F16{__half_as_ushort(__float2half_rn(v))};
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

inline unsigned row_blocks(long long n) {
  return (unsigned)((n + kRowsPerBlock - 1) / kRowsPerBlock);
}

}  // namespace edgellm
