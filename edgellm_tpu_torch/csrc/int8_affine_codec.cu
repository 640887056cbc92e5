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
// The row's load, saturation and quantize (and the decode's RowDequant)
// live in int8_row_codec.cuh, one copy that the fused hop K8
// (remote_hop.cu) runs too.
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
#include "int8_row_codec.cuh"

namespace edgellm {

constexpr int kDecodePrefetch = 4;  // a decode lane's 16-byte loads in flight

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
  uint4 raw[NV];  // the row, as it arrived
  float mn, mx;
  const bool clamp = load_row<T, NV>(reinterpret_cast<const uint4*>(x + r * d), nvec, lane,
                                     bound, saturating, raw, mn, mx);
  const RowQuant quant(mn, mx);
  int8_t* qr = q + r * d;
  auto store = [&](int j, const unsigned (&w)[E / 4]) {  // 4 or 8 bytes, aligned
    if constexpr (E == 4)
      reinterpret_cast<unsigned*>(qr)[j] = w[0];
    else
      reinterpret_cast<uint2*>(qr)[j] = make_uint2(w[0], w[1]);
  };
  if (quant.fast)  // the same for the whole warp
    quantize_row<true, T, NV>(raw, nvec, lane, quant, clamp, bound, store);
  else
    quantize_row<false, T, NV>(raw, nvec, lane, quant, clamp, bound, store);
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
