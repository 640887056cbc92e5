// K1 / K2: per-token symmetric int4 wire codec, quantize + nibble pack and
// unpack + dequantize.
//
// Replaces the TPU kernels _encode_kernel (behind int4_encode_pallas) and
// _decode_kernel (behind int4_decode_pallas and chan_int4_decode_pallas) of
// edgellm_tpu/codecs/pallas_kernels.py. The TPU version tiles the token axis
// in VMEM blocks of 8..256 rows; here blocks run in parallel and share
// nothing, so:
//
// - encode: one block per token row. The row is read once from device memory
//   into shared memory, reduced to max|x| across the block, and quantized
//   from shared memory: code = rint(clip(x / safe * 7, -8, 7)) + 8, lane i in
//   the low nibble and lane i + D/2 in the high nibble (the reference's
//   contiguous-half pairing). Any N >= 1 and any even D (up to the shared
//   memory a block can hold).
// - decode: a grid-stride elementwise pass, one packed byte per step:
//   (nibble - 8) * (scale * f32(1/7)), the TPU body's (nibble - 8) / 7 *
//   scale as XLA compiles it, with a per-row (N, 1) or per-channel (1, D)
//   scale, as the TPU body broadcasts either.
//
// Bound on this card: device memory. Encode reads 4 N D bytes and writes
// N D / 2 + 4 N; decode the reverse. At Qwen2-0.5B's split shape (N = 4096,
// D = 896) that is 16.5 MB, 4.9 us at 3.35 TB/s. The kernels are simple
// (scalar loads, one row per block) and launch-bound at that size.
#include "codec_common.cuh"

namespace edgellm {

constexpr float kInv7 = (float)(1.0 / 7.0);

__device__ __forceinline__ int int4_code(float v, float safe) {
  float t = __fmul_rn(__fdiv_rn(v, safe), 7.f);
  t = fminf(fmaxf(t, -8.f), 7.f);
  return (int)rintf(t) + 8;
}

__global__ void __launch_bounds__(kCodecThreads)
int4_encode_kernel(const float* __restrict__ x, uint8_t* __restrict__ packed,
                   float* __restrict__ scale, int D) {
  extern __shared__ float row[];  // D floats
  __shared__ float red[kCodecThreads / 32];
  const long long r = blockIdx.x;
  const float* xr = x + r * D;
  float m = 0.f;
  for (int i = threadIdx.x; i < D; i += kCodecThreads) {
    const float v = xr[i];
    row[i] = v;
    m = fmaxf(m, fabsf(v));
  }
  m = block_reduce(m, red, 0.f, MaxOp());
  const float safe = m > 0.f ? m : 1.f;
  const int half = D / 2;
  uint8_t* pr = packed + r * half;
  for (int j = threadIdx.x; j < half; j += kCodecThreads)
    pr[j] = (uint8_t)(int4_code(row[j], safe) | (int4_code(row[j + half], safe) << 4));
  if (threadIdx.x == 0) scale[r] = safe;
}

__global__ void __launch_bounds__(kCodecThreads)
int4_decode_kernel(const uint8_t* __restrict__ packed, const float* __restrict__ scale,
                   float* __restrict__ out, long long pairs, int half, int per_channel) {
  const long long step = (long long)gridDim.x * kCodecThreads;
  for (long long p = (long long)blockIdx.x * kCodecThreads + threadIdx.x; p < pairs; p += step) {
    const long long r = p / half;
    const int j = (int)(p - r * half);
    const int b = packed[p];
    const float lo = (float)((b & 0xF) - 8), hi = (float)((b >> 4) - 8);
    const float s_lo = per_channel ? scale[j] : scale[r];
    const float s_hi = per_channel ? scale[j + half] : scale[r];
    float* o = out + r * 2 * half;
    o[j] = __fmul_rn(lo, __fmul_rn(s_lo, kInv7));
    o[j + half] = __fmul_rn(hi, __fmul_rn(s_hi, kInv7));
  }
}

}  // namespace edgellm

// x (N, D) float32 -> packed (N, D/2) uint8, scale (N, 1) float32. Returns
// the cudaError_t of the launch (0 on success).
extern "C" int edgellm_int4_encode(const float* x, uint8_t* packed, float* scale, long long n,
                                   int d, void* stream) {
  using namespace edgellm;
  const size_t smem = sizeof(float) * (size_t)d;
  cudaError_t err = allow_row_smem(int4_encode_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  int4_encode_kernel<<<(unsigned)n, kCodecThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, packed, scale, d);
  return (int)cudaGetLastError();
}

// packed (N, D/2) uint8 + scale (N, 1), or (1, D) with per_channel = 1 ->
// out (N, D) float32.
extern "C" int edgellm_int4_decode(const uint8_t* packed, const float* scale, float* out,
                                   long long n, int d, int per_channel, void* stream) {
  using namespace edgellm;
  const long long pairs = n * (long long)(d / 2);
  int4_decode_kernel<<<elementwise_blocks(pairs), kCodecThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(packed, scale, out, pairs, d / 2,
                                                            per_channel);
  return (int)cudaGetLastError();
}

extern "C" const char* edgellm_int4_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
