// K5 / K6 / K7: the per-channel and ternary wire codecs (int8_per_channel,
// int4_per_channel, ternary_mean, ternary_max), quantize(+pack) and
// unpack(+dequantize) against a (1, D) channel scale.
//
// Replaces the TPU kernels of edgellm_tpu/codecs/pallas_kernels.py:
// _chan_int8_encode_kernel and _chan_int8_decode_kernel (K5, behind
// chan_int8_encode_pallas / chan_int8_decode_pallas), _chan_int4_encode_kernel
// (K6, behind chan_int4_encode_pallas; its decode is K2 with a (1, D) scale,
// int4_codec.cu), and _ternary_encode_kernel / _ternary_decode_kernel (K7,
// behind ternary_encode_pallas / ternary_decode_pallas). As on the TPU, the
// (B, S) reduction to the channel scale runs outside the kernels (PyTorch
// ops here, XLA there); these are the elementwise passes against it.
//
// Every kernel is one grid-stride pass with no reduction and no shared
// memory; a thread owns one output byte (one code, one nibble pair, or one
// crumb quad) and reads the (1, D) scale of its channels:
//
// - K5 encode: q = rint(x / s * 127) as int8;
// - K5 decode: (q * s) * f32(1/127), the reference's q * s / 127 as XLA
//   compiles it (checked bit for bit against the jitted Pallas kernel);
// - K6 encode: rint(x / s * 7) + 8 with no clip (|x| <= s by construction),
//   lane i in the low nibble and lane i + D/2 in the high nibble;
// - K7 encode: clip(rint(x / s), -1, 1) + 1, lanes i, i + D/4, i + D/2 and
//   i + 3D/4 in bits 0-1, 2-3, 4-5 and 6-7 of byte i;
// - K7 decode: (crumb - 1) * s.
//
// Bound on this card: device memory. At Qwen2-0.5B's split shape (N = 4096,
// D = 896) K5 moves 18.4 MB (5.5 us at 3.35 TB/s), K6 encode 16.5 MB and K7
// 15.6 MB. The passes use scalar loads and are launch-bound at that size.
#include "codec_common.cuh"

namespace edgellm {

constexpr float kInv127 = (float)(1.0 / 127.0);

__global__ void __launch_bounds__(kCodecThreads)
chan_int8_encode_kernel(const float* __restrict__ x, const float* __restrict__ scale,
                        int8_t* __restrict__ q, long long total, int D) {
  const long long step = (long long)gridDim.x * kCodecThreads;
  for (long long i = (long long)blockIdx.x * kCodecThreads + threadIdx.x; i < total; i += step) {
    const float t = __fmul_rn(__fdiv_rn(x[i], scale[i % D]), 127.f);
    q[i] = (int8_t)(int)rintf(t);
  }
}

__global__ void __launch_bounds__(kCodecThreads)
chan_int8_decode_kernel(const int8_t* __restrict__ q, const float* __restrict__ scale,
                        float* __restrict__ out, long long total, int D) {
  const long long step = (long long)gridDim.x * kCodecThreads;
  for (long long i = (long long)blockIdx.x * kCodecThreads + threadIdx.x; i < total; i += step)
    out[i] = __fmul_rn(__fmul_rn((float)q[i], scale[i % D]), kInv127);
}

__device__ __forceinline__ int chan_int4_code(float v, float s) {
  return (int)rintf(__fmul_rn(__fdiv_rn(v, s), 7.f)) + 8;
}

__global__ void __launch_bounds__(kCodecThreads)
chan_int4_encode_kernel(const float* __restrict__ x, const float* __restrict__ scale,
                        uint8_t* __restrict__ packed, long long pairs, int half) {
  const long long step = (long long)gridDim.x * kCodecThreads;
  for (long long p = (long long)blockIdx.x * kCodecThreads + threadIdx.x; p < pairs; p += step) {
    const long long r = p / half;
    const int j = (int)(p - r * half);
    const float* xr = x + r * 2 * half;
    packed[p] = (uint8_t)(chan_int4_code(xr[j], scale[j]) |
                          (chan_int4_code(xr[j + half], scale[j + half]) << 4));
  }
}

__global__ void __launch_bounds__(kCodecThreads)
ternary_encode_kernel(const float* __restrict__ x, const float* __restrict__ scale,
                      uint8_t* __restrict__ packed, long long quads, int quarter) {
  const long long step = (long long)gridDim.x * kCodecThreads;
  for (long long p = (long long)blockIdx.x * kCodecThreads + threadIdx.x; p < quads; p += step) {
    const long long r = p / quarter;
    const int j = (int)(p - r * quarter);
    const float* xr = x + r * 4 * quarter;
    int byte = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = j + k * quarter;
      const float t = fminf(fmaxf(rintf(__fdiv_rn(xr[c], scale[c])), -1.f), 1.f);
      byte |= ((int)t + 1) << (2 * k);
    }
    packed[p] = (uint8_t)byte;
  }
}

__global__ void __launch_bounds__(kCodecThreads)
ternary_decode_kernel(const uint8_t* __restrict__ packed, const float* __restrict__ scale,
                      float* __restrict__ out, long long quads, int quarter) {
  const long long step = (long long)gridDim.x * kCodecThreads;
  for (long long p = (long long)blockIdx.x * kCodecThreads + threadIdx.x; p < quads; p += step) {
    const long long r = p / quarter;
    const int j = (int)(p - r * quarter);
    const int b = packed[p];
    float* o = out + r * 4 * quarter;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = j + k * quarter;
      o[c] = __fmul_rn((float)(((b >> (2 * k)) & 0x3) - 1), scale[c]);
    }
  }
}

}  // namespace edgellm

// Each entry point launches one kernel on `stream` and returns the
// cudaError_t of the launch (0 on success). Scales are (1, D) float32.

// x (N, D) float32 -> q (N, D) int8.
extern "C" int edgellm_chan_int8_encode(const float* x, const float* scale, int8_t* q,
                                        long long n, int d, void* stream) {
  using namespace edgellm;
  const long long total = n * (long long)d;
  chan_int8_encode_kernel<<<elementwise_blocks(total), kCodecThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(x, scale, q, total, d);
  return (int)cudaGetLastError();
}

// q (N, D) int8 -> out (N, D) float32.
extern "C" int edgellm_chan_int8_decode(const int8_t* q, const float* scale, float* out,
                                        long long n, int d, void* stream) {
  using namespace edgellm;
  const long long total = n * (long long)d;
  chan_int8_decode_kernel<<<elementwise_blocks(total), kCodecThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(q, scale, out, total, d);
  return (int)cudaGetLastError();
}

// x (N, D) float32, D even -> packed (N, D/2) uint8.
extern "C" int edgellm_chan_int4_encode(const float* x, const float* scale, uint8_t* packed,
                                        long long n, int d, void* stream) {
  using namespace edgellm;
  const long long pairs = n * (long long)(d / 2);
  chan_int4_encode_kernel<<<elementwise_blocks(pairs), kCodecThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(x, scale, packed, pairs, d / 2);
  return (int)cudaGetLastError();
}

// x (N, D) float32, D % 4 == 0 -> packed (N, D/4) uint8.
extern "C" int edgellm_ternary_encode(const float* x, const float* scale, uint8_t* packed,
                                      long long n, int d, void* stream) {
  using namespace edgellm;
  const long long quads = n * (long long)(d / 4);
  ternary_encode_kernel<<<elementwise_blocks(quads), kCodecThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(x, scale, packed, quads, d / 4);
  return (int)cudaGetLastError();
}

// packed (N, D/4) uint8 -> out (N, D) float32.
extern "C" int edgellm_ternary_decode(const uint8_t* packed, const float* scale, float* out,
                                      long long n, int d, void* stream) {
  using namespace edgellm;
  const long long quads = n * (long long)(d / 4);
  ternary_decode_kernel<<<elementwise_blocks(quads), kCodecThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(packed, scale, out, quads, d / 4);
  return (int)cudaGetLastError();
}

extern "C" const char* edgellm_channel_codec_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
