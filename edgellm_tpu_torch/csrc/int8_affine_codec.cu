// K3 / K4: per-token affine int8 wire codec (the split path's default hop
// codec, int8_per_token), quantize and dequantize.
//
// Replaces the TPU kernels _int8_affine_encode_kernel (behind
// int8_affine_encode_pallas) and _int8_affine_decode_kernel (behind
// int8_affine_decode_pallas) of edgellm_tpu/codecs/pallas_kernels.py. The
// TPU version tiles the token axis in VMEM blocks; here:
//
// - encode: one block per token row. The row is read once into shared
//   memory, reduced to (min, max) across the block, then quantized from
//   shared memory: scale = (max - min) * f32(1/255) (a multiply, as the
//   reference writes it), safe = scale > 0 ? scale : 1,
//   zp = rint(-128 - min / safe), q = clip(rint(x / safe) + zp, -128, 127).
//   Any N >= 1, any D (up to the shared memory a block can hold).
// - decode: a grid-stride elementwise pass, (q - zp) * safe, with rows whose
//   scale is 0 (constant tokens) reconstructed as exactly min.
//
// Bound on this card: device memory. Encode reads 4 N D bytes and writes
// N D + 8 N; decode the reverse. At Qwen2-0.5B's split shape (N = 4096,
// D = 896) that is 18.4 MB, 5.5 us at 3.35 TB/s. The kernels are simple
// (scalar loads, one row per block) and launch-bound at that size.
#include "codec_common.cuh"

namespace edgellm {

__global__ void __launch_bounds__(kCodecThreads)
int8_affine_encode_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                          float* __restrict__ scale, float* __restrict__ mn_out, int D) {
  extern __shared__ float row[];  // D floats
  __shared__ float red[kCodecThreads / 32];
  const long long r = blockIdx.x;
  const float* xr = x + r * D;
  float mn = INFINITY, mx = -INFINITY;
  for (int i = threadIdx.x; i < D; i += kCodecThreads) {
    const float v = xr[i];
    row[i] = v;
    mn = fminf(mn, v);
    mx = fmaxf(mx, v);
  }
  mn = block_reduce(mn, red, INFINITY, MinOp());
  mx = block_reduce(mx, red, -INFINITY, MaxOp());
  const float sc = __fmul_rn(__fsub_rn(mx, mn), kInv255);
  const float safe = sc > 0.f ? sc : 1.f;
  const float zp = zero_point(mn, safe);
  int8_t* qr = q + r * D;
  for (int i = threadIdx.x; i < D; i += kCodecThreads) {
    float v = __fadd_rn(rintf(__fdiv_rn(row[i], safe)), zp);
    v = fminf(fmaxf(v, -128.f), 127.f);
    qr[i] = (int8_t)(int)v;
  }
  if (threadIdx.x == 0) {
    scale[r] = sc;
    mn_out[r] = mn;
  }
}

__global__ void __launch_bounds__(kCodecThreads)
int8_affine_decode_kernel(const int8_t* __restrict__ q, const float* __restrict__ scale,
                          const float* __restrict__ mn, float* __restrict__ out,
                          long long total, int D) {
  const long long step = (long long)gridDim.x * kCodecThreads;
  for (long long i = (long long)blockIdx.x * kCodecThreads + threadIdx.x; i < total; i += step) {
    const long long r = i / D;
    const float sc = scale[r], m = mn[r];
    const float safe = sc > 0.f ? sc : 1.f;
    const float deq = __fmul_rn(__fsub_rn((float)q[i], zero_point(m, safe)), safe);
    out[i] = sc > 0.f ? deq : m;
  }
}

}  // namespace edgellm

// x (N, D) float32 -> q (N, D) int8, scale (N, 1), mn (N, 1) float32.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int edgellm_int8_affine_encode(const float* x, int8_t* q, float* scale, float* mn,
                                          long long n, int d, void* stream) {
  using namespace edgellm;
  const size_t smem = sizeof(float) * (size_t)d;
  cudaError_t err = allow_row_smem(int8_affine_encode_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  int8_affine_encode_kernel<<<(unsigned)n, kCodecThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(x, q, scale, mn, d);
  return (int)cudaGetLastError();
}

// q (N, D) int8 + scale (N, 1) + mn (N, 1) -> out (N, D) float32.
extern "C" int edgellm_int8_affine_decode(const int8_t* q, const float* scale, const float* mn,
                                          float* out, long long n, int d, void* stream) {
  using namespace edgellm;
  const long long total = n * (long long)d;
  int8_affine_decode_kernel<<<elementwise_blocks(total), kCodecThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(q, scale, mn, out, total, d);
  return (int)cudaGetLastError();
}

extern "C" const char* edgellm_int8_affine_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
