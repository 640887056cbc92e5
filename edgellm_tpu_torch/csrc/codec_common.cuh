// Shared pieces of the codec kernels (int4_codec.cu, int8_affine_codec.cu,
// channel_codec.cu, remote_hop.cu): the block size, warp- and block-wide
// reductions, the dynamic shared-memory opt-in for wide rows, and the affine
// int8 zero point that K3, K4 and K8 share.
//
// Every arithmetic step the codecs share with the reference goes through the
// _rn intrinsics (__fdiv_rn, __fmul_rn, __fsub_rn, __fadd_rn): they are
// IEEE-correct and never contracted into an FMA, so the payloads are bit for
// bit those of the reference's float32 formulas. rintf rounds half to even,
// like jnp.round.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace edgellm {

constexpr int kCodecThreads = 128;
constexpr float kInv255 = (float)(1.0 / 255.0);

// zp = rint(-128 - min / safe) of the per-row affine int8 codec
__device__ __forceinline__ float zero_point(float mn, float safe) {
  return rintf(__fsub_rn(-128.f, __fdiv_rn(mn, safe)));
}

struct MaxOp {
  __device__ __forceinline__ float operator()(float a, float b) const { return fmaxf(a, b); }
};
struct MinOp {
  __device__ __forceinline__ float operator()(float a, float b) const { return fminf(a, b); }
};

// Reduce one value per lane over the warp; every lane gets the result.
template <typename Op>
__device__ __forceinline__ float warp_reduce(float v, Op op) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Reduce one value per thread over the block; every thread gets the result.
// `red` holds kCodecThreads / 32 floats of shared memory. The leading
// __syncthreads() also orders the callers' shared-memory writes before any
// thread reads them back.
template <typename Op>
__device__ __forceinline__ float block_reduce(float v, float* red, float identity, Op op) {
  v = warp_reduce(v, op);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // red may still be read by a previous reduction
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < kCodecThreads / 32 ? red[lane] : identity;
  return warp_reduce(v, op);
}

// One block per row keeps the row in dynamic shared memory between the
// reduction and the quantize pass; rows wider than 48 KB need the opt-in.
template <typename Kernel>
cudaError_t allow_row_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Grid of a grid-stride elementwise pass: enough blocks to fill the card,
// no more than the work needs.
inline unsigned elementwise_blocks(long long items) {
  const long long want = (items + kCodecThreads - 1) / kCodecThreads;
  return (unsigned)(want < 132 * 32 ? (want > 0 ? want : 1) : 132 * 32);
}

}  // namespace edgellm
