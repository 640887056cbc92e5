// Shared pieces of the two causal-attention kernels (causal_attention.cu,
// attention_stats.cu): dtype conversion, tile loads into shared memory, and
// the 64 x 64 score tile.
//
// Layout contract (checked by the Python wrappers in
// edgellm_tpu_torch/models/flash_attention.py): q is the packed (B, S, H*hd)
// projection output, head h at columns [h*hd, (h+1)*hd); K and V keep the
// model's (B, S, KV, hd) layout and are read through their batch, sequence
// and head strides with the head dim contiguous, so no transpose copy exists.
// Query head h reads KV group h / (H / KV).
//
// Thread layout: 256 threads as a 16 x 16 grid (ty, tx). A thread owns score
// rows ty + 16*i and key columns tx + 16*j (i, j < 4) of a tile, so the 16
// threads that share a row sit in one half-warp and row reductions are four
// xor-shuffles.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace edgellm {

constexpr int kTile = 64;     // query rows per tile == keys per tile
constexpr int kThreads = 256; // 16 x 16 thread grid

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
// round to nearest even, as torch's float -> bfloat16 cast
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Rows [row0, row0 + kTile) of one head into dst[r * pitch + d] as fp32;
// rows at or past S are zero.
template <typename T, int HD>
__device__ __forceinline__ void load_rows(float* dst, int pitch, const T* src,
                                          long long row_stride, int row0, int S) {
  for (int e = threadIdx.x; e < kTile * HD; e += kThreads) {
    const int r = e / HD, d = e % HD, row = row0 + r;
    dst[r * pitch + d] = row < S ? to_float(src[(long long)row * row_stride + d]) : 0.f;
  }
}

// The same rows transposed: dst[d * pitch + r]. Neighbouring threads read
// neighbouring d (coalesced) and, with pitch kTile + 1, write distinct banks.
template <typename T, int HD>
__device__ __forceinline__ void load_rows_t(float* dst, int pitch, const T* src,
                                            long long row_stride, int row0, int S) {
  for (int e = threadIdx.x; e < kTile * HD; e += kThreads) {
    const int r = e / HD, d = e % HD, row = row0 + r;
    dst[d * pitch + r] = row < S ? to_float(src[(long long)row * row_stride + d]) : 0.f;
  }
}

// acc[i][j] = sum_d Qs[ty + 16i][d] * Kt[d][tx + 16j], fp32 FMA. Qs has
// pitch HD + 1 and Kt pitch kTile + 1, so the two rows a warp reads from Qs
// and the 16 keys it reads from Kt fall in distinct banks.
template <int HD>
__device__ __forceinline__ void score_tile(float acc[4][4], const float* Qs,
                                           const float* Kt, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < HD; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * (HD + 1) + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = Kt[d * (kTile + 1) + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// Reductions over the 16 lanes that share a score row (one half-warp).
__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace edgellm
