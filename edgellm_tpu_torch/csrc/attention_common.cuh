// Shared pieces of the attention kernels: the tensor-core bodies
// (causal_attention.cu, attention_stats.cu, on hopper_common.cuh) reduce
// accumulator rows over a quad; the paged decode kernels (paged_decode.cu)
// convert fp32 / bf16 through to_float / from_float.
//
// Layout contract (checked by the Python wrappers in
// edgellm_tpu_torch/models/flash_attention.py): q is the packed (B, S, H*hd)
// projection output, head h at columns [h*hd, (h+1)*hd); K and V keep the
// model's (B, S, KV, hd) layout and are read through their batch, sequence
// and head strides with the head dim contiguous, so no transpose copy exists.
// Query head h reads KV group h / (H / KV).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace edgellm {

// dtype conversion (the paged decode kernels, paged_decode.cu, read fp32 or
// bf16 q and pages through these)
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
// round to nearest even, as torch's float -> bfloat16 cast
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Reductions over the 4 lanes (a quad) that share a row of a wgmma
// accumulator.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

}  // namespace edgellm
