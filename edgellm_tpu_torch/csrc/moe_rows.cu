// The row traffic of a sparse-expert layer around its two grouped products
// (models/moe.py): the gather of the pairs' rows into expert order, and the
// weighted combine of the held experts' results back to the tokens.
//
// Replaces no TPU kernel: the JAX package has no sparse experts. It replaces
// the layer's plain PyTorch passes over every (token, pick) pair's row (an
// index_select of all T k rows, a scatter building the inverse order, a
// (T, k, D) gather of the results, a multiply, a where and a sum), half of
// whose rows, on a card that holds half the experts, belong to experts held
// elsewhere and are never computed here.
//
// Bound on this card: bytes. Both kernels only move rows (a few FLOPs a
// value): the gather reads and writes each held pair's row once, the
// combine reads each held pair's result once and writes each token's row
// once. What the design does about it: a pair routed to another card costs
// its index and nothing else (the gather copies no row of it, the combine
// never loads one, whatever that row holds); a row moves as 16-byte loads
// and stores, one warp a row, so a warp's accesses are contiguous 512-byte
// runs; the combine keeps a token's sum in registers over its picks, in pick
// order, with each product rounded before its add (no FMA: the unfused
// multiply-then-sum's arithmetic), no atomics, so two launches are bit for
// bit equal. The row counts a card holds are read on the device
// (offsets[experts]), never by the host.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace edgellm {

namespace moe_rows {
constexpr int kWarps = 8;     // rows a block: one warp a row
constexpr int kMaxPicks = 32;  // experts a token picks (one lane each)
}  // namespace moe_rows

// One warp a sorted position i of the T k pairs: below offsets[experts] (a
// pair routed to a held expert) it copies x's row order[i] / k to row i of
// rows and records pos[order[i]] = i; past it only pos[order[i]] = -1.
__global__ void __launch_bounds__(moe_rows::kWarps * 32)
moe_gather_rows_kernel(const float4* __restrict__ x, const long long* __restrict__ order,
                       const int* __restrict__ offsets, int experts, int pairs, int k, int d4,
                       float4* __restrict__ rows, int* __restrict__ pos) {
  const int i = blockIdx.x * moe_rows::kWarps + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (i >= pairs) return;
  const long long p = order[i];
  const bool held = i < offsets[experts];
  if (lane == 0) pos[p] = held ? i : -1;
  if (!held) return;
  const float4* src = x + (p / k) * d4;
  float4* dst = rows + static_cast<long long>(i) * d4;
#pragma unroll 4
  for (int c = lane; c < d4; c += 32) dst[c] = src[c];
}

__device__ __forceinline__ void store4(float* out, float4 v) {
  *reinterpret_cast<float4*>(out) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* out, float4 v) {
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(out);
  o[0] = __floats2bfloat162_rn(v.x, v.y);
  o[1] = __floats2bfloat162_rn(v.z, v.w);
}

// acc + w * v, the product rounded before the add
__device__ __forceinline__ float4 add_scaled(float4 acc, float w, float4 v) {
  return make_float4(__fadd_rn(acc.x, __fmul_rn(w, v.x)), __fadd_rn(acc.y, __fmul_rn(w, v.y)),
                     __fadd_rn(acc.z, __fmul_rn(w, v.z)), __fadd_rn(acc.w, __fmul_rn(w, v.w)));
}

// One warp a token t: out[t] = sum over its picks j < k, in order, with
// pos[t k + j] >= 0, of w[t, j] * y[pos[t k + j]], in fp32, stored as OutT.
// Lane j holds pick j's row index and weight; rows held elsewhere are never
// loaded.
template <typename OutT>
__global__ void __launch_bounds__(moe_rows::kWarps * 32)
moe_combine_kernel(const float4* __restrict__ y, const int* __restrict__ pos,
                   const float* __restrict__ w, int tokens, int k, int d4,
                   OutT* __restrict__ out) {
  const int t = blockIdx.x * moe_rows::kWarps + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (t >= tokens) return;
  const int my_pos = lane < k ? pos[static_cast<long long>(t) * k + lane] : -1;
  const float my_w = lane < k ? w[static_cast<long long>(t) * k + lane] : 0.f;
  OutT* dst = out + static_cast<long long>(t) * d4 * 4;
  for (int c0 = 0; c0 < d4; c0 += 32) {  // the whole warp takes every shuffle
    const int c = c0 + lane;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = 0; j < k; ++j) {
      const int p = __shfl_sync(0xffffffffu, my_pos, j);
      const float wj = __shfl_sync(0xffffffffu, my_w, j);
      if (p >= 0 && c < d4) acc = add_scaled(acc, wj, y[static_cast<long long>(p) * d4 + c]);
    }
    if (c < d4) store4(dst + 4 * c, acc);
  }
}

}  // namespace edgellm

// The gather (see moe_gather_rows_kernel). x: (T, D) fp32 rows; order: the
// T k pair indices (t k + j) in expert order, pairs routed to held experts
// first; offsets: experts + 1 device ints, offsets[experts] the held pairs;
// rows: (T k, D) fp32, written at the held pairs' positions only; pos: T k
// ints. D a multiple of 4, x and rows 16-byte aligned. Returns the
// cudaError_t of the launch (0 on success), -1 for arguments it does not
// take.
extern "C" int edgellm_moe_gather_rows(const float* x, const long long* order,
                                       const int* offsets, int experts, int tokens, int k, int d,
                                       float* rows, int* pos, void* stream) {
  using namespace edgellm;
  const long long pairs = static_cast<long long>(tokens) * k;
  if (tokens <= 0 || k <= 0 || d <= 0 || d % 4 || experts <= 0 || pairs > 0x7fffffff ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(rows)) % 16)
    return -1;
  const int blocks = static_cast<int>((pairs + moe_rows::kWarps - 1) / moe_rows::kWarps);
  moe_gather_rows_kernel<<<blocks, moe_rows::kWarps * 32, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(x), order, offsets, experts, static_cast<int>(pairs), k,
      d / 4, reinterpret_cast<float4*>(rows), pos);
  return (int)cudaGetLastError();
}

// The combine (see moe_combine_kernel). y: (M, D) fp32 expert results; pos:
// T k ints, -1 for pairs held elsewhere, else a row of y; w: (T, k) fp32
// weights; out: (T, D) of out_dtype (0 float32, 1 bfloat16). D a
// multiple of 4, y and out 16-byte aligned, k <= 32. The same return codes.
extern "C" int edgellm_moe_combine(const float* y, const int* pos, const float* w, int tokens,
                                   int k, int d, void* out, int out_dtype, void* stream) {
  using namespace edgellm;
  if (tokens <= 0 || k <= 0 || k > moe_rows::kMaxPicks || d <= 0 || d % 4 ||
      (reinterpret_cast<uintptr_t>(y) | reinterpret_cast<uintptr_t>(out)) % 16)
    return -1;
  const int blocks = (tokens + moe_rows::kWarps - 1) / moe_rows::kWarps;
  const dim3 grid(blocks), block(moe_rows::kWarps * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* y4 = reinterpret_cast<const float4*>(y);
  if (out_dtype == 0)
    moe_combine_kernel<<<grid, block, 0, s>>>(y4, pos, w, tokens, k, d / 4,
                                              static_cast<float*>(out));
  else if (out_dtype == 1)
    moe_combine_kernel<<<grid, block, 0, s>>>(y4, pos, w, tokens, k, d / 4,
                                              static_cast<__nv_bfloat16*>(out));
  else
    return -1;
  return (int)cudaGetLastError();
}

extern "C" const char* edgellm_moe_rows_error(int code) {
  return code < 0 ? "arguments the kernel does not take" : cudaGetErrorString((cudaError_t)code);
}
