// K13 / K14: ragged paged decode attention on Hopper.
//
// Replaces the TPU kernels _paged_attn (_paged_decode_kernel, K13) and
// _paged_attn_quant (_paged_decode_quant_kernel, K14) of
// edgellm_tpu/models/flash_attention.py. Each slot of the continuous batcher
// holds one query row (q_len = 1) and attends over its own list of pages of
// the shared pool, in logical order, up to its length. The TPU kernel walks
// one page per sequential grid step with the page table scalar-prefetched
// and its online-softmax state in VMEM scratch; here one block per (KV head,
// slot) loads its slot's row of the page table itself and walks the pages in
// a loop, so the online-softmax state (running max, sum and the fp32
// accumulator of every query head of the group) lives in shared memory for
// the whole walk. Pages at or past the slot's length are never read;
// positions at or past it are masked to -inf, as the TPU body does.
//
// Each page's K and V rows for the block's KV head are read once (32 rows at
// a time into shared memory, as fp32) and serve all rep = H / KV query heads
// of the group: 7 for Qwen2-0.5B, 6 for Qwen2-1.5B. The K14 variant reads
// int8 codes, or packed int4 codes (lane i in the low nibble, lane i + hd/2
// in the high one), with one fp32 scale per (row, KV head), and dequantizes
// while loading as code * (scale * (1 / qmax)), the TPU kernel's order.
// Both dots run in fp32 (bf16 inputs are widened; no TF32).
//
// Bound on this card: a decode step reads every live K/V row of every slot
// once and does 4 * rep * hd FLOPs per row, about 1 to 2 FLOPs per byte, so
// the roofline bound is the bytes of the live rows, q and the output. This
// first version multiplies with fp32 FMA out of shared memory and launches
// only KV * B blocks (64 at B = 32 for Qwen2), too few to fill 132 SMs, so it
// is bound by per-block latency long before memory bandwidth.
#include "attention_common.cuh"

#include <stdint.h>

namespace edgellm {

constexpr int kPdThreads = 128;  // 4 warps
constexpr int kPdRows = 32;      // page rows per chunk: one per lane in the softmax

// One K or V element of row `row` (flat page * ps + offset), KV head g, lane
// d, as fp32. MODE 0: pages of type P; MODE 8: int8 codes; MODE 4: packed
// int4 codes, two lanes a byte.
template <typename P, int HD, int MODE>
__device__ __forceinline__ float load_elem(const void* pages, const float* scales,
                                           long long row, int KV, int g, int d) {
  if constexpr (MODE == 0) {
    return to_float(static_cast<const P*>(pages)[(row * KV + g) * HD + d]);
  } else if constexpr (MODE == 8) {
    const float sc = scales[row * KV + g] * (1.0f / 127.0f);
    return (float)static_cast<const int8_t*>(pages)[(row * KV + g) * HD + d] * sc;
  } else {
    constexpr int HALF = HD / 2;
    const float sc = scales[row * KV + g] * (1.0f / 7.0f);
    const int lane = d < HALF ? d : d - HALF;
    const int c = static_cast<const uint8_t*>(pages)[(row * KV + g) * HALF + lane];
    const int code = (d < HALF ? (c & 0xF) : ((c >> 4) & 0xF)) - 8;
    return (float)code * sc;
  }
}

template <typename T, typename P, int HD, int MODE>
__global__ void __launch_bounds__(kPdThreads)
paged_decode_kernel(const T* __restrict__ q, const void* __restrict__ kpages,
                    const void* __restrict__ vpages, const float* __restrict__ kscale,
                    const float* __restrict__ vscale, const int* __restrict__ page_table,
                    const int* __restrict__ lengths, T* __restrict__ out, int H, int KV, int ps,
                    int pps, int num_pages, float scale) {
  extern __shared__ float smem[];
  const int rep = H / KV;
  float* Qs = smem;                          // rep x HD
  float* Ks = Qs + rep * HD;                 // kPdRows x (HD + 1)
  float* Vs = Ks + kPdRows * (HD + 1);       // kPdRows x HD
  float* Ps = Vs + kPdRows * HD;             // rep x kPdRows: scores, then probabilities
  float* Acc = Ps + rep * kPdRows;           // rep x HD
  float* Mx = Acc + rep * HD;                // rep: running max
  float* Ls = Mx + rep;                      // rep: running sum
  float* Corr = Ls + rep;                    // rep: this chunk's rescale

  const int g = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int len = lengths[b];
  const T* qb = q + ((long long)b * H + (long long)g * rep) * HD;

  for (int e = tid; e < rep * HD; e += kPdThreads) {
    Qs[e] = to_float(qb[e]);
    Acc[e] = 0.f;
  }
  for (int r = tid; r < rep; r += kPdThreads) {
    Mx[r] = -INFINITY;
    Ls[r] = 0.f;
  }

  for (int j = 0; j < pps && j * ps < len; ++j) {
    int page = page_table[(long long)b * pps + j];
    page = page < 0 ? 0 : (page >= num_pages ? num_pages - 1 : page);
    for (int t0 = 0; t0 < ps && j * ps + t0 < len; t0 += kPdRows) {
      const int nrows = min(kPdRows, ps - t0);
      const int nvalid = min(nrows, len - (j * ps + t0));  // >= 1: the chunk's first row is live
      const long long row0 = (long long)page * ps + t0;
      __syncthreads();  // the previous chunk is done with Ks, Vs and Ps
      for (int e = tid; e < nvalid * HD; e += kPdThreads) {
        const int t = e / HD, d = e % HD;
        Ks[t * (HD + 1) + d] = load_elem<P, HD, MODE>(kpages, kscale, row0 + t, KV, g, d);
        Vs[t * HD + d] = load_elem<P, HD, MODE>(vpages, vscale, row0 + t, KV, g, d);
      }
      __syncthreads();
      // scores: lane-consecutive rows, so the Ks reads (pitch HD + 1) fall in
      // distinct banks while Qs is a broadcast
      for (int idx = tid; idx < rep * kPdRows; idx += kPdThreads) {
        const int r = idx / kPdRows, t = idx % kPdRows;
        float s = -INFINITY;
        if (t < nvalid) {
          const float* qr = Qs + r * HD;
          const float* kr = Ks + t * (HD + 1);
          float acc = 0.f;
#pragma unroll 16
          for (int d = 0; d < HD; ++d) acc = fmaf(qr[d], kr[d], acc);
          s = acc * scale;
        }
        Ps[idx] = s;
      }
      __syncthreads();
      // online softmax: one warp per query head, one lane per chunk row
      for (int r = warp; r < rep; r += kPdThreads / 32) {
        const float s = Ps[r * kPdRows + lane];
        float mx = s;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_old = Mx[r];
        const float m_new = fmaxf(m_old, mx);  // finite: row 0 of the chunk is live
        const float p = s == -INFINITY ? 0.f : expf(s - m_new);
        float sum = p;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
        Ps[r * kPdRows + lane] = p;
        if (lane == 0) {
          const float corr = expf(m_old - m_new);  // exp(-inf) = 0 on the first chunk
          Corr[r] = corr;
          Ls[r] = Ls[r] * corr + sum;
          Mx[r] = m_new;
        }
      }
      __syncthreads();
      for (int e = tid; e < rep * HD; e += kPdThreads) {
        const int r = e / HD, d = e % HD;
        const float* pr = Ps + r * kPdRows;
        float a = Acc[e] * Corr[r];
        for (int t = 0; t < nvalid; ++t) a = fmaf(pr[t], Vs[t * HD + d], a);
        Acc[e] = a;
      }
    }
  }
  __syncthreads();
  T* ob = out + ((long long)b * H + (long long)g * rep) * HD;
  for (int e = tid; e < rep * HD; e += kPdThreads) ob[e] = from_float<T>(Acc[e] / Ls[e / HD]);
}

template <typename T, typename P, int HD, int MODE>
int launch_paged(const void* q, const void* kp, const void* vp, const float* ks,
                 const float* vs, const int* pt, const int* lens, void* out, int B, int H,
                 int KV, int ps, int pps, int num_pages, float scale, cudaStream_t stream) {
  const int rep = H / KV;
  const size_t smem = sizeof(float) * (2 * rep * HD + kPdRows * (HD + 1) + kPdRows * HD +
                                       rep * kPdRows + 3 * rep);
  cudaError_t err = cudaFuncSetAttribute(paged_decode_kernel<T, P, HD, MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(KV, B);
  paged_decode_kernel<T, P, HD, MODE><<<grid, kPdThreads, smem, stream>>>(
      static_cast<const T*>(q), kp, vp, ks, vs, pt, lens, static_cast<T*>(out), H, KV, ps, pps,
      num_pages, scale);
  return (int)cudaGetLastError();
}

}  // namespace edgellm

// q / out: (B, H*hd) of dtype (0 = float32, 1 = bfloat16). mode 0 (K13):
// k/v pages (num_pages, ps, KV, hd) of q's dtype, scales unused; mode 8 or 4
// (K14): int8 codes (num_pages, ps, KV, hd) or packed int4 codes
// (num_pages, ps, KV, hd/2), k/v scales (num_pages, ps, KV) fp32. page_table
// (B, pps) and lengths (B,) int32. Returns the cudaError_t of the launch (0
// on success); -1 for a dtype, mode or head dim the kernel was not built for.
// ``scale`` is the float32 1 / sqrt(hd) the scores are multiplied by.
extern "C" int edgellm_paged_decode(const void* q, const void* kp, const void* vp,
                                    const float* ks, const float* vs, const int* pt,
                                    const int* lens, void* out, int B, int H, int KV, int hd,
                                    int ps, int pps, int num_pages, float scale, int dtype,
                                    int mode, void* stream) {
  using namespace edgellm;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define EDGELLM_PAGED(T, P, HD, MODE)                                                          \
  return launch_paged<T, P, HD, MODE>(q, kp, vp, ks, vs, pt, lens, out, B, H, KV, ps, pps,     \
                                      num_pages, scale, st)
#define EDGELLM_PAGED_HD(T, P, MODE)                                                           \
  if (hd == 64) EDGELLM_PAGED(T, P, 64, MODE);                                                 \
  if (hd == 128) EDGELLM_PAGED(T, P, 128, MODE)
  if (dtype == 0 && mode == 0) { EDGELLM_PAGED_HD(float, float, 0); }
  if (dtype == 1 && mode == 0) { EDGELLM_PAGED_HD(__nv_bfloat16, __nv_bfloat16, 0); }
  if (dtype == 0 && mode == 8) { EDGELLM_PAGED_HD(float, int8_t, 8); }
  if (dtype == 1 && mode == 8) { EDGELLM_PAGED_HD(__nv_bfloat16, int8_t, 8); }
  if (dtype == 0 && mode == 4) { EDGELLM_PAGED_HD(float, uint8_t, 4); }
  if (dtype == 1 && mode == 4) { EDGELLM_PAGED_HD(__nv_bfloat16, uint8_t, 4); }
#undef EDGELLM_PAGED_HD
#undef EDGELLM_PAGED
  return -1;
}

extern "C" const char* edgellm_paged_decode_error(int code) {
  return code < 0 ? "unsupported dtype, mode or head dim" : cudaGetErrorString((cudaError_t)code);
}
