// K-stats, second pass: per-head column means and last query row of the
// causal attention probabilities, from the row log-sum-exp that K-attn's
// forward (causal_attention.cu, non-null lse) wrote in the first pass.
//
// Replaces the stats half of the TPU kernels _attn_packed_stats and
// _attn_blocked_stats (edgellm_tpu/models/flash_attention.py). On the TPU the
// grid runs in order, so the column sums ride in one VMEM block across the
// query blocks; Hopper blocks run in no order and share nothing, so the sums
// go down the columns inside one block instead: one block per (key tile,
// head, batch row) loops over the query tiles at or below the diagonal,
// recomputes s = q k^T / sqrt(hd), takes p = exp(s - lse_row) and keeps the
// column sums in registers. No atomics: the result is deterministic. The
// block whose key tile it is writes last_row = p[S - 1, keys] of its keys.
// Masked entries contribute exactly 0, as in the reference.
//
// Bound on this card: the same QK^T work as the forward over the lower
// triangle, reading q and K once more; the outputs are 2 x (B, H, S) fp32.
// Like the forward it multiplies with fp32 FMA from shared memory and is
// bound by that, not by device memory.
#include "attention_common.cuh"

namespace edgellm {

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
attn_col_kernel(const T* __restrict__ q, const T* __restrict__ k, const float* __restrict__ lse,
                float* __restrict__ col, float* __restrict__ last, int S, int H, int KV,
                long long q_sb, long long q_ss, long long k_sb, long long k_ss, long long k_sh,
                float scale, float inv_s) {
  extern __shared__ float smem[];
  float* Qs = smem;                    // kTile x (HD + 1)
  float* Kt = Qs + kTile * (HD + 1);   // HD x (kTile + 1)
  float* Ls = Kt + HD * (kTile + 1);   // kTile row log-sum-exps
  float* Red = Ls + kTile;             // 16 x kTile partial column sums

  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / KV);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int key0 = kt * kTile;
  const int nq = (S + kTile - 1) / kTile;
  const long long bh = (long long)b * H + h;

  const T* qh = q + b * q_sb + (long long)h * HD;
  const T* kh = k + b * k_sb + g * k_sh;
  load_rows_t<T, HD>(Kt, kTile + 1, kh, k_ss, key0, S);

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int qt = kt; qt < nq; ++qt) {
    const int row0 = qt * kTile;
    __syncthreads();  // the previous query tile is done with Qs and Ls
    load_rows<T, HD>(Qs, HD + 1, qh, q_ss, row0, S);
    for (int e = threadIdx.x; e < kTile; e += kThreads)
      Ls[e] = row0 + e < S ? lse[bh * S + row0 + e] : 0.f;
    __syncthreads();

    float s[4][4];
    score_tile<HD>(s, Qs, Kt, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + ty + 16 * i;
      const float lrow = Ls[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = key0 + tx + 16 * j;
        const bool visible = row < S && key <= row;  // key <= row < S implies key < S
        const float p = visible ? expf(s[i][j] * scale - lrow) : 0.f;
        acc[j] += p;
        if (row == S - 1 && key < S) last[bh * S + key] = p;
      }
    }
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) Red[ty * kTile + tx + 16 * j] = acc[j];
  __syncthreads();
  for (int c = threadIdx.x; c < kTile; c += kThreads) {
    const int key = key0 + c;
    if (key >= S) continue;
    float sum = 0.f;
    for (int r = 0; r < 16; ++r) sum += Red[r * kTile + c];
    col[bh * S + key] = sum * inv_s;
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const float* lse, float* col, float* last, int B,
           int S, int H, int KV, long long q_sb, long long q_ss, long long k_sb, long long k_ss,
           long long k_sh, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (kTile * (HD + 1) + HD * (kTile + 1) + kTile + 16 * kTile);
  cudaError_t err = cudaFuncSetAttribute(attn_col_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kTile - 1) / kTile, H, B);
  attn_col_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), lse, col, last, S, H, KV, q_sb, q_ss,
      k_sb, k_ss, k_sh, 1.0f / sqrtf((float)HD), 1.0f / (float)S);
  return (int)cudaGetLastError();
}

}  // namespace edgellm

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch
// (0 on success); -1 for a dtype or head dim the kernel was not built for.
extern "C" int edgellm_attn_col(const void* q, const void* k, const float* lse, float* col,
                                float* last, int B, int S, int H, int KV, int hd, int dtype,
                                long long q_sb, long long q_ss, long long k_sb, long long k_ss,
                                long long k_sh, void* stream) {
  using namespace edgellm;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define EDGELLM_COL(T, HD) \
  return launch<T, HD>(q, k, lse, col, last, B, S, H, KV, q_sb, q_ss, k_sb, k_ss, k_sh, st)
  if (dtype == 0 && hd == 64) EDGELLM_COL(float, 64);
  if (dtype == 0 && hd == 128) EDGELLM_COL(float, 128);
  if (dtype == 1 && hd == 64) EDGELLM_COL(__nv_bfloat16, 64);
  if (dtype == 1 && hd == 128) EDGELLM_COL(__nv_bfloat16, 128);
#undef EDGELLM_COL
  return -1;
}

extern "C" const char* edgellm_attn_col_error(int code) {
  return code < 0 ? "unsupported dtype or head dim" : cudaGetErrorString((cudaError_t)code);
}
