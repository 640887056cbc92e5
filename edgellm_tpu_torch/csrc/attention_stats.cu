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
// recomputes the scores, takes p = exp(s / sqrt(hd) - lse_row) and keeps the
// column sums in registers. No atomics: the result is deterministic. The
// block whose key tile it is writes last_row = p[S - 1, keys] of its keys.
// Masked entries contribute exactly 0, as in the reference.
//
// Bound on this card: the same QK^T work as the forward over the lower
// triangle, reading q and K once more; the outputs are 2 x (B, H, S) fp32.
//
// bf16 (attn_col_wgmma): a block owns 128 keys, two consumer warpgroups of
// 64 keys and one producer warp. The producer copies the block's K rows once,
// then q tiles of 64 rows with their 64 LSE values into a 4-stage ring
// (16-byte cp.async into the swizzled layout, 4-byte cp.async for the LSE
// rows, which need not be 16-byte aligned), signalled on mbarriers as in
// K-attn. A consumer computes S^T = K q^T by wgmma, so the keys are the
// accumulator's rows and a column sum is a row sum of the accumulator: a
// per-thread partial sum in a fixed order, then a quad shuffle at the end.
// p = exp2(s * scale * log2 e - lse * log2 e); only the diagonal tile and the
// ragged edge at S are masked.
//
// fp32 (attn_col_simt): fp32 FMA out of shared memory on the CUDA cores.
#include "attention_common.cuh"
#include "hopper_common.cuh"

namespace edgellm {

// ---------------------------------------------------------------------------
// fp32: SIMT body
// ---------------------------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(kThreads)
attn_col_simt(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ lse, float* __restrict__ col, float* __restrict__ last,
              int S, int H, int KV, long long q_sb, long long q_ss, long long k_sb,
              long long k_ss, long long k_sh, float scale, float inv_s) {
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

  const float* qh = q + b * q_sb + (long long)h * HD;
  const float* kh = k + b * k_sb + g * k_sh;
  load_rows_t<HD>(Kt, kTile + 1, kh, k_ss, key0, S);

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int qt = kt; qt < nq; ++qt) {
    const int row0 = qt * kTile;
    __syncthreads();  // the previous query tile is done with Qs and Ls
    load_rows<HD>(Qs, HD + 1, qh, q_ss, row0, S);
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

template <int HD>
int launch_simt(const void* q, const void* k, const float* lse, float* col, float* last, int B,
                int S, int H, int KV, long long q_sb, long long q_ss, long long k_sb,
                long long k_ss, long long k_sh, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (kTile * (HD + 1) + HD * (kTile + 1) + kTile + 16 * kTile);
  cudaError_t err = cudaFuncSetAttribute(attn_col_simt<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kTile - 1) / kTile, H, B);
  attn_col_simt<HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), lse, col, last, S, H, KV, q_sb,
      q_ss, k_sb, k_ss, k_sh, 1.0f / sqrtf((float)HD), 1.0f / (float)S);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma), cp.async ring, warp-specialized
// ---------------------------------------------------------------------------

constexpr int kColKeys = 128;  // keys per block: two consumer warpgroups of 64
constexpr int kColRows = 64;   // query rows per ring stage
constexpr int kStages = 4;
constexpr int kColThreads = 2 * 128 + 32;

template <int HD>
struct ColSmem {
  static constexpr int kKBytes = kColKeys * HD * 2;
  static constexpr int kQBytes = kColRows * HD * 2;  // one q stage
  static constexpr int kLBytes = kColRows * 4;       // one LSE stage
  static constexpr int kBytes = kKBytes + kStages * (kQBytes + kLBytes) + 1024;  // + alignment
};

template <int HD>
__global__ void __launch_bounds__(kColThreads, 1)
attn_col_wgmma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const float* __restrict__ lse, float* __restrict__ col, float* __restrict__ last,
               int S, int H, int KV, long long q_sb, long long q_ss, long long k_sb,
               long long k_ss, long long k_sh, float scale_log2, float inv_s) {
  using L = ColSmem<HD>;
  constexpr int CH = HD / 8;
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * kStages];  // K, full[], empty[]
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sK = (raw + 1023u) & ~1023u;
  const uint32_t sQ = sK + L::kKBytes;
  const uint32_t sL = sQ + kStages * L::kQBytes;
  const float* gL = reinterpret_cast<const float*>(smem_raw + (sL - raw));
  const uint32_t bar_k = smem_u32(&bars[0]);
  const uint32_t bar_full = smem_u32(&bars[1]), bar_empty = smem_u32(&bars[1 + kStages]);

  const int h = blockIdx.x, b = blockIdx.y;
  const int key0 = blockIdx.z * kColKeys;  // the heaviest (first) key block comes first
  const int g = h / (H / KV);
  const long long bh = (long long)b * H + h;
  const int qt0 = key0 / kColRows;
  const int n_steps = (S + kColRows - 1) / kColRows - qt0;

  if (threadIdx.x == 0) {
    mbar_init(bar_k, 32);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 32);
      mbar_init(bar_empty + 8 * s, 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 8) {
    const __nv_bfloat16* kh = k + b * k_sb + g * k_sh;
    for (int e = lane; e < kColKeys * CH; e += 32) {
      const int r = e / CH, c = e % CH, key = key0 + r;
      cp_async16(sK + sw128_offset(r, c, kColKeys), kh + (long long)min(key, S - 1) * k_ss + c * 8,
                 key < S);
    }
    cp_async_arrive(bar_k);
    const __nv_bfloat16* qh = q + b * q_sb + (long long)h * HD;
    const float* lh = lse + bh * S;
    for (int i = 0; i < n_steps; ++i) {
      const int s = i % kStages, row0 = (qt0 + i) * kColRows;
      mbar_wait(bar_empty + 8 * s, ((i / kStages) & 1) ^ 1);
      const uint32_t dq = sQ + s * L::kQBytes;
      for (int e = lane; e < kColRows * CH; e += 32) {
        const int r = e / CH, c = e % CH, row = row0 + r;
        cp_async16(dq + sw128_offset(r, c, kColRows), qh + (long long)min(row, S - 1) * q_ss + c * 8,
                   row < S);
      }
      for (int r = lane; r < kColRows; r += 32)
        cp_async4(sL + s * L::kLBytes + 4 * r, lh + min(row0 + r, S - 1), row0 + r < S);
      cp_async_arrive(bar_full + 8 * s);
    }
    cp_async_wait_all();  // no copy outlives its thread
    return;
  }

  // consumers: warpgroup wg owns keys key0 + 64wg .. + 63; this thread keys
  // kr0 and kr0 + 8 of them, and accumulator columns (queries) 8j + 2 t4 + e
  const int wg = warp / 4, w = warp % 4, t4 = lane % 4;
  const int wkey0 = key0 + wg * 64;
  const int kr0 = wkey0 + w * 16 + lane / 4;
  const bool active = wkey0 < S;
  const uint32_t ka = sK + wg * 64 * 128;
  float acc0 = 0.f, acc1 = 0.f;

  mbar_wait(bar_k, 0);
  for (int i = 0; i < n_steps; ++i) {
    const int s = i % kStages, q0 = (qt0 + i) * kColRows;
    mbar_wait(bar_full + 8 * s, (i / kStages) & 1);
    fence_proxy_async();  // the copies landed through the generic proxy
    __syncwarp();         // wgmma is .aligned: the warp leaves the spin together
    if (active && q0 + kColRows - 1 >= wkey0) {  // some query of the tile sees a key of ours
      float sc[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) sc[j] = 0.f;
      const uint32_t qb = sQ + s * L::kQBytes;
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss_n64(sc, sw128_desc(ka + (kk / 4) * kColKeys * 128 + (kk % 4) * 32, 16, 1024),
                     sw128_desc(qb + (kk / 4) * kColRows * 128 + (kk % 4) * 32, 16, 1024), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      const float* ls = gL + s * kColRows;
      const bool edge = q0 < wkey0 + 63 || q0 + kColRows > S;  // the diagonal or the edge at S
      const bool has_last = q0 + kColRows >= S;               // the tile holds row S - 1
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int cq = 8 * j + 2 * t4 + e, query = q0 + cq;
          const float lb = ls[cq] * kLog2e;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int key = kr0 + 8 * half;
            const bool visible = !edge || (key <= query && query < S);
            const float p = visible ? fast_exp2(fmaf(sc[4 * j + 2 * half + e], scale_log2, -lb)) : 0.f;
            if (half == 0) acc0 += p; else acc1 += p;
            if (has_last && query == S - 1 && key < S) last[bh * S + key] = p;
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * s);
  }
  if (!active) return;
  acc0 = quad_sum(acc0);
  acc1 = quad_sum(acc1);
  if (t4 == 0) {
    if (kr0 < S) col[bh * S + kr0] = acc0 * inv_s;
    if (kr0 + 8 < S) col[bh * S + kr0 + 8] = acc1 * inv_s;
  }
}

template <int HD>
int launch_wgmma(const void* q, const void* k, const float* lse, float* col, float* last, int B,
                 int S, int H, int KV, long long q_sb, long long q_ss, long long k_sb,
                 long long k_ss, long long k_sh, cudaStream_t stream) {
  const int smem = ColSmem<HD>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(attn_col_wgmma<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H, B, (S + kColKeys - 1) / kColKeys);
  attn_col_wgmma<HD><<<grid, kColThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k), lse, col, last,
      S, H, KV, q_sb, q_ss, k_sb, k_ss, k_sh, 1.4426950408889634f / sqrtf((float)HD),
      1.0f / (float)S);
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
#define EDGELLM_COL(FN, HD) \
  return FN<HD>(q, k, lse, col, last, B, S, H, KV, q_sb, q_ss, k_sb, k_ss, k_sh, st)
  if (dtype == 0 && hd == 64) EDGELLM_COL(launch_simt, 64);
  if (dtype == 0 && hd == 128) EDGELLM_COL(launch_simt, 128);
  if (dtype == 1 && hd == 64) EDGELLM_COL(launch_wgmma, 64);
  if (dtype == 1 && hd == 128) EDGELLM_COL(launch_wgmma, 128);
#undef EDGELLM_COL
  return -1;
}

extern "C" const char* edgellm_attn_col_error(int code) {
  return code < 0 ? "unsupported dtype or head dim" : cudaGetErrorString((cudaError_t)code);
}
