// K-stats, second pass: per-head column means and last query row of the
// causal attention probabilities, from the row log-sum-exp that K-attn's
// forward (causal_attention.cu, non-null lse) wrote in the first pass.
//
// Replaces the stats half of the TPU kernels _attn_packed_stats and
// _attn_blocked_stats (edgellm_tpu/models/flash_attention.py). On the TPU the
// grid runs in order, so the column sums ride in one VMEM block across the
// query blocks; Hopper blocks run in no order and share nothing, so the sums
// go down the columns inside one block instead: one block per key tile of
// one head of a batch row loops over the query tiles at or below the
// diagonal,
// recomputes the scores, takes p = exp(s / sqrt(hd) - lse_row) and keeps the
// column sums in registers. No atomics: the result is deterministic. The
// block whose key tile it is writes last_row = p[S - 1, keys] of its keys.
// Masked entries contribute exactly 0, as in the reference.
//
// Bound on this card: the same QK^T work as the forward over the lower
// triangle, reading q and K once more; the outputs are 2 x (B, H, S) fp32.
// Both bodies compute S^T = K q^T, the keys as the accumulator's rows, so a
// column sum is a per-thread row sum of the accumulator plus a quad shuffle.
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
// fp32 (attn_col_tf32): the same S^T = K q^T on the tensor cores as 3xTF32
// products (hopper_common.cuh's split_tf32: every operand as hi + lo, three
// TF32 wgmma with fp32 accumulation), in fp32 K-attn's term order (the
// small terms lo.hi and hi.lo over the whole reduction, then hi.hi), so each
// score is the one behind the forward's LSE and the p of a row sum to 1. Its
// bound is the products: 3 TF32 FLOPs a FLOP, 164.9 TFLOP/s on an H100 SXM
// (Qwen2-0.5B B=8 S=512: 1.88 GFLOP, 0.0114 ms; its bytes take 0.0052). A
// block owns 128 keys of one head (two consumer warpgroups of 64, no
// producer warp), splits them into hi / lo once, and walks that head's
// query tiles over them, heaviest key blocks first. q
// moves through registers into two (hi, lo) stages: while step i's
// products run, step i + 1's q is split into the other stage and step i +
// 2's loaded; then step i's p = exp(s * scale - lse) sums into per-thread
// column sums in step order. The exponent is formed by one FMA and taken
// by ex2.approx after a multiply by log2 e, so its error stays relative to
// |exponent| (under 2e-8 absolute), where expf took a third of the pass on
// an H100; a tile that no mask crosses takes an unmasked loop
// (attention_variants.py reads each choice). What bounds the pass on an
// H100 is that epilogue: it does not overlap the products (PERF.md). One
// barrier a step, no atomics: two launches are bit for bit equal.
#include "attention_common.cuh"
#include "hopper_common.cuh"

namespace edgellm {

// ---------------------------------------------------------------------------
// fp32: 3xTF32 products on the tensor cores (wgmma), q split into (hi, lo)
// one step ahead of its products
// ---------------------------------------------------------------------------

// The fp32 block: 128 keys, a consumer warpgroup for each 64 (the wgmma
// accumulator's rows), and kRows query rows a step (the accumulator's
// columns: 64 at hd 64, 32 at hd 128, where two stages of 64 would not fit
// beside the 128 x 128 K tile's hi and lo parts).
template <int HD>
struct ColF32 {
  static constexpr int kKeys = 128;
  static constexpr int kRows = HD == 64 ? 64 : 32;
  static constexpr int kThreads = 256;
  static constexpr int kStages = 2;              // q (hi, lo) stages
  static constexpr int kKTile = kKeys * HD * 4;  // bytes of one K part (hi or lo)
  static constexpr int kQTile = kRows * HD * 4;  // one q part
  static constexpr int kVecs = kRows * HD / 4 / kThreads;  // 16-byte q chunks a thread moves
  // K hi and lo, the q stages' hi and lo, the stages' kRows LSE values
  static constexpr int kBytes =
      2 * kKTile + kStages * (2 * kQTile + kRows * 4) + 1024;  // + alignment
};

// Block (b, h) x key block: keys key0 .. key0 + 127 of batch row b, against
// query head h's tiles from the first one that sees a key of the block to
// the last. Each thread sums its two keys' p in tile order, and the column
// sums are written after the last tile (a quad shuffle, then col), so the
// result is deterministic.
//
// The pipeline, one barrier a step: at step i the warpgroups issue step
// i's products, then split step i + 1's q (in registers since step i - 1)
// into the other stage (read by step i - 1, which every warpgroup waited
// for) and load step i + 2's from memory while the products run, then take
// step i's p. A body with two accumulators a warpgroup, issuing step i +
// 1's products before step i's p, read slower on an H100 (PERF.md).
template <int HD>
__global__ void __launch_bounds__(ColF32<HD>::kThreads, 1)
attn_col_tf32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ lse, float* __restrict__ col, float* __restrict__ last,
              int S, int H, int KV, long long q_sb, long long q_ss, long long k_sb,
              long long k_ss, long long k_sh, float scale, float inv_s) {
  using L = ColF32<HD>;
  constexpr int kRows = L::kRows, kThreads = L::kThreads, NV = L::kVecs;
  constexpr int CH = HD / 4;  // 16-byte chunks a row
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ unsigned char smem_col[];
  // the tiles start 1024-byte aligned (the swizzle's period); sX is a shared
  // address for wgmma, gX the generic pointer the split stores write through
  const uint32_t raw0 = smem_u32(smem_col);
  const uint32_t sKh = (raw0 + 1023u) & ~1023u, sKl = sKh + L::kKTile;
  const uint32_t sQ = sKl + L::kKTile;  // stage t: hi at sQ + 2t kQTile, lo after it
  unsigned char* gK = smem_col + (sKh - raw0);
  unsigned char* gQ = gK + 2 * L::kKTile;
  float* gL = reinterpret_cast<float*>(gQ + L::kStages * 2 * L::kQTile);

  const int b = blockIdx.x / H, h = blockIdx.x % H, g = h / (H / KV);
  const long long bh = (long long)b * H + h;
  const int key0 = blockIdx.y * L::kKeys;  // key block 0, the heaviest, comes first
  const int qt0 = key0 / kRows, n_steps = (S + kRows - 1) / kRows - qt0;
  const int tid = threadIdx.x;
  const float* qhead = q + b * q_sb + (long long)h * HD;
  const float* lhead = lse + bh * S;

  // raw q rows of step i (query tile qt0 + i) into registers, rows past S
  // zero; and the tile's LSE value of row tid % kRows. No branch on the
  // thread: this code runs while the warpgroup's wgmma are in flight, and
  // ptxas serializes wgmma around a divergent path (C7518).
  float4 xq[NV];
  float xl;
  auto load_q = [&](int i) {
    const int row0 = (qt0 + i) * kRows;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int e = tid + v * kThreads, r = e / CH, c = e % CH, row = row0 + r;
      const float4 x = __ldg(reinterpret_cast<const float4*>(qhead + min(row, S - 1) * q_ss) + c);
      xq[v] = row < S ? x : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    xl = __ldg(lhead + min(row0 + tid % kRows, S - 1));
  };
  // ... then split into stage t's hi and lo tiles (the LSE value written by
  // every thread that holds it: the same value)
  auto split_q = [&](int t) {
    unsigned char* hi = gQ + 2 * t * L::kQTile;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int e = tid + v * kThreads;
      store_split4(hi, hi + L::kQTile, sw128_offset(e / CH, e % CH, kRows), xq[v]);
    }
    gL[t * kRows + tid % kRows] = xl;
  };

  load_q(0);
  {  // the block's K rows, split once; keys past S are zero (and masked)
    const float* kh = k + b * k_sb + g * k_sh;
    constexpr int kBatch = 4;  // loads in flight before their split stores
    for (int e0 = tid; e0 < L::kKeys * CH; e0 += kBatch * kThreads) {
      float4 x[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + u * kThreads, r = e / CH, key = key0 + r;
        x[u] = key < S ? __ldg(reinterpret_cast<const float4*>(kh + key * k_ss) + e % CH)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + u * kThreads;
        store_split4(gK, gK + L::kKTile, sw128_offset(e / CH, e % CH, L::kKeys), x[u]);
      }
    }
  }
  split_q(0);
  if (n_steps > 1) load_q(1);
  fence_proxy_async();  // the split stores are read by wgmma
  __syncthreads();

  // warpgroup wg owns keys wkey0 .. wkey0 + 63; this thread keys kr0 and
  // kr0 + 8 of them, and accumulator columns (queries) 8j + 2 t4 + e
  const int warp = tid / 32, lane = tid % 32, wg = warp / 4, w = warp % 4, t4 = lane % 4;
  const int wkey0 = key0 + wg * 64;
  const int kr0 = wkey0 + w * 16 + lane / 4;
  const bool active = wkey0 < S;
  const uint32_t ka_hi = sKh + wg * 64 * 128, ka_lo = sKl + wg * 64 * 128;
  float acc0 = 0.f, acc1 = 0.f;

  // S^T = K q^T of step i into sc, as fp32 K-attn's forward computes S
  // (causal_attention.cu, qk_tile): the small terms over the whole
  // reduction, then hi.hi, so each score is the one behind the forward's
  // LSE. Issued and committed, not waited for; by every warpgroup at every
  // step, work or not: wgmma under a branch on the warpgroup (a divergent
  // path to the compiler) is serialized by ptxas (C7518), which read slower
  // on an H100 than the idle products cost.
  auto issue = [&](float (&sc)[kRows / 2], int i) {
    const uint32_t qh = sQ + 2 * (i % L::kStages) * L::kQTile, ql = qh + L::kQTile;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 8; ++kk) {
      const uint32_t ok = (kk / 4) * L::kKeys * 128 + (kk % 4) * 32;
      const uint32_t oq = (kk / 4) * kRows * 128 + (kk % 4) * 32;
      wgmma_tf32_ss(sc, sw128_desc(ka_hi + ok, 16, 1024), sw128_desc(ql + oq, 16, 1024), kk > 0);
      wgmma_tf32_ss(sc, sw128_desc(ka_lo + ok, 16, 1024), sw128_desc(qh + oq, 16, 1024), 1);
    }
#pragma unroll
    for (int kk = 0; kk < HD / 8; ++kk) {
      const uint32_t ok = (kk / 4) * L::kKeys * 128 + (kk % 4) * 32;
      const uint32_t oq = (kk / 4) * kRows * 128 + (kk % 4) * 32;
      wgmma_tf32_ss(sc, sw128_desc(ka_hi + ok, 16, 1024), sw128_desc(qh + oq, 16, 1024), 1);
    }
    wgmma_commit();
  };

  // p = exp(s * scale - lse) of step i's scores into the column sums, and
  // the last row where the tile holds row S - 1. The exponent is formed by
  // one FMA, and ex2.approx takes it times log2 e, so the error stays
  // relative to |exponent| (p e^-|x| |x| 2^-24 at most: under 2e-8). A
  // tile that the diagonal, the edge at S or row S - 1 does not cross takes
  // the unmasked loop.
  auto p_of = [&](float sv, float lq) { return fast_exp2(fmaf(sv, scale, -lq) * kLog2e); };
  auto sum_p = [&](const float (&sc)[kRows / 2], int i) {
    const int q0 = (qt0 + i) * kRows;
    if (!active || q0 + kRows - 1 < wkey0) return;  // no query of the tile sees a key of ours
    const float* ls = gL + (i % L::kStages) * kRows;
    if (q0 >= wkey0 + 63 && q0 + kRows < S) {
#pragma unroll
      for (int j = 0; j < kRows / 8; ++j) {
        const float2 lq = *reinterpret_cast<const float2*>(ls + 8 * j + 2 * t4);
        acc0 += p_of(sc[4 * j], lq.x);
        acc0 += p_of(sc[4 * j + 1], lq.y);
        acc1 += p_of(sc[4 * j + 2], lq.x);
        acc1 += p_of(sc[4 * j + 3], lq.y);
      }
      return;
    }
    // the diagonal (key <= query) and the edge at S (query < S) masked, and
    // the last row written where the tile holds row S - 1
    const bool has_last = q0 + kRows >= S;
    const int q_end = min(S, q0 + kRows) - q0;  // tile columns below it are queries < S
#pragma unroll
    for (int j = 0; j < kRows / 8; ++j) {
      const float2 lq = *reinterpret_cast<const float2*>(ls + 8 * j + 2 * t4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cq = 8 * j + 2 * t4 + (e & 1), key = kr0 + 8 * (e >> 1);
        const float p = key - q0 <= cq && cq < q_end ? p_of(sc[4 * j + e], e & 1 ? lq.y : lq.x)
                                                     : 0.f;
        if (e < 2) acc0 += p; else acc1 += p;
        if (has_last && cq == S - 1 - q0 && key < S) last[bh * S + key] = p;
      }
    }
  };

  float sc[kRows / 2];
  for (int i = 0; i < n_steps; ++i) {
    issue(sc, i);
    if (i + 1 < n_steps) {  // while the products run
      split_q((i + 1) % L::kStages);
      if (i + 2 < n_steps) load_q(i + 2);
    }
    wgmma_wait<0>();
    fence_regs(sc);
    sum_p(sc, i);
    fence_proxy_async();  // the next stage's split stores are read by wgmma
    __syncthreads();      // ... and every warpgroup is done with this stage
  }
  if (active) {
    const float a0 = quad_sum(acc0), a1 = quad_sum(acc1);
    if (t4 == 0) {
      if (kr0 < S) col[bh * S + kr0] = a0 * inv_s;
      if (kr0 + 8 < S) col[bh * S + kr0 + 8] = a1 * inv_s;
    }
  }
}

template <int HD>
int launch_tf32(const void* q, const void* k, const float* lse, float* col, float* last, int B,
                int S, int H, int KV, long long q_sb, long long q_ss, long long k_sb,
                long long k_ss, long long k_sh, cudaStream_t stream) {
  using L = ColF32<HD>;
  const int smem = L::kBytes;
  cudaError_t err = cudaFuncSetAttribute(attn_col_tf32<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (S + L::kKeys - 1) / L::kKeys);
  attn_col_tf32<HD><<<grid, L::kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), lse, col, last, S, H, KV,
      q_sb, q_ss, k_sb, k_ss, k_sh, 1.0f / sqrtf((float)HD), 1.0f / (float)S);
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
                                long long q_sb, long long q_ss, long long k_sb,
                                long long k_ss, long long k_sh, void* stream) {
  using namespace edgellm;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && (hd == 64 || hd == 128)) {
    auto fn = hd == 64 ? launch_tf32<64> : launch_tf32<128>;
    return fn(q, k, lse, col, last, B, S, H, KV, q_sb, q_ss, k_sb, k_ss, k_sh, st);
  }
  if (dtype == 1 && (hd == 64 || hd == 128)) {
    auto fn = hd == 64 ? launch_wgmma<64> : launch_wgmma<128>;
    return fn(q, k, lse, col, last, B, S, H, KV, q_sb, q_ss, k_sb, k_ss, k_sh, st);
  }
  return -1;
}

extern "C" const char* edgellm_attn_col_error(int code) {
  return code < 0 ? "unsupported dtype or head dim" : cudaGetErrorString((cudaError_t)code);
}
