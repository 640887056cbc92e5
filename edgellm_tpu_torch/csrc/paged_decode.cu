// K13 / K14: ragged paged decode attention on Hopper, split-span schedule.
//
// Replaces the TPU kernels _paged_attn (_paged_decode_kernel, K13) and
// _paged_attn_quant (_paged_decode_quant_kernel, K14) of
// edgellm_tpu/models/flash_attention.py. Each slot of the continuous batcher
// holds one query row (q_len = 1) and attends over its own list of pages of
// the shared pool, in logical order, up to its length, with the online
// softmax. Pages at or past the slot's length are never read; positions at
// or past it are masked, as the TPU body does. K14 reads int8 codes, or
// packed int4 codes (lane i in the low nibble, lane i + hd/2 in the high
// one), with one fp32 scale per (row, KV head), and dequantizes in registers
// as code * (scale * (1 / qmax)), the TPU kernel's order. Both dots run in
// fp32 (bf16 inputs are widened; no TF32).
//
// Bound on this card: a decode step reads every live K/V row of every slot
// once and does 4 * rep * hd FLOPs a row (rep = H / KV query heads share a
// KV head): 3.5 FLOP/B in fp32, 7 in bf16, far under the CUDA cores' ridge,
// so the bound is the bytes of the live rows. The design keeps HBM busy:
//
// - Split span (flash-decoding). The TPU walks one slot's pages on one core
//   in grid order; here the grid is (split, KV head [x head chunk], slot) and
//   each block takes one contiguous run of a slot's pages, so B * KV * splits
//   blocks fill the 132 SMs (the split count comes from static shapes,
//   flash_attention.paged_split_plan: about 8 blocks an SM, splits of at
//   least 64 rows). A block writes its partial
//   (m, l, acc) in fp32 to a workspace; a second kernel, launched from the
//   same C entry point, merges a slot's live splits in split order (no
//   atomics: deterministic). A slot whose length fits one split has its
//   output written by that split directly; splits past a slot's length exit
//   at once and the merge never reads them.
// - Copies in flight. A block streams its rows through a ring of 2 stages
//   of 32 rows in shared memory, filled by bulk copies (the TMA unit: one
//   request a page row, completion counted on the stage's mbarrier; the
//   quantized tiers' 4-byte row scales by cp.async): each row's page comes
//   from the block's slice of the page table (loaded once), so a stage
//   gathers across page boundaries at any page size and no lane idles at
//   ps 8 or 16. Stage k + 1 is in flight while stage k computes.
// - Full lanes. Scores: warp w takes query heads 2w and 2w + 1 of the group,
//   lane t row t of the stage, the whole hd-dot from 16-byte shared-memory
//   reads (row pitch = row bytes + 16: conflict-free), q broadcast from
//   shared memory; the online softmax is a warp reduction over the stage's
//   rows with the running max in registers. PV: each thread holds 4 output
//   lanes of all 8 heads for a subset of the rows (32 fp32 accumulators);
//   the subsets are summed once, at the end. An int4 byte is unpacked once
//   (both nibbles) and each row's scale read once per stage.
// Up to 8 query heads share a block (Qwen2: 7 and 6); a larger group is cut
// into chunks of 8, each its own block.
#include "attention_common.cuh"
#include "hopper_common.cuh"

#include <stdint.h>

namespace edgellm {

constexpr int kPdThreads = 128;  // 4 warps
constexpr int kPdRows = 32;      // rows a stage: one per lane in the scores
constexpr int kPdHeads = 8;      // query heads a block: two per warp in the scores (the
                                 // wrapper's PAGED_HEADS_PER_BLOCK, checked at the entry)
constexpr int kPdMaxPages = 256; // pages of a split: the plan's span cap (2048) over ps 8

// One page row (one token, one KV head) of mode MODE: 0 = pages of type P,
// 8 = int8 codes, 4 = packed int4 codes.
template <typename P, int HD, int MODE>
struct PdRow {
  static constexpr int kBytes = MODE == 0 ? HD * (int)sizeof(P) : (MODE == 8 ? HD : HD / 2);
  static constexpr int kPitch = kBytes + 16;  // 16-byte reads of 8 rows hit 32 distinct banks
  static constexpr int kStages = 2;  // one stage in flight while one computes
  static constexpr int kRing = kStages * 2 * kPdRows * kPitch;
  // the end-of-block sum over row subsets reuses the ring: 8 heads x hd x
  // (512 / hd) subsets = 16 KB
  static constexpr int kRingAlloc = kRing > 16384 ? kRing : 16384;
  static constexpr int kScales = MODE == 0 ? 0 : kStages * 2 * kPdRows * 4;
  static constexpr int kBars = 64;  // one 8-byte mbarrier a stage, padded to 64 bytes
  static constexpr int kSmem = kRingAlloc + kScales + kBars +
                               4 * (kPdHeads * HD + kPdRows * kPdHeads + 3 * kPdHeads) +
                               4 * kPdMaxPages;
};

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// Dot of one page row (shared memory, mode MODE) with two query heads qa, qb
// (fp32, shared memory) -> s0, s1. f: the row's dequantization factor.
template <typename P, int HD, int MODE>
__device__ __forceinline__ void row_dot2(const uint8_t* row, const float* qa, const float* qb,
                                         float f, float& s0, float& s1) {
  const float4* qa4 = reinterpret_cast<const float4*>(qa);
  const float4* qb4 = reinterpret_cast<const float4*>(qb);
  const uint4* r16 = reinterpret_cast<const uint4*>(row);
  float a = 0.f, b = 0.f;
  if constexpr (MODE == 0 && sizeof(P) == 4) {
#pragma unroll
    for (int c = 0; c < HD / 4; ++c) {
      const uint4 w = r16[c];
      const float4 k = make_float4(__uint_as_float(w.x), __uint_as_float(w.y),
                                   __uint_as_float(w.z), __uint_as_float(w.w));
      a = dot4(qa4[c], k, a);
      b = dot4(qb4[c], k, b);
    }
  } else if constexpr (MODE == 0) {  // bf16: 8 values a chunk
#pragma unroll
    for (int c = 0; c < HD / 8; ++c) {
      const uint4 w = r16[c];
      const float4 k0 = make_float4(bf16_lo(w.x), bf16_hi(w.x), bf16_lo(w.y), bf16_hi(w.y));
      const float4 k1 = make_float4(bf16_lo(w.z), bf16_hi(w.z), bf16_lo(w.w), bf16_hi(w.w));
      a = dot4(qa4[2 * c + 1], k1, dot4(qa4[2 * c], k0, a));
      b = dot4(qb4[2 * c + 1], k1, dot4(qb4[2 * c], k0, b));
    }
  } else if constexpr (MODE == 8) {  // 16 codes a chunk
#pragma unroll
    for (int c = 0; c < HD / 16; ++c) {
      const uint4 w = r16[c];
      const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t x = words[i];
        const float4 k = make_float4((float)(int8_t)(x & 0xff) * f,
                                     (float)(int8_t)((x >> 8) & 0xff) * f,
                                     (float)(int8_t)((x >> 16) & 0xff) * f,
                                     (float)(int8_t)(x >> 24) * f);
        a = dot4(qa4[4 * c + i], k, a);
        b = dot4(qb4[4 * c + i], k, b);
      }
    }
  } else {  // int4: byte j holds lanes j (low nibble) and j + HD/2 (high nibble)
    constexpr int H2 = HD / 2;
#pragma unroll
    for (int c = 0; c < H2 / 16; ++c) {
      const uint4 w = r16[c];
      const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t x = words[i];
        const float4 lo = make_float4((float)((int)(x & 0xf) - 8) * f,
                                      (float)((int)((x >> 8) & 0xf) - 8) * f,
                                      (float)((int)((x >> 16) & 0xf) - 8) * f,
                                      (float)((int)((x >> 24) & 0xf) - 8) * f);
        const float4 hi = make_float4((float)((int)((x >> 4) & 0xf) - 8) * f,
                                      (float)((int)((x >> 12) & 0xf) - 8) * f,
                                      (float)((int)((x >> 20) & 0xf) - 8) * f,
                                      (float)((int)((x >> 28) & 0xf) - 8) * f);
        const int j4 = 4 * c + i;  // float4 index of lanes 16c + 4i ..
        a = dot4(qa4[H2 / 4 + j4], hi, dot4(qa4[j4], lo, a));
        b = dot4(qb4[H2 / 4 + j4], hi, dot4(qb4[j4], lo, b));
      }
    }
  }
  s0 = a;
  s1 = b;
}

// The 4 output lanes of quad `qd` of one page row, as fp32: lanes 4qd .. 4qd+3,
// or for int4 lanes 2qd, 2qd+1, HD/2 + 2qd, HD/2 + 2qd + 1 (one code byte pair).
template <typename P, int HD, int MODE>
__device__ __forceinline__ int quad_lane(int qd, int i) {
  if constexpr (MODE == 4) return (i < 2 ? 0 : HD / 2) + 2 * qd + (i & 1);
  return 4 * qd + i;
}

template <typename P, int HD, int MODE>
__device__ __forceinline__ void row_quad(const uint8_t* row, int qd, float f, float (&v)[4]) {
  if constexpr (MODE == 0 && sizeof(P) == 4) {
    const float4 x = reinterpret_cast<const float4*>(row)[qd];
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else if constexpr (MODE == 0) {
    const uint2 w = reinterpret_cast<const uint2*>(row)[qd];
    v[0] = bf16_lo(w.x); v[1] = bf16_hi(w.x); v[2] = bf16_lo(w.y); v[3] = bf16_hi(w.y);
  } else if constexpr (MODE == 8) {
    const uint32_t x = reinterpret_cast<const uint32_t*>(row)[qd];
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = (float)(int8_t)((x >> (8 * i)) & 0xff) * f;
  } else {
    const uint32_t x = reinterpret_cast<const uint16_t*>(row)[qd];
    v[0] = (float)((int)(x & 0xf) - 8) * f;          // lane 2qd
    v[1] = (float)((int)((x >> 8) & 0xf) - 8) * f;   // lane 2qd + 1
    v[2] = (float)((int)((x >> 4) & 0xf) - 8) * f;   // lane HD/2 + 2qd
    v[3] = (float)((int)((x >> 12) & 0xf) - 8) * f;  // lane HD/2 + 2qd + 1
  }
}

// scale * (1 / qmax), the reference's dequantization factor
template <int MODE>
__device__ __forceinline__ float dequant_factor(float scale) {
  return scale * (MODE == 8 ? 1.0f / 127.0f : 1.0f / 7.0f);
}

// Grid (split, KV head x head chunk, slot), kPdThreads threads. A slot whose
// live splits number one writes `out`; otherwise each live split writes its
// partial to ws: acc (B, splits, H, HD), then (m, l) (B, splits, H, 2).
template <typename T, typename P, int HD, int MODE>
__global__ void __launch_bounds__(kPdThreads)
paged_decode_split_kernel(const T* __restrict__ q, const void* __restrict__ kpages,
                          const void* __restrict__ vpages, const float* __restrict__ kscale,
                          const float* __restrict__ vscale, const int* __restrict__ page_table,
                          const int* __restrict__ lengths, T* __restrict__ out,
                          float* __restrict__ ws, int H, int KV, int ps, int pps, int num_pages,
                          int per, int splits, int nchunk, float scale) {
  using R = PdRow<P, HD, MODE>;
  constexpr int ST = R::kStages;
  constexpr int NQ = HD / 4;              // output quads
  constexpr int NRS = kPdThreads / NQ;    // row subsets of the PV: 8 at hd 64, 4 at 128
  constexpr int RPS = kPdRows / NRS;      // rows a subset
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* ring = smem;                                         // ST x {K, V} x rows x pitch
  float* Sc = reinterpret_cast<float*>(smem + R::kRingAlloc);   // ST x {K, V} x rows
  uint64_t* Bars = reinterpret_cast<uint64_t*>(smem + R::kRingAlloc + R::kScales);  // ST
  float* Qs = reinterpret_cast<float*>(smem + R::kRingAlloc + R::kScales + R::kBars);  // 8 x HD
  float* Ps = Qs + kPdHeads * HD;         // rows x 8: probabilities of the stage
  float* Corr = Ps + kPdRows * kPdHeads;  // 8: the stage's rescale of acc
  float* Ml = Corr + kPdHeads;            // 8 x 2: final (m, l)
  int* PT = reinterpret_cast<int*>(Ml + 2 * kPdHeads);

  const int s = blockIdx.x, b = blockIdx.z;
  const int rep = H / KV;
  const int g = blockIdx.y / nchunk;
  const int h0 = g * rep + (blockIdx.y % nchunk) * kPdHeads;
  const int nh = min(kPdHeads, (g + 1) * rep - h0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the length, this split's slice of the page table and q in one round trip
  const int len = min(lengths[b], pps * ps);
  const int page0 = s * per;
  const int npages = min(per, pps - page0);
  for (int i = tid; i < npages; i += kPdThreads) {
    const int pg = page_table[(long long)b * pps + page0 + i];
    PT[i] = pg < 0 ? 0 : (pg >= num_pages ? num_pages - 1 : pg);
  }
  for (int e = tid; e < kPdHeads * HD; e += kPdThreads)
    Qs[e] = e / HD < nh ? to_float(q[((long long)b * H + h0) * HD + e]) : 0.f;
  if (tid == 0) {
    for (int i = 0; i < ST; ++i) mbar_init(smem_u32(Bars + i), 1);
    mbar_init_fence();
  }
  __syncthreads();  // PT (and the barriers) before the first copies
  const int split_rows = per * ps;
  const int r0 = s * split_rows;
  if (s > 0 && r0 >= len) return;  // past the slot's length: the merge skips it
  const int r1 = min(r0 + split_rows, len);
  const int nstages = r1 > r0 ? (r1 - r0 + kPdRows - 1) / kPdRows : 0;
  const int nlive = max(1, (len + split_rows - 1) / split_rows);

  const uint8_t* kbase = static_cast<const uint8_t*>(kpages);
  const uint8_t* vbase = static_cast<const uint8_t*>(vpages);
  // copy stage `st` (rows r0 + 32 st ..) into ring buffer `buf`; rows at or
  // past r1 are not read (their ring rows are masked or never read)
  auto row_of = [&](int pos) -> long long {
    const int lp = pos / ps;
    return (long long)PT[lp - page0] * ps + (pos - lp * ps);
  };
  auto copy_stage = [&](int st, int buf) {
    const int base = r0 + st * kPdRows;
    uint8_t* kb = ring + buf * 2 * kPdRows * R::kPitch;
    // one bulk copy a page row: threads 0-31 the K rows, 32-63 the V rows
    if (tid < 2 * kPdRows) {
      const int which = tid / kPdRows, t = tid % kPdRows;
      const int nrows = min(kPdRows, r1 - base);
      const uint32_t bar = smem_u32(Bars + buf);
      fence_proxy_async();  // the ring's last reads (generic proxy) before the copy
      if (tid == 0) mbar_arrive_expect_tx(bar, 2 * nrows * R::kBytes);
      if (t < nrows)
        bulk_copy_g2s(smem_u32(kb + (which * kPdRows + t) * R::kPitch),
                      (which ? vbase : kbase) + (row_of(base + t) * KV + g) * R::kBytes,
                      R::kBytes, bar);
    }
    if constexpr (MODE != 0) {  // the rows' scales: 4-byte cp.async, zero past r1
      const int j = tid - (kPdThreads - 2 * kPdRows);
      if (j >= 0) {
        const int which = j / kPdRows, t = j % kPdRows;
        const bool valid = base + t < r1;
        const long long row = valid ? row_of(base + t) : 0;
        cp_async4(smem_u32(Sc + (buf * 2 + which) * kPdRows + t),
                  (which ? vscale : kscale) + row * KV + g, valid);
      }
    }
  };

#pragma unroll 1
  for (int st = 0; st < ST - 1; ++st) {
    if (st < nstages) copy_stage(st, st);
    cp_async_commit();
  }

  float m_run[2] = {-INFINITY, -INFINITY};  // warp-uniform running max of heads 2w, 2w+1
  float l_lane[2] = {0.f, 0.f};             // this lane's share of the running sums
  float acc[kPdHeads][4];
#pragma unroll
  for (int r = 0; r < kPdHeads; ++r)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[r][i] = 0.f;
  const int qd = tid % NQ, rsub = tid / NQ;
  const bool warp_heads = 2 * warp < nh;

#pragma unroll 1
  for (int k = 0; k < nstages; ++k) {
    cp_async_wait_group<ST - 2>();
    mbar_wait(smem_u32(Bars + k % ST), (k / ST) & 1);
    __syncthreads();  // stage k landed for every thread; stage k - 1's PV is done
    if (k + ST - 1 < nstages) copy_stage(k + ST - 1, (k + ST - 1) % ST);
    cp_async_commit();
    const int buf = k % ST;
    const uint8_t* kb = ring + buf * 2 * kPdRows * R::kPitch;
    const uint8_t* vb = kb + kPdRows * R::kPitch;
    const float* ksc = Sc + buf * 2 * kPdRows;
    const float* vsc = ksc + kPdRows;
    const int nvalid = min(kPdRows, r1 - (r0 + k * kPdRows));  // >= 1

    // scores and the online softmax: lane = row, warp = heads 2w, 2w + 1
    {
      const bool live = lane < nvalid;
      float sc[2] = {0.f, 0.f};
      if (warp_heads) {
        float f = 1.f;
        if constexpr (MODE != 0) f = dequant_factor<MODE>(ksc[lane]);
        row_dot2<P, HD, MODE>(kb + lane * R::kPitch, Qs + 2 * warp * HD,
                              Qs + (2 * warp + 1) * HD, f, sc[0], sc[1]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float sj = live ? sc[j] * scale : -INFINITY;
        float mx = sj;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m_run[j], mx);  // finite: row 0 of the stage is live
        const float p = live ? expf(sj - m_new) : 0.f;
        const float corr = expf(m_run[j] - m_new);  // exp(-inf) = 0 on the first stage
        l_lane[j] = l_lane[j] * corr + p;
        m_run[j] = m_new;
        Ps[lane * kPdHeads + 2 * warp + j] = p;
        if (lane == 0) Corr[2 * warp + j] = corr;
      }
    }
    __syncthreads();

    // PV: rows rsub * RPS .. of the stage into 4 lanes (quad qd) of 8 heads
    {
#pragma unroll
      for (int r = 0; r < kPdHeads; ++r) {
        const float c = Corr[r];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[r][i] *= c;
      }
#pragma unroll
      for (int i = 0; i < RPS; ++i) {
        const int t = rsub * RPS + i;
        if (t >= nvalid) break;
        float v[4], f = 1.f;
        if constexpr (MODE != 0) f = dequant_factor<MODE>(vsc[t]);
        row_quad<P, HD, MODE>(vb + t * R::kPitch, qd, f, v);
        const float4 pa = reinterpret_cast<const float4*>(Ps + t * kPdHeads)[0];
        const float4 pb = reinterpret_cast<const float4*>(Ps + t * kPdHeads)[1];
        const float p[kPdHeads] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
#pragma unroll
        for (int r = 0; r < kPdHeads; ++r)
#pragma unroll
          for (int d = 0; d < 4; ++d) acc[r][d] = fmaf(p[r], v[d], acc[r][d]);
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();  // the ring is free: it holds the row subsets' sums next

#pragma unroll
  for (int j = 0; j < 2; ++j) {
    float l = l_lane[j];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
    if (lane == 0) {
      Ml[2 * (2 * warp + j)] = m_run[j];
      Ml[2 * (2 * warp + j) + 1] = l;
    }
  }
  float* Red = reinterpret_cast<float*>(ring);  // NRS x 8 x HD
#pragma unroll
  for (int r = 0; r < kPdHeads; ++r)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      Red[(rsub * kPdHeads + r) * HD + quad_lane<P, HD, MODE>(qd, i)] = acc[r][i];
  __syncthreads();

  for (int e = tid; e < nh * HD; e += kPdThreads) {
    const int r = e / HD;
    float a = 0.f;
#pragma unroll
    for (int rs = 0; rs < NRS; ++rs) a += Red[rs * kPdHeads * HD + e];
    const long long h = (long long)b * H + h0 + r;
    if (nlive == 1) {
      out[h * HD + (e - r * HD)] = from_float<T>(a / Ml[2 * r + 1]);
    } else {
      const long long hs = ((long long)b * splits + s) * H + h0 + r;
      ws[hs * HD + (e - r * HD)] = a;
      if (e - r * HD == 0) {
        float* ml = ws + (long long)gridDim.z * splits * H * HD;
        ml[2 * hs] = Ml[2 * r];
        ml[2 * hs + 1] = Ml[2 * r + 1];
      }
    }
  }
}

// Grid (output chunk of 128 lanes, slot), one output lane a thread: the
// slot's live splits merged in split order (nothing for a slot whose one
// live split wrote the output itself).
constexpr int kMergeThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kMergeThreads)
paged_merge_kernel(const float* __restrict__ ws, const int* __restrict__ lengths,
                   T* __restrict__ out, int B, int H, int HD, int splits, int split_rows,
                   int span) {
  const int b = blockIdx.y, e = blockIdx.x * kMergeThreads + threadIdx.x;
  const int len = min(lengths[b], span);
  const int nlive = max(1, (len + split_rows - 1) / split_rows);
  if (nlive == 1 || e >= H * HD) return;
  const int h = e / HD;
  const long long hs0 = (long long)b * splits * H + h;  // split s: hs0 + s * H
  const float* ml = ws + (long long)B * splits * H * HD;
  float m = -INFINITY;
#pragma unroll 4
  for (int s = 0; s < nlive; ++s) m = fmaxf(m, ml[2 * (hs0 + (long long)s * H)]);
  float l = 0.f, o = 0.f;
#pragma unroll 4
  for (int s = 0; s < nlive; ++s) {
    const long long hs = hs0 + (long long)s * H;
    const float w = expf(ml[2 * hs] - m);
    l = fmaf(ml[2 * hs + 1], w, l);
    o = fmaf(ws[hs * HD + (e - h * HD)], w, o);
  }
  out[(long long)b * H * HD + e] = from_float<T>(o / l);
}

template <typename T, typename P, int HD, int MODE>
int launch_paged(const void* q, const void* kp, const void* vp, const float* ks,
                 const float* vs, const int* pt, const int* lens, void* out, float* ws, int B,
                 int H, int KV, int ps, int pps, int num_pages, int splits, int per, int heads,
                 float scale, cudaStream_t stream) {
  using R = PdRow<P, HD, MODE>;
  const int rep = H / KV;
  const int nchunk = (rep + kPdHeads - 1) / kPdHeads;
  if (heads != kPdHeads || per < 1 || per > kPdMaxPages || splits < 1 ||
      (long long)splits * per < pps || (splits > 1 && ws == nullptr))
    return -1;
  cudaError_t err = cudaFuncSetAttribute(paged_decode_split_kernel<T, P, HD, MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, R::kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(splits, KV * nchunk, B);
  paged_decode_split_kernel<T, P, HD, MODE><<<grid, kPdThreads, R::kSmem, stream>>>(
      static_cast<const T*>(q), kp, vp, ks, vs, pt, lens, static_cast<T*>(out), ws, H, KV, ps,
      pps, num_pages, per, splits, nchunk, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const dim3 mgrid((H * HD + kMergeThreads - 1) / kMergeThreads, B);
  paged_merge_kernel<T><<<mgrid, kMergeThreads, 0, stream>>>(
      ws, lens, static_cast<T*>(out), B, H, HD, splits, per * ps, pps * ps);
  return (int)cudaGetLastError();
}

}  // namespace edgellm

// q / out: (B, H*hd) of dtype (0 = float32, 1 = bfloat16). mode 0 (K13):
// k/v pages (num_pages, ps, KV, hd) of q's dtype, scales unused; mode 8 or 4
// (K14): int8 codes (num_pages, ps, KV, hd) or packed int4 codes
// (num_pages, ps, KV, hd/2), k/v scales (num_pages, ps, KV) fp32. page_table
// (B, pps) and lengths (B,) int32. The span is cut into `splits` runs of
// `per` pages (flash_attention.paged_split_plan), each block holding `heads`
// query heads of a group; with splits > 1, ws is fp32 scratch of
// B * splits * H * (hd + 2) values. Page and scale pointers 16-byte aligned.
// Returns the cudaError_t of the launches (0 on success); -1 for a dtype,
// mode, head dim, heads a block or split plan the kernel was not built for.
// ``scale`` is the float32 1 / sqrt(hd) the scores are multiplied by.
extern "C" int edgellm_paged_decode(const void* q, const void* kp, const void* vp,
                                    const float* ks, const float* vs, const int* pt,
                                    const int* lens, void* out, float* ws, int B, int H, int KV,
                                    int hd, int ps, int pps, int num_pages, int splits, int per,
                                    int heads, float scale, int dtype, int mode, void* stream) {
  using namespace edgellm;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define EDGELLM_PAGED(T, P, HD, MODE)                                                          \
  return launch_paged<T, P, HD, MODE>(q, kp, vp, ks, vs, pt, lens, out, ws, B, H, KV, ps, pps, \
                                      num_pages, splits, per, heads, scale, st)
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
  return code < 0 ? "unsupported dtype, mode, head dim, heads a block or split plan"
                  : cudaGetErrorString((cudaError_t)code);
}
