// K-attn: exact causal attention softmax(Q K^T / sqrt(hd)) V on Hopper.
//
// Replaces the TPU kernels _attn_packed and _attn_blocked
// (edgellm_tpu/models/flash_attention.py). Those keep a whole (S, S) or
// (qb, S) fp32 score slab in VMEM; a Hopper block has 227 KB of shared memory,
// so this kernel is flash-style instead: a block takes a query tile (of one
// head in bf16, of one GQA group in fp32) and walks the key tiles up to the
// diagonal with an online softmax in fp32, never writing scores to device
// memory. Tiles above the diagonal are
// skipped, not computed and masked.
//
// Bound on this card: at the sweep's shapes (S = 512, hd = 64) the causal
// work is ~S/4 FLOPs per byte moved, below the ~295 FLOP/byte ridge, so the
// roofline bound is the bytes of q, K, V and the output.
//
// bf16 (attn_fwd_wgmma): both products on the tensor cores. A block holds 64
// (hd 64) or 128 (hd 128) query rows, a consumer warpgroup for each 64 and
// one producer warp. The producer copies the block's q rows once, then K and
// V tiles of 64 keys into a 4-stage ring, with 16-byte cp.async into the
// swizzled layout wgmma reads (hopper_common.cuh); each copy arrives on its
// stage's mbarrier when it lands, so every free stage is in flight at once,
// and the consumers release a stage on another mbarrier. A consumer computes
// S = q K^T by wgmma from shared memory (fp32 accumulator), masks only the
// diagonal tile and the ragged edge at S, runs the online softmax in
// registers with the scale folded into exp2, rounds P to bf16 in registers
// (as the reference rounds p to q's dtype before PV) and accumulates
// O += P V by wgmma with P as the register operand and V read through the
// descriptor's transpose bit. The next tile's S is issued before this tile's
// PV, so the softmax runs while the PV is on the tensor cores. The output is
// normalized once, rounded once to bf16, staged in the warpgroup's own q rows
// and stored in 16-byte rows. Query tiles are issued heaviest (last) first.
// K/V tiles are not shared across the query heads of a GQA group: every
// head's query tile reads them again from L2, which is what bounds this
// design next (on an H100 at Qwen2-0.5B B=32 the copy ring alone took 0.037
// of the kernel's 0.084 ms, where SDPA took 0.060; attention_variants.py).
//
// fp32 (attn_fwd_tf32, attn_fwd_merge): fp32-accurate products on the tensor
// cores by the 3xTF32 split. The reference has no TF32 and none is used here:
// every operand x is split into hi = tf32(x) and lo = tf32(x - hi), and
// a.b = a_lo.b_hi + a_hi.b_lo + a_hi.b_hi (the dropped a_lo.b_lo is 2^-22
// relative), three TF32 wgmma with fp32 accumulation, for q K^T (both from
// shared memory) and for P V (P from registers, V^T from shared memory: TF32
// wgmma reads shared tiles K-major only, so V lands transposed). The bound
// at fp32 is then 3 FLOPs of TF32 a FLOP: 164.9 TFLOP/s on an H100 SXM
// against 67 on the CUDA cores. q is split once, K and V once a tile as they
// move from the cp.async ring (a tile a stage, 2 stages: the next tile in
// flight while this one computes) into the swizzled tiles, P in registers.
// A block holds 64 query rows a warpgroup (128 at hd 64), drawn from all the
// query heads of one KV head (packed position-major, as the reference loops
// over a group's heads), so each K/V tile is read once for the group. A B=1
// prefill has few row tiles, so the key range of a long row tile is cut into
// splits from static shapes (flash_attention.attn_split_plan: no host sync),
// heaviest tiles first; the splits' partial softmax states go to a workspace
// and a second kernel merges them in split order (no atomics, so two
// launches are bit for bit equal).
//
// With a non-null lse pointer it also writes the per-row log-sum-exp
// (B, H, S) fp32: the first pass of the stats kernel (attention_stats.cu).
#include "attention_common.cuh"
#include "hopper_common.cuh"

namespace edgellm {

// ---------------------------------------------------------------------------
// fp32: 3xTF32 products on the tensor cores (wgmma), one K/V stream per GQA
// group, key splits merged by a second kernel
// ---------------------------------------------------------------------------

// The fp32 tile by head dim: query rows a block (a warpgroup of 128 threads
// for each 64) and keys a tile (one online-softmax step). hd 64: two
// warpgroups share each 64-key tile's copy and split (193 KB of shared
// memory, one block an SM); on an H100 this read 0.38 ms at Qwen2-0.5B B=32
// S=512 against 0.46 for 64 x 32 tiles at two blocks an SM
// (attention_variants.py). 64-key steps are also the earlier SIMT body's and the
// bf16 body's: with 32-key steps every product form tried moved one int4
// code of chip_smoke.py's serve cross-check across its rounding boundary
// (PERF.md). hd 128: 64 x 32 (a 128 x 64 tile does not fit).
template <int HD> struct F32Tile;
template <> struct F32Tile<64> { static constexpr int kRows = 128, kKeys = 64; };
template <> struct F32Tile<128> { static constexpr int kRows = 64, kKeys = 32; };
constexpr int kF32Stages = 2;  // raw K/V tiles in flight (the cp.async ring)

// Shared memory of a block, every operand tile twice (its TF32 hi and lo
// parts) in the 128-byte-swizzled K-major layout wgmma reads
// (hopper_common.cuh; a row of 32 fp32 values is one 128-byte line): q and
// K with hd as the reduction dim, V transposed (V^T, hd rows of the tile's
// keys) so that the keys are; then the ring of raw K and V tiles as
// they land.
template <int HD>
struct F32Shape {
  static constexpr int kRows = F32Tile<HD>::kRows, kKeys = F32Tile<HD>::kKeys;
  static constexpr int kThreads = 2 * kRows;
  static constexpr int kMergeThreads = 4 * kRows;  // four threads a row
  static constexpr int kQTile = kRows * HD * 4;   // bytes of one q part
  static constexpr int kKTile = kKeys * HD * 4;   // one K or V^T part
  static constexpr int kRaw = kKeys * HD;         // floats of one raw K or V tile
  static constexpr int kBytes = 2 * kQTile + 4 * kKTile + 2 * kF32Stages * kRaw * 4 + 1024;
};

// Byte offset of key `key` of row d in the V^T tile. P enters PV from the
// score accumulator's registers, where a thread holds keys 2t and 2t + 1 of
// each 8; wgmma's A fragment holds columns t and t + 4. So column t of each
// 8 stores key 2t and column t + 4 key 2t + 1 (the reduction order
// permuted, the same for P and V).
template <int HD>
__device__ __forceinline__ uint32_t vt_offset(int d, int key) {
  const int m = key % 8, col = (key - m) + m / 2 + 4 * (m % 2);
  return sw128_offset(d, col / 4, HD) + 4 * (col % 4);
}

// The tensor cores add into the fp32 accumulator with truncation, so each
// product below adds its small terms (a_lo.b_hi, a_hi.b_lo) over the whole
// reduction first and the hi.hi terms last: the error of a truncated add
// scales with the accumulator's magnitude, and only the last third of the
// adds see it large.

// s = q K^T for the warpgroup's 64 rows and the tile's keys (the wgmma
// accumulator layout: this thread's rows r, r + 8, keys 8n + 2t + (e & 1) at
// s[4n + e]), as three TF32 products a step of 8 values of hd; a_lo.b_lo
// (2^-22 relative) is dropped.
template <int HD>
__device__ __forceinline__ void qk_tile(float (&s)[F32Tile<HD>::kKeys / 2], uint32_t q_hi,
                                        uint32_t q_lo, uint32_t k_hi, uint32_t k_lo) {
  constexpr int kRows = F32Tile<HD>::kRows, kKeys = F32Tile<HD>::kKeys;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk) {  // the small terms
    const uint32_t oq = (kk / 4) * kRows * 128 + (kk % 4) * 32;
    const uint32_t ok = (kk / 4) * kKeys * 128 + (kk % 4) * 32;
    wgmma_tf32_ss(s, sw128_desc(q_lo + oq, 16, 1024), sw128_desc(k_hi + ok, 16, 1024), kk > 0);
    wgmma_tf32_ss(s, sw128_desc(q_hi + oq, 16, 1024), sw128_desc(k_lo + ok, 16, 1024), 1);
  }
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk) {  // then hi.hi
    const uint32_t oq = (kk / 4) * kRows * 128 + (kk % 4) * 32;
    const uint32_t ok = (kk / 4) * kKeys * 128 + (kk % 4) * 32;
    wgmma_tf32_ss(s, sw128_desc(q_hi + oq, 16, 1024), sw128_desc(k_hi + ok, 16, 1024), 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
}

// o += p V over the tile's keys: p split into (hi, lo) in registers as the
// A operand, V^T's parts from shared memory, summed over the tile in a fresh
// accumulator and added to o on the CUDA cores (rounded, not truncated: o
// sums up to S keys).
template <int HD>
__device__ __forceinline__ void pv_tile(float (&o)[HD / 2],
                                        const float (&s)[F32Tile<HD>::kKeys / 2], uint32_t vt_hi,
                                        uint32_t vt_lo) {
  constexpr int kKeys = F32Tile<HD>::kKeys;
  uint32_t ph[kKeys / 8][4], pl[kKeys / 8][4];
#pragma unroll
  for (int j = 0; j < kKeys / 8; ++j) {
    const float p[4] = {s[4 * j], s[4 * j + 2], s[4 * j + 1], s[4 * j + 3]};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = split_tf32(p[i]);
      ph[j][i] = __float_as_uint(x.x);
      pl[j][i] = __float_as_uint(x.y);
    }
  }
  float t[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) t[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < kKeys / 8; ++j) {  // the small terms
    const uint32_t ov = (j / 4) * HD * 128 + (j % 4) * 32;
    wgmma_tf32_rs(t, pl[j], sw128_desc(vt_hi + ov, 16, 1024));
    wgmma_tf32_rs(t, ph[j], sw128_desc(vt_lo + ov, 16, 1024));
  }
#pragma unroll
  for (int j = 0; j < kKeys / 8; ++j)  // then hi.hi
    wgmma_tf32_rs(t, ph[j], sw128_desc(vt_hi + (j / 4) * HD * 128 + (j % 4) * 32, 16, 1024));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(t);
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] += t[i];
}

// exp(x * scale - b), b a row max times scale, as the reference computes its
// softmax: the score scaled first (rounded, not fused into the subtraction),
// then exp of its distance to the scaled max; exp(-inf) = 0 for a masked x.
__device__ __forceinline__ float score_exp(float x, float b, float scale) {
  return expf(__fmul_rn(x, scale) - b);
}

// The rows of one (batch row b, KV head g) are its query heads' rows packed
// position-major: row f is position f / rep of query head g * rep + f % rep,
// so a block's rows span ~rows / rep positions of every head of the group
// and each K/V tile is read once for all of them. Row tile t needs the key
// tiles up to its last row's position; block (split, tile, b * KV + g) takes
// `per` of them from split * per on. A tile that one split covers writes its
// output; the splits of a longer one write (acc, m, l) partials to ws, which
// attn_fwd_merge combines in split order.
template <int HD>
__device__ __forceinline__ int f32_key_tiles(int t, int R, int rep) {
  constexpr int kRows = F32Tile<HD>::kRows, kKeys = F32Tile<HD>::kKeys;
  return (min(R - 1, t * kRows + kRows - 1) / rep) / kKeys + 1;
}

template <int HD>
__global__ void __launch_bounds__(F32Shape<HD>::kThreads)
attn_fwd_tf32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ out, float* __restrict__ lse,
              float* __restrict__ ws, int S, int H, int KV, int per, long long q_sb,
              long long q_ss, long long k_sb, long long k_ss, long long k_sh, long long v_sb,
              long long v_ss, long long v_sh, long long o_sb, long long o_ss, float scale) {
  using L = F32Shape<HD>;
  constexpr int kRows = L::kRows, kKeys = L::kKeys, kThreads = L::kThreads;
  constexpr int CH = HD / 4;  // 16-byte chunks a row
  extern __shared__ unsigned char smem_f32[];
  // the tiles start 1024-byte aligned (the swizzle's period); sX is a shared
  // address for wgmma, gX the generic pointer the split stores write through
  const uint32_t raw0 = smem_u32(smem_f32);
  const uint32_t sQh = (raw0 + 1023u) & ~1023u, sQl = sQh + L::kQTile;
  const uint32_t sKh = sQl + L::kQTile, sKl = sKh + L::kKTile;
  const uint32_t sVh = sKl + L::kKTile, sVl = sVh + L::kKTile;
  unsigned char* gQh = smem_f32 + (sQh - raw0);
  unsigned char* gQl = gQh + L::kQTile;
  unsigned char* gKh = gQl + L::kQTile;
  unsigned char* gKl = gKh + L::kKTile;
  unsigned char* gVh = gKl + L::kKTile;
  unsigned char* gVl = gVh + L::kKTile;
  float* raw = reinterpret_cast<float*>(gVl + L::kKTile);

  const int rep = H / KV, R = S * rep;
  const int nrt = gridDim.y, t = nrt - 1 - blockIdx.y;  // heaviest row tile first
  const int split = blockIdx.x, splits = gridDim.x;
  const int bg = blockIdx.z, b = bg / KV, g = bg % KV;
  const int row0 = t * kRows;
  const int n_kt = f32_key_tiles<HD>(t, R, rep);
  const int nsplit = (n_kt + per - 1) / per;
  if (split >= nsplit) return;
  const int kt0 = split * per, kt1 = min(n_kt, kt0 + per);
  const int tid = threadIdx.x;

  const float* kh = k + b * k_sb + g * k_sh;
  const float* vh = v + b * v_sb + g * v_sh;
  // raw K and V of tile kt into ring stage kt % kF32Stages; keys past S are
  // zero-filled (and masked: no row sees them)
  auto issue = [&](int kt) {
    float* rk = raw + (kt % kF32Stages) * 2 * L::kRaw;
    float* rv = rk + L::kRaw;
    for (int e = tid; e < kKeys * CH; e += kThreads) {
      const int r = e / CH, c = e % CH, key = kt * kKeys + r;
      const long long kr = min(key, S - 1);
      cp_async16(smem_u32(rk + r * HD + 4 * c), kh + kr * k_ss + 4 * c, key < S);
      cp_async16(smem_u32(rv + r * HD + 4 * c), vh + kr * v_ss + 4 * c, key < S);
    }
  };
#pragma unroll
  for (int st = 0; st < kF32Stages; ++st) {
    if (kt0 + st < kt1) issue(kt0 + st);
    cp_async_commit();  // one group a stage, empty or not
  }
  // q rows, split into (hi, lo) once; rows past R are zero
  for (int e = tid; e < kRows * CH; e += kThreads) {
    const int r = e / CH, c = e % CH, f = row0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (f < R)
      x = *reinterpret_cast<const float4*>(q + b * q_sb + (f / rep) * q_ss +
                                           (long long)(g * rep + f % rep) * HD + 4 * c);
    store_split4(gQh, gQl, sw128_offset(r, c, kRows), x);
  }

  const int warp = tid / 32, lane = tid % 32, t4 = lane % 4;
  const int rA = warp * 16 + lane / 4;  // this thread's rows rA and rA + 8 of the tile
  // their positions (a row past R takes the last: it is computed, not written)
  const int posA = min(row0 + rA, R - 1) / rep, posB = min(row0 + rA + 8, R - 1) / rep;
  const int pos_min = row0 / rep;
  const uint32_t wq = (tid / 128) * 64 * 128;  // this warpgroup's 64 rows of the q tiles
  float o[HD / 2];  // the wgmma accumulator: columns 8nb + 2t + (e & 1) at o[4nb + e]
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float mA = -INFINITY, mB = -INFINITY, lA = 0.f, lB = 0.f;  // l: this thread's keys

  for (int kt = kt0; kt < kt1; ++kt) {
    cp_async_wait_group<kF32Stages - 1>();  // tile kt has landed (this thread's copies)
    __syncthreads();  // ... every thread's, and the last tile's hi / lo are read
    {
      const float* rk = raw + (kt % kF32Stages) * 2 * L::kRaw;
      const float* rv = rk + L::kRaw;
      for (int e = tid; e < kKeys * CH; e += kThreads) {
        const int r = e / CH, c = e % CH;
        store_split4(gKh, gKl, sw128_offset(r, c, kKeys),
                     *reinterpret_cast<const float4*>(rk + r * HD + 4 * c));
      }
      // V^T: a warp's lanes take 32 keys of one row chunk, so their stores
      // fill one 128-byte line of each of the chunk's 4 rows
      for (int e = tid; e < kKeys * CH; e += kThreads) {
        const int r = e % kKeys, c = e / kKeys;
        const float4 x = *reinterpret_cast<const float4*>(rv + r * HD + 4 * c);
        const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 y = split_tf32(xs[i]);
          const uint32_t off = vt_offset<HD>(4 * c + i, r);
          *reinterpret_cast<float*>(gVh + off) = y.x;
          *reinterpret_cast<float*>(gVl + off) = y.y;
        }
      }
    }
    fence_proxy_async();  // the split stores (and q's) are read by wgmma
    __syncthreads();  // hi / lo ready; the raw stage is free
    if (kt + kF32Stages < kt1) issue(kt + kF32Stages);
    cp_async_commit();

    float s[kKeys / 2];
    qk_tile<HD>(s, sQh + wq, sQl + wq, sKh, sKl);
    const int key0 = kt * kKeys;
    if (key0 + kKeys - 1 > pos_min) {  // some key is past some row's position
#pragma unroll
      for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key0 + 8 * n + 2 * t4 + (e & 1);
          if (key > (e < 2 ? posA : posB)) s[4 * n + e] = -INFINITY;
        }
    }
    float mxA = mA, mxB = mB;
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n) {
      mxA = fmaxf(mxA, fmaxf(s[4 * n + 0], s[4 * n + 1]));
      mxB = fmaxf(mxB, fmaxf(s[4 * n + 2], s[4 * n + 3]));
    }
    mxA = quad_max(mxA);
    mxB = quad_max(mxB);
    // a split after the first may hide every key of its first tiles from a
    // row: its max stays -inf and its p and rescale factor are 0, not NaN
    const float bA = mxA == -INFINITY ? 0.f : __fmul_rn(mxA, scale);
    const float bB = mxB == -INFINITY ? 0.f : __fmul_rn(mxB, scale);
    const float cA = score_exp(mA, bA, scale), cB = score_exp(mB, bB, scale);
    mA = mxA;
    mB = mxB;
    float psA = 0.f, psB = 0.f;
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n) {
      s[4 * n + 0] = score_exp(s[4 * n + 0], bA, scale);
      s[4 * n + 1] = score_exp(s[4 * n + 1], bA, scale);
      s[4 * n + 2] = score_exp(s[4 * n + 2], bB, scale);
      s[4 * n + 3] = score_exp(s[4 * n + 3], bB, scale);
      psA += s[4 * n + 0] + s[4 * n + 1];
      psB += s[4 * n + 2] + s[4 * n + 3];
    }
    lA = lA * cA + psA;
    lB = lB * cB + psB;
#pragma unroll
    for (int nb = 0; nb < HD / 8; ++nb) {
      o[4 * nb + 0] *= cA;
      o[4 * nb + 1] *= cA;
      o[4 * nb + 2] *= cB;
      o[4 * nb + 3] *= cB;
    }
    pv_tile<HD>(o, s, sVh, sVl);
  }
  cp_async_wait_all();  // no copy outlives its thread

  lA = quad_sum(lA);
  lB = quad_sum(lB);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int f = row0 + rA + 8 * half;
    if (f >= R) continue;
    const float m = half ? mB : mA, l = half ? lB : lA;
    if (nsplit == 1) {
      const int pos = f / rep, h = g * rep + f % rep;
      const float inv = 1.f / l;
      float* orow = out + b * o_sb + pos * o_ss + (long long)h * HD + 2 * t4;
#pragma unroll
      for (int nb = 0; nb < HD / 8; ++nb)
        *reinterpret_cast<float2*>(orow + 8 * nb) =
            make_float2(o[4 * nb + 2 * half] * inv, o[4 * nb + 2 * half + 1] * inv);
      if (lse != nullptr && t4 == 0) lse[((long long)b * H + h) * S + pos] = m * scale + logf(l);
    } else {
      float* prow = ws + ((((long long)bg * nrt + t) * splits + split) * kRows + rA +
                          8 * half) * (HD + 2);
#pragma unroll
      for (int nb = 0; nb < HD / 8; ++nb)
        *reinterpret_cast<float2*>(prow + 8 * nb + 2 * t4) =
            make_float2(o[4 * nb + 2 * half], o[4 * nb + 2 * half + 1]);
      if (t4 == 0) {
        prow[HD] = m;
        prow[HD + 1] = l;
      }
    }
  }
}

// The splits of each row tile that more than one split covers, combined in
// split order (no atomics: two launches are bit for bit equal) into the
// output and the row log-sum-exp. Four threads a row, HD / 4 columns each.
template <int HD>
__global__ void __launch_bounds__(F32Shape<HD>::kMergeThreads)
attn_fwd_merge(const float* __restrict__ ws, float* __restrict__ out, float* __restrict__ lse,
               int S, int H, int KV, int per, long long o_sb, long long o_ss, float scale,
               int splits) {
  constexpr int NC = HD / 4, kRows = F32Tile<HD>::kRows;
  const int rep = H / KV, R = S * rep;
  const int nrt = gridDim.x, t = blockIdx.x, bg = blockIdx.y, b = bg / KV, g = bg % KV;
  const int nsplit = (f32_key_tiles<HD>(t, R, rep) + per - 1) / per;
  const int r = threadIdx.x / 4, c0 = (threadIdx.x % 4) * NC, f = t * kRows + r;
  if (nsplit == 1 || f >= R) return;
  const float* p0 = ws + (((long long)bg * nrt + t) * splits * kRows + r) * (HD + 2);
  const long long step = (long long)kRows * (HD + 2);  // the next split's row
  float big = -INFINITY;
  for (int sp = 0; sp < nsplit; ++sp) big = fmaxf(big, p0[sp * step + HD]);
  const float bb = __fmul_rn(big, scale);  // split 0 sees key 0: big is finite
  float acc[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) acc[i] = 0.f;
  float l = 0.f;
  for (int sp = 0; sp < nsplit; ++sp) {
    const float* p = p0 + sp * step;
    const float w = score_exp(p[HD], bb, scale);  // 0 for a split that saw no key
    l += p[HD + 1] * w;
#pragma unroll
    for (int i = 0; i < NC; i += 2) {
      const float2 x = *reinterpret_cast<const float2*>(p + c0 + i);
      acc[i] += x.x * w;
      acc[i + 1] += x.y * w;
    }
  }
  const int pos = f / rep, h = g * rep + f % rep;
  const float inv = 1.f / l;
  float* orow = out + b * o_sb + pos * o_ss + (long long)h * HD + c0;
#pragma unroll
  for (int i = 0; i < NC; i += 4)
    *reinterpret_cast<float4*>(orow + i) =
        make_float4(acc[i] * inv, acc[i + 1] * inv, acc[i + 2] * inv, acc[i + 3] * inv);
  if (lse != nullptr && c0 == 0) lse[((long long)b * H + h) * S + pos] = big * scale + logf(l);
}

template <int HD>
int launch_tf32(const void* q, const void* k, const void* v, void* out, float* lse, float* ws,
                int splits, int per, int B, int S, int H, int KV, long long q_sb, long long q_ss,
                long long k_sb, long long k_ss, long long k_sh, long long v_sb, long long v_ss,
                long long v_sh, long long o_sb, long long o_ss, cudaStream_t stream) {
  using L = F32Shape<HD>;
  const int max_kt = (S - 1) / L::kKeys + 1;
  if (per < 1 || splits < 1 || (long long)splits * per < max_kt || (splits - 1) * per >= max_kt ||
      (splits > 1 && ws == nullptr))
    return -2;
  const int smem = L::kBytes;
  cudaError_t err = cudaFuncSetAttribute(attn_fwd_tf32<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int nrt = (S * (H / KV) + L::kRows - 1) / L::kRows;
  const float scale = 1.0f / sqrtf((float)HD);
  attn_fwd_tf32<HD><<<dim3(splits, nrt, B * KV), L::kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), lse, ws, S, H, KV, per, q_sb, q_ss, k_sb, k_ss, k_sh, v_sb, v_ss,
      v_sh, o_sb, o_ss, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  attn_fwd_merge<HD><<<dim3(nrt, B * KV), L::kMergeThreads, 0, stream>>>(
      ws, static_cast<float*>(out), lse, S, H, KV, per, o_sb, o_ss, scale, splits);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma), cp.async ring, warp-specialized
// ---------------------------------------------------------------------------

constexpr int kKeys = 64;  // keys per ring stage
constexpr int kStages = 4;

// The block's shape. hd 64: 64 query rows, one consumer warpgroup (111
// registers a thread, 73 KB of shared memory), so three blocks share an SM;
// on an H100 this ran 1.27x faster than 128 rows and two warpgroups at
// Qwen2-0.5B B=32 (attention_variants.py). hd 128: 128 rows, two warpgroups
// (~156 registers: one block fills an SM's registers).
template <int HD>
struct FwdShape {
  static constexpr int kQRows = HD == 64 ? 64 : 128;
  static constexpr int kWGs = kQRows / 64;             // consumer warpgroups of 64 rows
  static constexpr int kThreads = kWGs * 128 + 32;     // + the producer warp
  static constexpr int kQBytes = kQRows * HD * 2;
  static constexpr int kTileBytes = kKeys * HD * 2;  // one K or V stage
  static constexpr int kBytes = kQBytes + 2 * kStages * kTileBytes + 1024;  // + alignment
};

template <int HD>
__global__ void __launch_bounds__(FwdShape<HD>::kThreads, 1)
attn_fwd_wgmma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
               float* __restrict__ lse, int S, int H, int KV, long long q_sb, long long q_ss,
               long long k_sb, long long k_ss, long long k_sh, long long v_sb, long long v_ss,
               long long v_sh, long long o_sb, long long o_ss, float scale, float scale_log2) {
  using L = FwdShape<HD>;
  constexpr int kQRows = L::kQRows, kWGs = L::kWGs;
  constexpr int CH = HD / 8;  // 16-byte chunks per row
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * kStages];  // q, full[], empty[]
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sQ = (raw + 1023u) & ~1023u;
  const uint32_t sK = sQ + L::kQBytes;
  const uint32_t sV = sK + kStages * L::kTileBytes;
  unsigned char* gQ = smem_raw + (sQ - raw);  // generic pointer to the q tile
  const uint32_t bar_q = smem_u32(&bars[0]);
  const uint32_t bar_full = smem_u32(&bars[1]), bar_empty = smem_u32(&bars[1 + kStages]);

  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;  // heaviest query tile first
  const int g = h / (H / KV);
  const int row0 = qt * kQRows;
  const int n_kt = min(row0 + kQRows - 1, S - 1) / kKeys + 1;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 32);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 32);  // the producer warp's lanes
      mbar_init(bar_empty + 8 * s, 4 * kWGs);  // one lane per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 4 * kWGs) {
    // producer: q once, then K/V tiles into every free stage
    const __nv_bfloat16* qh = q + b * q_sb + (long long)h * HD;
    for (int e = lane; e < kQRows * CH; e += 32) {
      const int r = e / CH, c = e % CH, row = row0 + r;
      cp_async16(sQ + sw128_offset(r, c, kQRows), qh + (long long)min(row, S - 1) * q_ss + c * 8,
                 row < S);
    }
    cp_async_arrive(bar_q);
    const __nv_bfloat16* kh = k + b * k_sb + g * k_sh;
    const __nv_bfloat16* vh = v + b * v_sb + g * v_sh;
    for (int kt = 0; kt < n_kt; ++kt) {
      const int s = kt % kStages;
      mbar_wait(bar_empty + 8 * s, ((kt / kStages) & 1) ^ 1);
      const uint32_t dk = sK + s * L::kTileBytes, dv = sV + s * L::kTileBytes;
      for (int e = lane; e < kKeys * CH; e += 32) {
        const int r = e / CH, c = e % CH, key = kt * kKeys + r;
        const long long kr = min(key, S - 1);
        const uint32_t off = sw128_offset(r, c, kKeys);
        cp_async16(dk + off, kh + kr * k_ss + c * 8, key < S);
        cp_async16(dv + off, vh + kr * v_ss + c * 8, key < S);
      }
      cp_async_arrive(bar_full + 8 * s);
    }
    cp_async_wait_all();  // no copy outlives its thread
    return;
  }

  // consumers: warpgroup wg owns rows row0 + 64wg .. + 63; this thread rows
  // r0 and r0 + 8 of them
  const int wg = warp / 4, w = warp % 4, t4 = lane % 4;
  const int wrow0 = row0 + wg * 64;
  const int r0 = wrow0 + w * 16 + lane / 4;
  const bool active = wrow0 < S;
  const int kt_last = active ? min(wrow0 + 63, S - 1) / kKeys : -1;
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // l: this thread's columns
  const uint32_t qa = sQ + wg * 64 * 128;

  auto wait_stage = [&](int kt) {
    mbar_wait(bar_full + 8 * (kt % kStages), (kt / kStages) & 1);
    fence_proxy_async();  // the copies landed through the generic proxy
    __syncwarp();         // wgmma is .aligned: the warp leaves the spin together
  };
  auto release = [&](int kt) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * (kt % kStages));
  };
  // S = q K^T of tile kt into sc: issued and committed, not waited for
  auto issue_s = [&](float (&sc)[32], int kt) {
    const uint32_t kb = sK + (kt % kStages) * L::kTileBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss_n64(sc, sw128_desc(qa + (kk / 4) * kQRows * 128 + (kk % 4) * 32, 16, 1024),
                   sw128_desc(kb + (kk / 4) * kKeys * 128 + (kk % 4) * 32, 16, 1024), kk > 0);
    wgmma_commit();
  };
  // O += P V of tile kt: issued and committed, not waited for
  auto issue_pv = [&](const uint32_t (&pa)[4][4], int kt) {
    const uint32_t vb = sV + (kt % kStages) * L::kTileBytes;
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dv = sw128_desc(vb + kk * 16 * 128, kKeys * 128, 1024);
      if constexpr (HD == 64) {
        wgmma_rs_n64_tb(o, pa[kk], dv);
      } else {
        wgmma_rs_n128_tb(o, pa[kk], dv);
      }
    }
    wgmma_commit();
  };
  // the online softmax of tile kt: masks the diagonal tile and the edge at
  // S, updates the row max and sum, turns sc into p (relative to the new
  // max) and returns the factors that rescale O
  auto softmax = [&](float (&sc)[32], int kt, float& c0, float& c1) {
    const int key0 = kt * kKeys;
    if (key0 + kKeys - 1 > wrow0 || key0 + kKeys > S) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = key0 + (i / 4) * 8 + 2 * t4 + (i & 1);
        const int row = r0 + ((i & 2) ? 8 : 0);
        if (key > row || key >= S) sc[i] = -INFINITY;
      }
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    // key 0 is visible to every row and tile 0 comes first, so the row max
    // is finite from the first tile on
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    c0 = fast_exp2((m0 - mx0) * scale_log2);  // exp2(-inf) = 0 on the first tile
    c1 = fast_exp2((m1 - mx1) * scale_log2);
    m0 = mx0;
    m1 = mx1;
    const float b0 = mx0 * scale_log2, b1 = mx1 * scale_log2;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sc[4 * j] = fast_exp2(fmaf(sc[4 * j], scale_log2, -b0));
      sc[4 * j + 1] = fast_exp2(fmaf(sc[4 * j + 1], scale_log2, -b0));
      sc[4 * j + 2] = fast_exp2(fmaf(sc[4 * j + 2], scale_log2, -b1));
      sc[4 * j + 3] = fast_exp2(fmaf(sc[4 * j + 3], scale_log2, -b1));
      ps0 += sc[4 * j] + sc[4 * j + 1];
      ps1 += sc[4 * j + 2] + sc[4 * j + 3];
    }
    l0 = l0 * c0 + ps0;
    l1 = l1 * c1 + ps1;
  };
  // P as the A operand: keys 16kk .. 16kk + 15 are accumulator columns of
  // blocks 2kk and 2kk + 1
  auto pack = [&](const float (&sc)[32], uint32_t (&pa)[4][4]) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
  };

  mbar_wait(bar_q, 0);
  if (!active) {  // every row of this warpgroup is past S: release the ring
    for (int kt = 0; kt < n_kt; ++kt) {
      wait_stage(kt);
      release(kt);
    }
    return;
  }
  // Software pipeline over the key tiles: tile kt's S = q K^T is issued,
  // then tile kt - 1's O += P V; the softmax of tile kt runs while that PV
  // is still on the tensor cores (it reads P from registers, so P is packed
  // anew only after it), and O is rescaled once it has finished.
  float sc[32];
  uint32_t pa[4][4];
  float c0, c1;
  wait_stage(0);
  issue_s(sc, 0);
  wgmma_wait<0>();
  fence_regs(sc);
  softmax(sc, 0, c0, c1);  // O is still 0: nothing to rescale
  pack(sc, pa);
  for (int kt = 1; kt <= kt_last; ++kt) {
    wait_stage(kt);
    issue_s(sc, kt);  // sc is free: tile kt - 1's P is packed in pa
    issue_pv(pa, kt - 1);
    wgmma_wait<1>();  // S of tile kt is done; the PV may still run
    fence_regs(sc);
    softmax(sc, kt, c0, c1);
    wgmma_wait<0>();
    fence_regs(o);
    release(kt - 1);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      o[4 * j] *= c0;
      o[4 * j + 1] *= c0;
      o[4 * j + 2] *= c1;
      o[4 * j + 3] *= c1;
    }
    pack(sc, pa);
  }
  issue_pv(pa, kt_last);
  wgmma_wait<0>();
  fence_regs(o);
  release(kt_last);
  for (int kt = kt_last + 1; kt < n_kt; ++kt) {  // tiles only the other warpgroup needs
    wait_stage(kt);
    release(kt);
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  // stage the bf16 output in this warpgroup's own q rows (the same swizzled
  // layout: conflict-free 4-byte writes), then store 16-byte row chunks
  named_bar_sync(1 + wg, 128);  // every warp of the group is done reading q
  const int tr = wg * 64 + w * 16 + lane / 4;  // tile row of r0
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    *reinterpret_cast<uint32_t*>(gQ + sw128_offset(tr, j, kQRows) + 4 * t4) =
        pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0);
    *reinterpret_cast<uint32_t*>(gQ + sw128_offset(tr + 8, j, kQRows) + 4 * t4) =
        pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
  }
  named_bar_sync(1 + wg, 128);
  __nv_bfloat16* oh = out + b * o_sb + (long long)h * HD;
  for (int e = threadIdx.x % 128; e < 64 * CH; e += 128) {
    const int r = e / CH, c = e % CH, row = wrow0 + r;
    if (row < S)
      *reinterpret_cast<uint4*>(oh + row * o_ss + c * 8) =
          *reinterpret_cast<const uint4*>(gQ + sw128_offset(wg * 64 + r, c, kQRows));
  }
  if (lse != nullptr && t4 == 0) {
    float* lrow = lse + ((long long)b * H + h) * S;
    if (r0 < S) lrow[r0] = m0 * scale + logf(l0);
    if (r0 + 8 < S) lrow[r0 + 8] = m1 * scale + logf(l1);
  }
}

template <int HD>
int launch_wgmma(const void* q, const void* k, const void* v, void* out, float* lse, int B,
                 int S, int H, int KV, long long q_sb, long long q_ss, long long k_sb,
                 long long k_ss, long long k_sh, long long v_sb, long long v_ss, long long v_sh,
                 long long o_sb, long long o_ss, cudaStream_t stream) {
  using L = FwdShape<HD>;
  const int smem = L::kBytes;
  cudaError_t err = cudaFuncSetAttribute(attn_fwd_wgmma<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H, B, (S + L::kQRows - 1) / L::kQRows);
  const float scale = 1.0f / sqrtf((float)HD);
  attn_fwd_wgmma<HD><<<grid, L::kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), lse, S, H, KV, q_sb,
      q_ss, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, scale, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace edgellm

// dtype: 0 = float32, 1 = bfloat16. The fp32 body takes the key-split plan
// (splits, per: key tiles a split; flash_attention.attn_split_plan) and, with
// more than one split, a workspace of B * KV * row tiles * splits * rows *
// (hd + 2) floats; the bf16 body takes neither (ws null, splits 1). Returns
// the cudaError_t of the launch (0 on success); -1 for a dtype or head dim
// the kernel was not built for, -2 for a plan that does not cover the keys.
extern "C" int edgellm_attn_fwd(const void* q, const void* k, const void* v, void* out,
                                float* lse, float* ws, int splits, int per, int B, int S, int H,
                                int KV, int hd, int dtype, long long q_sb, long long q_ss,
                                long long k_sb, long long k_ss, long long k_sh, long long v_sb,
                                long long v_ss, long long v_sh, long long o_sb, long long o_ss,
                                void* stream) {
  using namespace edgellm;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && (hd == 64 || hd == 128)) {
    auto fn = hd == 64 ? launch_tf32<64> : launch_tf32<128>;
    return fn(q, k, v, out, lse, ws, splits, per, B, S, H, KV, q_sb, q_ss, k_sb, k_ss, k_sh,
              v_sb, v_ss, v_sh, o_sb, o_ss, st);
  }
  if (dtype == 1 && (hd == 64 || hd == 128) && ws == nullptr && splits == 1) {
    auto fn = hd == 64 ? launch_wgmma<64> : launch_wgmma<128>;
    return fn(q, k, v, out, lse, B, S, H, KV, q_sb, q_ss, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
              o_sb, o_ss, st);
  }
  return -1;
}

// The fp32 body's tile at head dim hd: query rows a block, keys a tile (the
// split plan counts key tiles of this size) and a block's shared memory in
// bytes (it sets the blocks an SM holds); -1 for another hd.
extern "C" int edgellm_attn_fwd_f32_tile(int hd, int* rows, int* keys, int* smem) {
  using namespace edgellm;
  if (hd != 64 && hd != 128) return -1;
  *rows = hd == 64 ? F32Shape<64>::kRows : F32Shape<128>::kRows;
  *keys = hd == 64 ? F32Shape<64>::kKeys : F32Shape<128>::kKeys;
  *smem = hd == 64 ? F32Shape<64>::kBytes : F32Shape<128>::kBytes;
  return 0;
}

extern "C" const char* edgellm_attn_fwd_error(int code) {
  if (code == -2) return "the key-split plan does not cover the keys";
  return code < 0 ? "unsupported dtype or head dim" : cudaGetErrorString((cudaError_t)code);
}
