// K-attn: exact causal attention softmax(Q K^T / sqrt(hd)) V on Hopper.
//
// Replaces the TPU kernels _attn_packed and _attn_blocked
// (edgellm_tpu/models/flash_attention.py). Those keep a whole (S, S) or
// (qb, S) fp32 score slab in VMEM; a Hopper block has 227 KB of shared memory,
// so this kernel is flash-style instead: one block per (query tile, head,
// batch row) walks the key tiles up to the diagonal with an online softmax in
// fp32 and never writes scores to device memory. Tiles above the diagonal are
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
// fp32 (attn_fwd_simt): fp32 FMA out of shared memory on the CUDA cores, no
// TF32 (the fp32 reference has none), bound by shared-memory bandwidth.
//
// With a non-null lse pointer it also writes the per-row log-sum-exp
// (B, H, S) fp32: the first pass of the stats kernel (attention_stats.cu).
#include "attention_common.cuh"
#include "hopper_common.cuh"

namespace edgellm {

// ---------------------------------------------------------------------------
// fp32: SIMT body
// ---------------------------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(kThreads)
attn_fwd_simt(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ out, float* __restrict__ lse,
              int S, int H, int KV, long long q_sb, long long q_ss, long long k_sb,
              long long k_ss, long long k_sh, long long v_sb, long long v_ss, long long v_sh,
              long long o_sb, long long o_ss, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                      // kTile x (HD + 1)
  float* Kt = Qs + kTile * (HD + 1);     // HD x (kTile + 1), transposed keys
  float* Vs = Kt + HD * (kTile + 1);     // kTile x HD
  float* Ps = Vs + kTile * HD;           // kTile x (kTile + 1), this tile's probabilities

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / KV);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int row0 = qt * kTile;
  constexpr int NJ = HD / 16;  // output columns per thread: tx + 16 * jj

  const float* qh = q + b * q_sb + (long long)h * HD;
  const float* kh = k + b * k_sb + g * k_sh;
  const float* vh = v + b * v_sb + g * v_sh;
  load_rows<HD>(Qs, HD + 1, qh, q_ss, row0, S);

  float o[4][NJ];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) o[i][jj] = 0.f;
  }

  for (int kt = 0; kt <= qt; ++kt) {
    const int key0 = kt * kTile;
    __syncthreads();  // the previous tile is done with Kt, Vs and Ps
    load_rows_t<HD>(Kt, kTile + 1, kh, k_ss, key0, S);
    load_rows<HD>(Vs, HD, vh, v_ss, key0, S);
    __syncthreads();

    float s[4][4];
    score_tile<HD>(s, Qs, Kt, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = key0 + tx + 16 * j;
        const float val = (key <= row && key < S) ? s[i][j] * scale : -INFINITY;
        s[i][j] = val;
        mx = fmaxf(mx, val);
      }
      // key 0 is visible to every row and tile 0 comes first, so m_new is
      // finite from the first tile on
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float corr = expf(m[i] - m_new);  // exp(-inf) = 0 on the first tile
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - m_new);
        Ps[(ty + 16 * i) * (kTile + 1) + tx + 16 * j] = p;
        psum += p;
      }
      l[i] = l[i] * corr + row_sum16(psum);
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) o[i][jj] *= corr;
    }
    __syncthreads();

    for (int kk = 0; kk < kTile; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * (kTile + 1) + kk];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const float vv = Vs[kk * HD + tx + 16 * jj];
#pragma unroll
        for (int i = 0; i < 4; ++i) o[i][jj] = fmaf(pv[i], vv, o[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= S) continue;
    const float inv = 1.f / l[i];
    float* orow = out + b * o_sb + row * o_ss + (long long)h * HD;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) orow[tx + 16 * jj] = o[i][jj] * inv;
    if (lse != nullptr && tx == 0) lse[((long long)b * H + h) * S + row] = m[i] + logf(l[i]);
  }
}

template <int HD>
int launch_simt(const void* q, const void* k, const void* v, void* out, float* lse, int B, int S,
                int H, int KV, long long q_sb, long long q_ss, long long k_sb, long long k_ss,
                long long k_sh, long long v_sb, long long v_ss, long long v_sh, long long o_sb,
                long long o_ss, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (kTile * (HD + 1) + HD * (kTile + 1) + kTile * HD + kTile * (kTile + 1));
  cudaError_t err = cudaFuncSetAttribute(attn_fwd_simt<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kTile - 1) / kTile, H, B);
  attn_fwd_simt<HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), lse, S, H, KV, q_sb, q_ss, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
      o_sb, o_ss, 1.0f / sqrtf((float)HD));
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

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch
// (0 on success); -1 for a dtype or head dim the kernel was not built for.
extern "C" int edgellm_attn_fwd(const void* q, const void* k, const void* v, void* out,
                                float* lse, int B, int S, int H, int KV, int hd, int dtype,
                                long long q_sb, long long q_ss, long long k_sb, long long k_ss,
                                long long k_sh, long long v_sb, long long v_ss, long long v_sh,
                                long long o_sb, long long o_ss, void* stream) {
  using namespace edgellm;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define EDGELLM_FWD(FN, HD)                                                                   \
  return FN<HD>(q, k, v, out, lse, B, S, H, KV, q_sb, q_ss, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, \
                o_sb, o_ss, st)
  if (dtype == 0 && hd == 64) EDGELLM_FWD(launch_simt, 64);
  if (dtype == 0 && hd == 128) EDGELLM_FWD(launch_simt, 128);
  if (dtype == 1 && hd == 64) EDGELLM_FWD(launch_wgmma, 64);
  if (dtype == 1 && hd == 128) EDGELLM_FWD(launch_wgmma, 128);
#undef EDGELLM_FWD
  return -1;
}

extern "C" const char* edgellm_attn_fwd_error(int code) {
  return code < 0 ? "unsupported dtype or head dim" : cudaGetErrorString((cudaError_t)code);
}
