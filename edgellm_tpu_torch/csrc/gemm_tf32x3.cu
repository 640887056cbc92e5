// The model's fp32 matrix products, C (M, N) = A (M, K) . B (K, N), as
// fp32-accurate 3xTF32 products on Hopper's tensor cores.
//
// Replaces no TPU kernel: the JAX package leaves these dots (q, k, v, o, the
// MLP's matrices and the LM head, edgellm_tpu/models/transformer.py) to XLA,
// and the port sent them to cuBLAS, whose fp32 GEMMs run on the CUDA cores
// (under 67 TFLOP/s on an H100 SXM). The arithmetic is the port's fp32 rule
// of K-attn and the K-stats column pass (hopper_common.cuh's split_tf32):
// every operand x is split as hi = tf32(x), lo = tf32(x - hi) (cvt.rna), and
// a.b = a_lo.b_hi + a_hi.b_lo + a_hi.b_hi in fp32 accumulators (a_lo.b_lo,
// 2^-22 relative, dropped). No plain TF32, no split-K, no atomics: two
// launches are bit for bit equal, and an output row does not depend on M.
//
// Bound on this card: at the model's shapes (M >= 4096 rows, K >= 896) the
// products are far above the ridge, so the bound is the operations: 3 TF32
// FLOPs a FLOP, 164.9 TFLOP/s on an H100 SXM. What the design does about it:
//
// - B never waits on a conversion. TF32 wgmma reads B K-major only, and the
//   weights are stored (in, out), N-major; they are constant within a run.
//   So each weight is split once, outside the product, into two planes
//   (hi, lo) of B^T (transformer.prepared_planes), laid out in global memory
//   exactly as a shared-memory stage holds them: for each 32-value chunk of
//   K, every row (an output column) as one 128-byte line with its 16-byte
//   pieces in the SWIZZLE_128B order of its row (piece c at c ^ (row % 8)).
//   A stage's B tile of each plane is then one bulk (TMA) copy of
//   consecutive rows, which wgmma reads through a descriptor.
// - A is split in registers. Its tile lands by a tensor-map TMA copy
//   (SWIZZLE_128B, zero-filled past M and K: one instruction a stage; a
//   warp of 16-byte cp.async could not keep up, and fed the tensor cores at
//   half their rate on an H100); the values are split into (hi, lo) as they
//   leave shared memory and feed the register (RS) form of wgmma. A thread
//   reads four consecutive K values of a row at once, the 16-byte piece
//   2 t + g of its rows (t = lane % 4, g the half of the stage), so that the
//   two rows an 8-lane phase reads fall on disjoint banks; the four values
//   fill the fragment's columns (t, t + 4) of k8 steps 2g and 2g + 1, so
//   the reduction order inside each stage's 32 values is permuted, the same
//   way in the planes (gemm.py, PLANE_ORDER).
// - One fresh accumulator a stage. A warpgroup sums a stage's 32 values of K
//   (the small terms first, then hi.hi) in a wgmma accumulator started at
//   zero, waits for it and adds it into its fp32 sum on the CUDA cores, as
//   fp32 K-attn's PV does: the tensor cores add with truncation, which over
//   thousands of adds into one large accumulator would cost more than the
//   3xTF32 split gains; rounded adds of 32-value partial sums keep the error
//   at fp32's. The wait costs nothing while the other warpgroup's products
//   run: two consumer warpgroups of 64 rows take turns on the tensor cores.
// - A ring of 4 stages (48 KB each: A, B hi, B lo) fed by one thread of a
//   producer warp, and a persistent grid: each block walks output tiles of
//   128 x 128 in a grouped order (8 row tiles a group, so the blocks in
//   flight share their B tiles in L2), and the producer fills the next
//   tile's stages while the consumers store the last one's. Registers cap
//   the tile: a consumer thread holds the stage's accumulator and the
//   tile's sum (64 each) and 32 split A values, 168 registers at most for
//   a block of 288 threads (ptxas reads 168 and spills 52 bytes).
//
// A plane may hold more rows than the product's N: the product's columns
// are rows n0 .. n0 + N - 1 of it (a vocab block of the tied head is a row
// range of the embedding's planes). Tiles start at row n0 rounded down to 8,
// so that a tile's rows keep their swizzle phase; columns outside the
// product are computed and not stored.
//
// The grouped form (gemm_tf32x3_grouped_kernel) runs a sparse-expert layer's
// products over the experts it holds in one launch: A the routed rows in
// expert order, each expert's B its own planes, the per-expert row offsets
// read on the device by a tile scheduler, so that neither the routing nor
// the grid waits on the host and an expert with no rows costs no tile. Its
// gate / up instance (kGlu) takes planes whose 128-column tiles each hold 64
// features' gate and then their up columns (gemm.py, prepare_grouped_planes
// with glu), and stores silu(gate) * up (M, F) from the registers: the
// (M, 2F) product never reaches device memory.
#include <cuda.h>  // CUtensorMap (the encoder is reached through the runtime)

#include "hopper_common.cuh"

namespace edgellm {

namespace tf32x3 {
constexpr int kBM = 128;               // output rows a tile: two warpgroups of 64
constexpr int kBN = 128;               // output columns a tile (plane rows)
constexpr int kBK = 32;                // K values a stage: one 128-byte line a row
constexpr int kStages = 4;
constexpr int kThreads = 2 * 128 + 32;  // two consumer warpgroups, one producer warp
constexpr int kATile = kBM * kBK * 4;   // bytes of one A tile
constexpr int kBTile = kBN * kBK * 4;   // one plane's B tile
constexpr int kStageBytes = kATile + 2 * kBTile;
constexpr int kSmem = kStages * kStageBytes + 1024;  // + alignment
constexpr int kGroupM = 8;                           // row tiles a raster group
constexpr int kMaxExperts = 256;                     // experts a grouped launch holds
}  // namespace tf32x3

// TMA: the box at (x, y) of a 2-D tensor map into shared memory, counted on
// bar's transaction count (elements outside the tensor read as zero)
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int x, int y,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar)
      : "memory");
}

__device__ __forceinline__ float4 lds128(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// D[64 x 128] (+)= A[64 x 8] . B[128 x 8]^T in TF32: A in registers (rows r,
// r + 8 of columns t, then of t + 4), B K-major in shared memory; scale_d 0
// overwrites D.
__device__ __forceinline__ void wgmma_tf32_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                                   uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d)
      : "memory");
}

// Four values of the fragment (rows r, r + 8 of columns t, then of t + 4)
// into their TF32 hi and lo parts.
__device__ __forceinline__ void split_frag(float a0, float a1, float a2, float a3,
                                           uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const float v[4] = {a0, a1, a2, a3};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = split_tf32(v[i]);
    hi[i] = __float_as_uint(x.x);
    lo[i] = __float_as_uint(x.y);
  }
}

// One stage's 32 K values for a consumer thread (rows r, r + 8 of its
// warpgroup's 64): A split into TF32 (hi, lo) as it leaves shared memory,
// the small terms and then hi.hi into a fresh accumulator, which is added
// into the tile's fp32 sum once the stage is released to the producer.
__device__ __forceinline__ void consume_stage(uint32_t st, uint32_t a_off, uint32_t swz, int t4,
                                              int lane, uint32_t bar_empty_s, float (&acc)[64],
                                              float (&sum)[64]) {
  __syncwarp();  // wgmma is .aligned: the warp leaves the spin together
  uint32_t hi[4][4], lo[4][4];
#pragma unroll
  for (int g = 0; g < 2; ++g) {  // piece 2 t4 + g of rows r, r + 8
    const uint32_t q = ((2 * t4 + g) ^ swz) << 4;
    const float4 x = lds128(st + a_off + q), y = lds128(st + a_off + 8 * 128 + q);
    split_frag(x.x, y.x, x.y, y.y, hi[2 * g], lo[2 * g]);
    split_frag(x.z, y.z, x.w, y.w, hi[2 * g + 1], lo[2 * g + 1]);
  }
  const uint32_t b_hi = st + tf32x3::kATile, b_lo = b_hi + tf32x3::kBTile;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {  // the small terms, into a fresh accumulator
    wgmma_tf32_rs_n128(acc, lo[kk], sw128_desc(b_hi + kk * 32, 16, 1024), kk > 0);
    wgmma_tf32_rs_n128(acc, hi[kk], sw128_desc(b_lo + kk * 32, 16, 1024), 1);
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)  // then hi.hi
    wgmma_tf32_rs_n128(acc, hi[kk], sw128_desc(b_hi + kk * 32, 16, 1024), 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
  __syncwarp();
  if (lane == 0) mbar_arrive(bar_empty_s);
#pragma unroll
  for (int i = 0; i < 64; ++i) sum[i] += acc[i];  // rounded, not truncated
}

// A consumer thread's part of a finished tile: rows row0 and row0 + 8 where
// below row_end, the columns col0 + 8 j + 2 t4 (+ 1) that lie in [0, N).
__device__ __forceinline__ void store_tile(float* __restrict__ c, const float (&sum)[64],
                                           int row0, int row_end, int col0, int N,
                                           long long ldc, int t4, int vec2) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = col0 + 8 * j + 2 * t4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= row_end) continue;
      float* out = c + static_cast<size_t>(row) * ldc + col;
      const float v0 = sum[4 * j + 2 * h], v1 = sum[4 * j + 2 * h + 1];
      if (vec2 && col >= 0 && col + 1 < N) {
        *reinterpret_cast<float2*>(out) = make_float2(v0, v1);
      } else {
        if (col >= 0 && col < N) out[0] = v0;
        if (col + 1 >= 0 && col + 1 < N) out[1] = v1;
      }
    }
  }
}

// silu(g) * u in fp32 as F.silu and the multiply compute it: g / (1 + e^-g)
// with IEEE expf and division (no fast math), rounded, then times u.
__device__ __forceinline__ float silu_mul(float g, float u) {
  const float s = g / (1.0f + expf(-g));
  return s * u;
}

// A consumer thread's part of a finished gate / up tile of gate-up
// interleaved planes: the tile's plane columns 0..63 are the gate of
// features col0 .. col0 + 63 and columns 64..127 their up, so the thread holds
// the gate of feature col0 + 8 j + 2 t4 (+ 1) in sum[4 j + 2 h (+ 1)], j < 8,
// and its up in j + 8. Stores silu(gate) * up at rows row0 and row0 + 8 where
// below row_end, features below F.
__device__ __forceinline__ void store_tile_glu(float* __restrict__ c, const float (&sum)[64],
                                               int row0, int row_end, int col0, int F,
                                               long long ldc, int t4, int vec2) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = col0 + 8 * j + 2 * t4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= row_end) continue;
      float* out = c + static_cast<size_t>(row) * ldc + col;
      const float v0 = silu_mul(sum[4 * j + 2 * h], sum[4 * (j + 8) + 2 * h]);
      const float v1 = silu_mul(sum[4 * j + 2 * h + 1], sum[4 * (j + 8) + 2 * h + 1]);
      if (vec2 && col + 1 < F) {
        *reinterpret_cast<float2*>(out) = make_float2(v0, v1);
      } else {
        if (col < F) out[0] = v0;
        if (col + 1 < F) out[1] = v1;
      }
    }
  }
}

struct TileMap {
  int tiles_m, tiles_n, p_start;
  __device__ __forceinline__ void at(int tile, int& m0, int& p0) const {
    using namespace tf32x3;
    const int per_group = kGroupM * tiles_n;
    const int group = tile / per_group, first_m = group * kGroupM;
    const int gm = min(kGroupM, tiles_m - first_m);
    const int in_group = tile - group * per_group;
    m0 = (first_m + in_group % gm) * kBM;
    p0 = p_start + (in_group / gm) * kBN;
  }
};

// C = A . B for A (M, K) row-major behind the tensor map tmap_a (boxes of
// 32 x 128), B as the planes bhi / blo ((K + 31) / 32 chunks of R rows of 32
// values), the product's columns being plane rows n0 .. n0 + N - 1; C (M, N)
// row-major (row stride ldc).
__global__ void __launch_bounds__(tf32x3::kThreads, 1)
gemm_tf32x3_kernel(const __grid_constant__ CUtensorMap tmap_a, const float* __restrict__ bhi,
                   const float* __restrict__ blo, float* __restrict__ c, int M, int N, int K,
                   long long ldc, int R, int n0, TileMap map, int vec2) {
  using namespace tf32x3;
  extern __shared__ unsigned char smem_gemm[];
  __shared__ __align__(8) uint64_t bars[2 * kStages];  // full[], empty[]
  const uint32_t base = (smem_u32(smem_gemm) + 1023u) & ~1023u;
  const uint32_t bar_full = smem_u32(&bars[0]), bar_empty = smem_u32(&bars[kStages]);
  const int kc_n = (K + kBK - 1) / kBK;
  const int n_tiles = map.tiles_m * map.tiles_n;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);   // the producer's expect_tx
      mbar_init(bar_empty + 8 * s, 8);  // one arrival a consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 8) {  // the producer: one thread issues a stage's three copies
    if (lane != 0) return;
    int it = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      int m0, p0;
      map.at(tile, m0, p0);
      const uint32_t b_bytes = static_cast<uint32_t>(min(kBN, R - p0)) * 128u;
      for (int kc = 0; kc < kc_n; ++kc, ++it) {
        const int s = it % kStages;
        mbar_wait(bar_empty + 8 * s, ((it / kStages) & 1) ^ 1);
        const uint32_t st = base + s * kStageBytes;
        const size_t off = (static_cast<size_t>(kc) * R + p0) * kBK;
        mbar_arrive_expect_tx(bar_full + 8 * s, kATile + 2 * b_bytes);
        tma_load_2d(st, &tmap_a, kc * kBK, m0, bar_full + 8 * s);
        bulk_copy_g2s(st + kATile, bhi + off, b_bytes, bar_full + 8 * s);
        bulk_copy_g2s(st + kATile + kBTile, blo + off, b_bytes, bar_full + 8 * s);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of a tile; this
  // thread rows r and r + 8 of them, accumulator columns 8j + 2 t4 + e
  const int wg = warp / 4, w = warp % 4, t4 = lane % 4;
  const int r = wg * 64 + w * 16 + lane / 4;
  const uint32_t a_off = r * 128, swz = r & 7;  // rows r and r + 8 share the phase
  float acc[64], sum[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  int it = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    int m0, p0;
    map.at(tile, m0, p0);
#pragma unroll
    for (int i = 0; i < 64; ++i) sum[i] = 0.f;
    for (int kc = 0; kc < kc_n; ++kc, ++it) {
      const int s = it % kStages;
      mbar_wait(bar_full + 8 * s, (it / kStages) & 1);
      consume_stage(base + s * kStageBytes, a_off, swz, t4, lane, bar_empty + 8 * s, acc, sum);
    }
    // the tile's rows below M and columns inside the product
    store_tile(c, sum, m0 + r, M, p0 - n0, N, ldc, t4, vec2);
  }
}

// The persistent grouped form over the experts a layer holds: expert e's
// rows of A are offsets[e] .. offsets[e + 1] - 1 (A the routed rows in
// expert order), its B the planes bhi / blo + e * plane_stride, its C rows
// the same rows of c. The offsets are read here, on the device: each block
// sums the experts' tiles (an expert of m rows has ceil(m / 128) row tiles
// of N / 128 column tiles; none if it has no rows) and walks the tiles
// blockIdx.x, + gridDim.x, ... of the sum, so that the grid is the card's
// SM count whatever the routing, and the host never reads a row count. A
// tile's last rows may belong to the next expert: they are computed and not
// stored. The stage work and the ring are the dense kernel's, and so is the
// store, but for kGlu: N is then the planes' interleaved columns and the
// tile at plane column p0 stores features p0 / 2 .. p0 / 2 + 63 of the
// (M, n_out) silu(gate) * up (store_tile_glu).
template <bool kGlu>
__global__ void __launch_bounds__(tf32x3::kThreads, 1)
gemm_tf32x3_grouped_kernel(const __grid_constant__ CUtensorMap tmap_a,
                           const float* __restrict__ bhi, const float* __restrict__ blo,
                           float* __restrict__ c, int N, int n_out, int K, long long ldc,
                           int R, long long plane_stride, const int* __restrict__ offsets,
                           int experts, int vec2) {
  using namespace tf32x3;
  extern __shared__ unsigned char smem_gemm[];
  __shared__ __align__(8) uint64_t bars[2 * kStages];  // full[], empty[]
  __shared__ int s_off[kMaxExperts + 1], s_tiles[kMaxExperts + 1];
  const uint32_t base = (smem_u32(smem_gemm) + 1023u) & ~1023u;
  const uint32_t bar_full = smem_u32(&bars[0]), bar_empty = smem_u32(&bars[kStages]);
  const int kc_n = (K + kBK - 1) / kBK;
  const int tiles_n = (N + kBN - 1) / kBN;

  for (int e = threadIdx.x; e <= experts; e += blockDim.x) s_off[e] = offsets[e];
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 8);
    }
    mbar_init_fence();
    s_tiles[0] = 0;
    for (int e = 0; e < experts; ++e)
      s_tiles[e + 1] = s_tiles[e] + (s_off[e + 1] - s_off[e] + kBM - 1) / kBM * tiles_n;
  }
  __syncthreads();
  const int n_tiles = s_tiles[experts];
  // tile -> (expert, first row, first column, end of the expert's rows); the
  // tiles a block takes rise, so the expert search resumes where it stopped
  int e = 0;
  auto at = [&](int tile, int& m0, int& p0, int& row_end) {
    while (tile >= s_tiles[e + 1]) ++e;
    const int in_e = tile - s_tiles[e];
    const int tiles_m = (s_off[e + 1] - s_off[e] + kBM - 1) / kBM;
    const int per_group = kGroupM * tiles_n;
    const int group = in_e / per_group, first_m = group * kGroupM;
    const int gm = min(kGroupM, tiles_m - first_m);
    const int in_group = in_e - group * per_group;
    m0 = s_off[e] + (first_m + in_group % gm) * kBM;
    p0 = (in_group / gm) * kBN;
    row_end = s_off[e + 1];
  };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 8) {
    if (lane != 0) return;
    int it = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      int m0, p0, row_end;
      at(tile, m0, p0, row_end);
      const uint32_t b_bytes = static_cast<uint32_t>(min(kBN, R - p0)) * 128u;
      const size_t plane = static_cast<size_t>(e) * plane_stride;
      for (int kc = 0; kc < kc_n; ++kc, ++it) {
        const int s = it % kStages;
        mbar_wait(bar_empty + 8 * s, ((it / kStages) & 1) ^ 1);
        const uint32_t st = base + s * kStageBytes;
        const size_t off = plane + (static_cast<size_t>(kc) * R + p0) * kBK;
        mbar_arrive_expect_tx(bar_full + 8 * s, kATile + 2 * b_bytes);
        tma_load_2d(st, &tmap_a, kc * kBK, m0, bar_full + 8 * s);
        bulk_copy_g2s(st + kATile, bhi + off, b_bytes, bar_full + 8 * s);
        bulk_copy_g2s(st + kATile + kBTile, blo + off, b_bytes, bar_full + 8 * s);
      }
    }
    return;
  }

  const int wg = warp / 4, w = warp % 4, t4 = lane % 4;
  const int r = wg * 64 + w * 16 + lane / 4;
  const uint32_t a_off = r * 128, swz = r & 7;
  float acc[64], sum[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  int it = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    int m0, p0, row_end;
    at(tile, m0, p0, row_end);
#pragma unroll
    for (int i = 0; i < 64; ++i) sum[i] = 0.f;
    for (int kc = 0; kc < kc_n; ++kc, ++it) {
      const int s = it % kStages;
      mbar_wait(bar_full + 8 * s, (it / kStages) & 1);
      consume_stage(base + s * kStageBytes, a_off, swz, t4, lane, bar_empty + 8 * s, acc, sum);
    }
    if constexpr (kGlu)
      store_tile_glu(c, sum, m0 + r, row_end, p0 / 2, n_out, ldc, t4, vec2);
    else
      store_tile(c, sum, m0 + r, row_end, p0, N, ldc, t4, vec2);
  }
}

}  // namespace edgellm

// cuTensorMapEncodeTiled, reached through the runtime (no link to libcuda)
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A's tensor map: (M, K) fp32 rows of stride lda, boxes of 32 x 128,
// SWIZZLE_128B, zero-filled past M and K. False if it could not be made.
static bool a_tensor_map(CUtensorMap* tmap, const float* a, int M, int K, long long lda) {
  using namespace edgellm::tf32x3;
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(M)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(lda) * 4};
  const cuuint32_t box[2] = {kBK, kBM}, unit[2] = {1, 1};
  return encode(tmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(a), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// C = A . B (see the kernel). a: (M, K) fp32 rows of stride lda; bhi / blo:
// the planes, (K + 31) / 32 chunks of R rows; c: (M, N), rows of stride ldc;
// the product's columns are plane rows n0 .. n0 + N - 1; sms: the grid's
// bound (the card's SM count). a, bhi, blo 16-byte aligned, K and lda
// multiples of 4, 0 <= n0, n0 + N <= R. Returns the cudaError_t of the
// launch (0 on success), -1 for arguments the kernel does not take, -2 if
// A's tensor map could not be made.
extern "C" int edgellm_gemm_tf32x3(const float* a, const float* bhi, const float* blo, float* c,
                                   int M, int N, int K, long long lda, long long ldc, int R,
                                   int n0, int sms, void* stream) {
  using namespace edgellm;
  using namespace edgellm::tf32x3;
  if (M <= 0 || N <= 0 || K <= 0 || K % 4 || lda % 4 || lda < K || n0 < 0 || n0 + N > R ||
      sms <= 0 ||
      (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(bhi) |
       reinterpret_cast<uintptr_t>(blo)) % 16)
    return -1;
  TileMap map;
  map.p_start = n0 & ~7;
  map.tiles_m = (M + kBM - 1) / kBM;
  map.tiles_n = (n0 - map.p_start + N + kBN - 1) / kBN;
  const long long n_tiles = static_cast<long long>(map.tiles_m) * map.tiles_n;
  if (n_tiles > 0x7fffffff) return -1;
  CUtensorMap tmap_a;
  if (!a_tensor_map(&tmap_a, a, M, K, lda)) return -2;
  const int vec2 = ldc % 2 == 0 && n0 % 2 == 0 && reinterpret_cast<uintptr_t>(c) % 8 == 0;
  cudaError_t err = cudaFuncSetAttribute(gemm_tf32x3_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  const int grid = static_cast<int>(n_tiles < sms ? n_tiles : sms);
  gemm_tf32x3_kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      tmap_a, bhi, blo, c, M, N, K, ldc, R, n0, map, vec2);
  return (int)cudaGetLastError();
}

// The grouped product (see gemm_tf32x3_grouped_kernel). a: (M, K) fp32, the
// routed rows in expert order, rows of stride lda; bhi / blo: each expert's
// planes, (K + 31) / 32 chunks of R rows, plane_stride floats apart; c: (M,
// N) rows of stride ldc, written only at the experts' rows; offsets: experts
// + 1 device ints, non-decreasing, in [0, M]. With glu the planes hold each
// 64 features' gate and up columns side by side (2 ceil(N / 64) 64 rows at
// least) and c receives silu(gate) * up, N features a row. The grid is the SM
// count. The same return codes as edgellm_gemm_tf32x3.
extern "C" int edgellm_gemm_tf32x3_grouped(const float* a, const float* bhi, const float* blo,
                                           float* c, int M, int N, int K, long long lda,
                                           long long ldc, int R, long long plane_stride,
                                           const int* offsets, int experts, int glu, int sms,
                                           void* stream) {
  using namespace edgellm;
  using namespace edgellm::tf32x3;
  const int cols = glu ? 2 * ((N + kBN / 2 - 1) / (kBN / 2)) * (kBN / 2) : N;
  if (M <= 0 || N <= 0 || K <= 0 || K % 4 || lda % 4 || lda < K || cols > R || sms <= 0 ||
      experts <= 0 || experts > kMaxExperts || plane_stride % 4 ||
      (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(bhi) |
       reinterpret_cast<uintptr_t>(blo)) % 16)
    return -1;
  CUtensorMap tmap_a;
  if (!a_tensor_map(&tmap_a, a, M, K, lda)) return -2;
  const int vec2 = ldc % 2 == 0 && reinterpret_cast<uintptr_t>(c) % 8 == 0;
  auto kernel = glu ? gemm_tf32x3_grouped_kernel<true> : gemm_tf32x3_grouped_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSmem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<sms, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      tmap_a, bhi, blo, c, cols, N, K, ldc, R, plane_stride, offsets, experts, vec2);
  return (int)cudaGetLastError();
}

extern "C" const char* edgellm_gemm_tf32x3_error(int code) {
  if (code == -2) return "A's tensor map could not be made (cuTensorMapEncodeTiled)";
  return code < 0 ? "arguments the kernel does not take" : cudaGetErrorString((cudaError_t)code);
}
