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
// work is ~S/4 FLOPs per byte moved, far below the ~295 FLOP/byte ridge, so
// the roofline bound is the bytes of q, K, V and the output; this first
// version multiplies with fp32 FMA from shared memory (no tensor cores) and is
// bound by shared-memory bandwidth and FMA issue long before that. bf16 inputs
// are widened to fp32 in shared memory, the fp32 path stays full fp32 (no
// TF32), and the output is rounded once to the input type.
//
// With a non-null lse pointer it also writes the per-row log-sum-exp
// (B, H, S) fp32: the first pass of the stats kernel (attention_stats.cu).
#include "attention_common.cuh"

namespace edgellm {

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                T* __restrict__ out, float* __restrict__ lse, int S, int H, int KV,
                long long q_sb, long long q_ss, long long k_sb, long long k_ss, long long k_sh,
                long long v_sb, long long v_ss, long long v_sh, long long o_sb, long long o_ss,
                float scale) {
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

  const T* qh = q + b * q_sb + (long long)h * HD;
  const T* kh = k + b * k_sb + g * k_sh;
  const T* vh = v + b * v_sb + g * v_sh;
  load_rows<T, HD>(Qs, HD + 1, qh, q_ss, row0, S);

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
    load_rows_t<T, HD>(Kt, kTile + 1, kh, k_ss, key0, S);
    load_rows<T, HD>(Vs, HD, vh, v_ss, key0, S);
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
    T* orow = out + b * o_sb + row * o_ss + (long long)h * HD;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) orow[tx + 16 * jj] = from_float<T>(o[i][jj] * inv);
    if (lse != nullptr && tx == 0) lse[((long long)b * H + h) * S + row] = m[i] + logf(l[i]);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, int B, int S,
           int H, int KV, long long q_sb, long long q_ss, long long k_sb, long long k_ss,
           long long k_sh, long long v_sb, long long v_ss, long long v_sh, long long o_sb,
           long long o_ss, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (kTile * (HD + 1) + HD * (kTile + 1) + kTile * HD + kTile * (kTile + 1));
  cudaError_t err = cudaFuncSetAttribute(attn_fwd_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kTile - 1) / kTile, H, B);
  attn_fwd_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, S, H, KV, q_sb, q_ss, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb,
      o_ss, 1.0f / sqrtf((float)HD));
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
#define EDGELLM_FWD(T, HD)                                                                     \
  return launch<T, HD>(q, k, v, out, lse, B, S, H, KV, q_sb, q_ss, k_sb, k_ss, k_sh, v_sb,     \
                       v_ss, v_sh, o_sb, o_ss, st)
  if (dtype == 0 && hd == 64) EDGELLM_FWD(float, 64);
  if (dtype == 0 && hd == 128) EDGELLM_FWD(float, 128);
  if (dtype == 1 && hd == 64) EDGELLM_FWD(__nv_bfloat16, 64);
  if (dtype == 1 && hd == 128) EDGELLM_FWD(__nv_bfloat16, 128);
#undef EDGELLM_FWD
  return -1;
}

extern "C" const char* edgellm_attn_fwd_error(int code) {
  return code < 0 ? "unsupported dtype or head dim" : cudaGetErrorString((cudaError_t)code);
}
