// K8: the fused int8_per_token boundary hop on one card: quantize, seal and
// write the wire buffer, then receive, verify and dequantize, in one launch.
//
// Replaces the TPU kernel _remote_hop_kernel of
// edgellm_tpu/codecs/pallas_kernels.py (behind fused_remote_hop). There, one
// kernel quantizes each token tile in VMEM, remote-DMAs it to the right
// neighbour chip double-buffered, accumulates the wire checksum in SMEM
// across the sequential grid, and ends by shipping the 8-byte head
// [canary, crc] and verifying it. Here the source and destination stages
// share one card, so the kernel computes what that kernel computes without
// its DMA ring: the destination is the flat wire buffer itself.
//
// Wire buffer (codecs/wire_format.py, the sealed int8_per_token tree, leaves
// in sorted-key order, little-endian):
//
//   [canary u32][crc u32][mn f32 x N][q i8 x N*D][scale f32 x N]
//
// crc is the weighted byte sum of wire_format._leaf_crc: byte k of leaf j
// weighs (2 * (k + j * 0x9E3779B1) + 1) * 2654435761, all mod 2^32.
//
// - One block per token row. The row is read once into shared memory and
//   quantized with K3's math (int8_affine_codec.cu); the block writes q,
//   mn and scale straight to their wire offsets and sums its bytes'
//   checksum terms.
// - Receive: after a __syncthreads() the block reads its row back from the
//   buffer (the arrived bytes), sums their checksum terms again and
//   dequantizes them with K4's math into the output.
// - Addition mod 2^32 is order-free, so each block adds its two partial sums
//   into two device accumulators with atomicAdd and the totals are
//   deterministic. The last block to finish (a ticket counter after a
//   __threadfence()) writes the head [canary, sent crc], reads it back, and
//   sets the verify flag: canary intact and the stored crc equal to the crc
//   of the arrived bytes.
//
// edgellm_remote_hop_receive runs the receive half alone over a buffer that
// has already arrived (the path a corrupted buffer takes in the checks).
//
// Bound on this card: device memory. The hop reads 4 N D bytes and writes
// N D + 8 N + 8 (the buffer) and 4 N D (the output): 33 MB at Qwen2-0.5B's
// split shape (N = 4096, D = 896), 9.9 us at 3.35 TB/s.
#include "codec_common.cuh"

namespace edgellm {

constexpr uint32_t kCanary = 0x5EA1C0DEu;
constexpr uint32_t kCrcMult = 2654435761u;
// per-leaf salts j * 0x9E3779B1 mod 2^32 in the payload's sorted-key order
constexpr uint32_t kSaltMn = 0u, kSaltQ = 0x9E3779B1u, kSaltScale = 0x3C6EF362u;

struct Wire {
  long long n;
  int d;
  __device__ long long mn(long long r) const { return 8 + 4 * r; }
  __device__ long long q(long long r) const { return 8 + 4 * n + r * d; }
  __device__ long long scale(long long r) const { return 8 + 4 * n + n * d + 4 * r; }
};

__device__ __forceinline__ uint32_t crc_weight(uint32_t pos) { return (2u * pos + 1u) * kCrcMult; }

// checksum terms of the 4 bytes of element `row` of a float32 leaf
__device__ __forceinline__ uint32_t crc_f32(float v, long long row, uint32_t salt) {
  const uint32_t u = __float_as_uint(v);
  uint32_t crc = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    crc += ((u >> (8 * k)) & 0xFFu) * crc_weight((uint32_t)(4 * row + k) + salt);
  return crc;
}

__device__ __forceinline__ void store_u32(uint8_t* p, uint32_t u) {
#pragma unroll
  for (int k = 0; k < 4; ++k) p[k] = (uint8_t)(u >> (8 * k));
}

__device__ __forceinline__ uint32_t load_u32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24);
}

// Sum one value per thread over the block, mod 2^32; every thread gets it.
__device__ __forceinline__ uint32_t block_sum(uint32_t v, uint32_t* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < kCodecThreads / 32 ? red[lane] : 0u;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Receive row r of an arrived buffer: K4's dequantize into out, and the
// checksum terms of the row's bytes (this thread's share).
__device__ uint32_t receive_row(const uint8_t* buf, float* __restrict__ out, Wire w,
                                long long r) {
  const float m = __uint_as_float(load_u32(buf + w.mn(r)));
  const float sc = __uint_as_float(load_u32(buf + w.scale(r)));
  const float safe = sc > 0.f ? sc : 1.f;
  const float zp = zero_point(m, safe);
  const uint8_t* qr = buf + w.q(r);
  float* o = out + r * w.d;
  uint32_t crc = 0;
  for (int i = threadIdx.x; i < w.d; i += kCodecThreads) {
    const uint8_t b = qr[i];
    crc += (uint32_t)b * crc_weight((uint32_t)(r * w.d + i) + kSaltQ);
    const float deq = __fmul_rn(__fsub_rn((float)(int8_t)b, zp), safe);
    o[i] = sc > 0.f ? deq : m;
  }
  if (threadIdx.x == 0) crc += crc_f32(m, r, kSaltMn) + crc_f32(sc, r, kSaltScale);
  return crc;
}

// acc[0]: crc of the sent bytes, acc[1]: crc of the arrived bytes, acc[2]:
// blocks finished. The last block writes the head (when sending) and
// verifies it against the arrived crc.
__device__ void finish(uint8_t* buf, int* ok, uint32_t* acc, uint32_t sent, uint32_t got,
                       bool send) {
  __shared__ bool last;
  if (threadIdx.x == 0) {
    if (send) atomicAdd(&acc[0], sent);
    atomicAdd(&acc[1], got);
    __threadfence();
    last = atomicAdd(&acc[2], 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (last && threadIdx.x == 0) {
    __threadfence();
    if (send) {
      store_u32(buf, kCanary);
      store_u32(buf + 4, atomicAdd(&acc[0], 0u));
    }
    *ok = load_u32(buf) == kCanary && load_u32(buf + 4) == atomicAdd(&acc[1], 0u);
  }
}

__global__ void __launch_bounds__(kCodecThreads)
remote_hop_kernel(const float* __restrict__ x, uint8_t* buf, float* __restrict__ out,
                  int* ok, uint32_t* acc, long long n, int D) {
  extern __shared__ float row[];  // D floats
  __shared__ float red[kCodecThreads / 32];
  __shared__ uint32_t ured[kCodecThreads / 32];
  const Wire w{n, D};
  const long long r = blockIdx.x;
  // send: K3's per-row affine int8, written at the wire offsets
  const float* xr = x + r * D;
  float mn = INFINITY, mx = -INFINITY;
  for (int i = threadIdx.x; i < D; i += kCodecThreads) {
    const float v = xr[i];
    row[i] = v;
    mn = fminf(mn, v);
    mx = fmaxf(mx, v);
  }
  mn = block_reduce(mn, red, INFINITY, MinOp());
  mx = block_reduce(mx, red, -INFINITY, MaxOp());
  const float sc = __fmul_rn(__fsub_rn(mx, mn), kInv255);
  const float safe = sc > 0.f ? sc : 1.f;
  const float zp = zero_point(mn, safe);
  uint8_t* qr = buf + w.q(r);
  uint32_t crc = 0;
  for (int i = threadIdx.x; i < D; i += kCodecThreads) {
    float v = __fadd_rn(rintf(__fdiv_rn(row[i], safe)), zp);
    v = fminf(fmaxf(v, -128.f), 127.f);
    const uint8_t b = (uint8_t)(int8_t)(int)v;
    qr[i] = b;
    crc += (uint32_t)b * crc_weight((uint32_t)(r * D + i) + kSaltQ);
  }
  if (threadIdx.x == 0) {
    store_u32(buf + w.mn(r), __float_as_uint(mn));
    store_u32(buf + w.scale(r), __float_as_uint(sc));
    crc += crc_f32(mn, r, kSaltMn) + crc_f32(sc, r, kSaltScale);
  }
  const uint32_t sent = block_sum(crc, ured);
  // receive: the row's bytes are now visible to the whole block
  __syncthreads();
  const uint32_t got = block_sum(receive_row(buf, out, w, r), ured);
  finish(buf, ok, acc, sent, got, true);
}

__global__ void __launch_bounds__(kCodecThreads)
remote_hop_receive_kernel(const uint8_t* buf, float* __restrict__ out, int* ok, uint32_t* acc,
                          long long n, int D) {
  __shared__ uint32_t ured[kCodecThreads / 32];
  const Wire w{n, D};
  const uint32_t got = block_sum(receive_row(buf, out, w, blockIdx.x), ured);
  finish(const_cast<uint8_t*>(buf), ok, acc, 0u, got, false);
}

}  // namespace edgellm

// x (N, D) float32 -> buf (8 + 8 N + N D) uint8, out (N, D) float32, ok (1,)
// int32. acc is 3 uint32 of scratch, cleared here on `stream`. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int edgellm_remote_hop(const float* x, uint8_t* buf, float* out, int* ok,
                                  uint32_t* acc, long long n, int d, void* stream) {
  using namespace edgellm;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(acc, 0, 3 * sizeof(uint32_t), s);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(float) * (size_t)d;
  err = allow_row_smem(remote_hop_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  remote_hop_kernel<<<(unsigned)n, kCodecThreads, smem, s>>>(x, buf, out, ok, acc, n, d);
  return (int)cudaGetLastError();
}

// An arrived buffer -> out (N, D) float32 and ok (1,) int32.
extern "C" int edgellm_remote_hop_receive(const uint8_t* buf, float* out, int* ok,
                                          uint32_t* acc, long long n, int d, void* stream) {
  using namespace edgellm;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(acc, 0, 3 * sizeof(uint32_t), s);
  if (err != cudaSuccess) return (int)err;
  remote_hop_receive_kernel<<<(unsigned)n, kCodecThreads, 0, s>>>(buf, out, ok, acc, n, d);
  return (int)cudaGetLastError();
}

extern "C" const char* edgellm_remote_hop_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
