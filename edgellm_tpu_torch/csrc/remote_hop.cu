// K8: the fused int8_per_token boundary hop on one card: saturate, quantize,
// seal and write the wire buffer, then receive, verify and dequantize, in
// one launch.
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
// crc is the weighted byte sum of wire_format._leaf_crc: byte p of leaf j
// weighs (2 * (p + j * 0x9E3779B1) + 1) * M, M = 2654435761, all mod 2^32.
//
// - One warp a row, 4 rows a block: K3's body (int8_row_codec.cuh). The row
//   of the hidden, float32, bf16 or fp16 as the model holds it, is read once
//   in 16-byte vectors and kept in registers, saturated there as
//   sanitize_hidden does (clamp to the bound the hidden's dtype rounds
//   max_mag to, NaN -> 0) and quantized with K3's exact quotient; the codes
//   leave 4 or 8 bytes a store at their wire offsets. The q leaf starts at
//   byte 8 + 4N: 8-byte aligned for even N, only 4-byte aligned for odd N,
//   where a 16-bit row's 8 codes a vector leave as two 4-byte stores.
// - Checksum: M leaves the sum, and a word of 4 bytes at leaf position p
//   adds (2p + 1) (b0 + b1 + b2 + b3) + 2 (b1 + 2 b2 + 3 b3): two byte dot
//   products (dp4a) and one multiply where the weights took four. The sum
//   is exact mod 2^32, and order-free.
// - Receive: after the warp's stores, each lane reads its codes back from
//   the buffer (volatile loads from L2: the bytes that arrived, not the
//   registers), lane 0 the row's mn and scale for the warp, sums their
//   checksum and dequantizes them
//   with K4's math, rounding to the hidden's dtype (nearest even) in the
//   kernel, so the hop hands back the hidden's dtype with no cast after it.
// - A block adds its rows' two partial sums into two accumulators with
//   atomics (one thread; the block's other warps leave); the last block (a
//   ticket counter after a __threadfence()) takes
//   the totals, leaves the accumulators zeroed for the next launch on the
//   stream (no memset before a launch: the wrapper keeps one set a device
//   and stream), writes the head [canary, sent crc], reads it back, and sets
//   the verify flag: canary intact and the stored crc equal to the crc of
//   the arrived bytes.
//
// edgellm_remote_hop_receive runs the receive half alone over a buffer that
// has already arrived (the path a corrupted buffer takes in the checks).
// A row that is not whole 16-byte vectors, or wider than 32 vectors a lane,
// takes the scalar body: the same math a byte at a time.
//
// Bound on this card: device memory. The hop reads the hidden (4 N D bytes
// in float32, 2 N D in bf16 or fp16) and writes N D + 8 N + 8 (the buffer)
// and the decoded hidden in its dtype: at Qwen2-0.5B's split shape (N =
// 4096, D = 896) 33 MB in float32, 9.9 us at 3.35 TB/s.
#include "int8_row_codec.cuh"

#include <initializer_list>

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

// The checksum of the 4 bytes of word w at leaf positions pos .. pos + 3,
// less the factor M: sum_k b_k (2 (pos + k) + 1) mod 2^32.
__device__ __forceinline__ uint32_t word_crc(uint32_t w, uint32_t pos) {
  return (2u * pos + 1u) * __dp4a(w, 0x01010101u, 0u) + 2u * __dp4a(w, 0x03020100u, 0u);
}
// ... of one byte
__device__ __forceinline__ uint32_t byte_crc(uint32_t b, uint32_t pos) {
  return (2u * pos + 1u) * b;
}

// Loads of the arrived bytes: from L2 (.cg; device memory is coherent
// there), and as memory reads the compiler keeps after the stores before
// them (volatile, with a memory clobber), so the verify reads the buffer,
// never the registers the codes were stored from.
__device__ __forceinline__ uint32_t arrived_u8(const uint8_t* p) {
  uint16_t v;
  asm volatile("ld.global.cg.u8 %0, [%1];\n" : "=h"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ uint32_t arrived_u32(const void* p) {
  uint32_t v;
  asm volatile("ld.global.cg.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ uint2 arrived_u64(const void* p) {
  uint2 v;
  asm volatile("ld.global.cg.v2.u32 {%0, %1}, [%2];\n" : "=r"(v.x), "=r"(v.y) : "l"(p) : "memory");
  return v;
}

// mn and scale of a row sit 4-byte aligned only where N D % 4 == 0: byte
// stores and loads (lane 0 a row)
__device__ __forceinline__ void store_u32(uint8_t* p, uint32_t u) {
#pragma unroll
  for (int k = 0; k < 4; ++k) p[k] = (uint8_t)(u >> (8 * k));
}
__device__ __forceinline__ uint32_t load_u32(const uint8_t* p) {
  return arrived_u8(p) | (arrived_u8(p + 1) << 8) | (arrived_u8(p + 2) << 16) |
         (arrived_u8(p + 3) << 24);
}
// a row's (mn, scale) as they arrived: lane 0 reads them, the warp shares them
__device__ __forceinline__ float2 arrived_row(const uint8_t* buf, Wire w, long long r, int lane) {
  uint32_t m = 0, sc = 0;
  if (lane == 0) {
    m = load_u32(buf + w.mn(r));
    sc = load_u32(buf + w.scale(r));
  }
  return make_float2(__uint_as_float(__shfl_sync(0xffffffffu, m, 0)),
                     __uint_as_float(__shfl_sync(0xffffffffu, sc, 0)));
}

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// E codes (4 a word) -> the 16-byte vector of their decoded values in T
template <typename T>
__device__ __forceinline__ uint4 decode_vec(const uint32_t* c, const RowDequant& deq) {
  constexpr int E = Vec16<T>::kElems;
  float f[E];
#pragma unroll
  for (int e = 0; e < E; ++e)
    f[e] = deq((int)(signed char)((c[e / 4] >> (8 * (e % 4))) & 0xffu));
  if constexpr (E == 4) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  } else {  // element 2k in the low half of word k
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      w[k] = (uint32_t)narrow(f[2 * k], (T*)nullptr).bits |
             ((uint32_t)narrow(f[2 * k + 1], (T*)nullptr).bits << 16);
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// Receive row r from the buffer, vector body: this lane's codes read back,
// their checksum terms (less M) returned, their decode stored to out.
template <typename T, int NV>
__device__ __forceinline__ uint32_t receive_vec(const uint8_t* buf, T* __restrict__ out,
                                                Wire w, long long r, int lane, bool wide) {
  constexpr int E = Vec16<T>::kElems;
  const float2 ms = arrived_row(buf, w, r, lane);
  const float m = ms.x, sc = ms.y;
  const RowDequant deq(sc, m);
  const uint8_t* qr = buf + w.q(r);
  const uint32_t base = (uint32_t)(r * w.d) + kSaltQ;
  const int nvec = w.d / E;
  uint4* orow = reinterpret_cast<uint4*>(out + r * w.d);
  uint32_t got = 0;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int j = i * 32 + lane;
    if (j < nvec) {
      uint32_t c[E / 4];
      if constexpr (E == 4) {
        c[0] = arrived_u32(qr + 4 * j);
      } else if (wide) {
        const uint2 u = arrived_u64(qr + 8 * j);
        c[0] = u.x;
        c[1] = u.y;
      } else {
        c[0] = arrived_u32(qr + 8 * j);
        c[1] = arrived_u32(qr + 8 * j + 4);
      }
#pragma unroll
      for (int k = 0; k < E / 4; ++k) got += word_crc(c[k], base + j * E + 4 * k);
      orow[j] = decode_vec<T>(c, deq);
    }
  }
  if (lane == 0)
    got += word_crc(__float_as_uint(m), 4 * (uint32_t)r + kSaltMn) +
           word_crc(__float_as_uint(sc), 4 * (uint32_t)r + kSaltScale);
  return got;
}

// ... scalar body: a byte at a time
template <typename T>
__device__ __forceinline__ uint32_t receive_scalar(const uint8_t* buf, T* __restrict__ out,
                                                   Wire w, long long r, int lane) {
  const float2 ms = arrived_row(buf, w, r, lane);
  const float m = ms.x, sc = ms.y;
  const RowDequant deq(sc, m);
  const uint8_t* qr = buf + w.q(r);
  const uint32_t base = (uint32_t)(r * w.d) + kSaltQ;
  T* orow = out + r * w.d;
  uint32_t got = 0;
  for (int i = lane; i < w.d; i += 32) {
    const uint32_t b = arrived_u8(qr + i);
    got += byte_crc(b, base + i);
    orow[i] = narrow(deq((int)(signed char)b), (T*)nullptr);
  }
  if (lane == 0)
    got += word_crc(__float_as_uint(m), 4 * (uint32_t)r + kSaltMn) +
           word_crc(__float_as_uint(sc), 4 * (uint32_t)r + kSaltScale);
  return got;
}

// The block's rows' partial sums into the accumulators (acc[0]: the sent
// bytes, acc[1]: the arrived bytes, acc[2]: blocks finished, all zero at
// the launch). Thread 0 alone goes on after the block's sums: the other
// warps leave the SM. The last block takes the totals and zeroes the
// accumulators, writes the head (when sending) and verifies it against the
// arrived crc.
__device__ void finish(uint8_t* buf, uint8_t* ok, uint32_t* acc, uint32_t sent, uint32_t got,
                       bool send) {
  __shared__ uint32_t part[2][kRowsPerBlock];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  sent = warp_sum(sent);
  got = warp_sum(got);
  if (lane == 0) {
    part[0][warp] = sent;
    part[1][warp] = got;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  uint32_t s = 0, g = 0;
#pragma unroll
  for (int k = 0; k < kRowsPerBlock; ++k) {
    s += part[0][k];
    g += part[1][k];
  }
  if (send) atomicAdd(&acc[0], s);
  atomicAdd(&acc[1], g);
  __threadfence();
  if (atomicAdd(&acc[2], 1u) != gridDim.x - 1) return;
  __threadfence();
  s = atomicExch(&acc[0], 0u) * kCrcMult;
  g = atomicExch(&acc[1], 0u) * kCrcMult;
  atomicExch(&acc[2], 0u);
  if (send) {
    store_u32(buf, kCanary);
    store_u32(buf + 4, s);
  }
  *ok = load_u32(buf) == kCanary && load_u32(buf + 4) == g;
}

template <typename T, int NV>
__global__ void __launch_bounds__(kCodecThreads)
remote_hop_vec(const T* __restrict__ x, uint8_t* buf, T* __restrict__ out, uint8_t* ok,
               uint32_t* acc, long long n, int d, float bound, int saturating, int wide) {
  constexpr int E = Vec16<T>::kElems;
  const int lane = threadIdx.x % 32;
  const long long r = (long long)blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  const Wire w{n, d};
  uint32_t sent = 0, got = 0;
  if (r < n) {  // the whole warp
    const int nvec = d / E;
    uint4 raw[NV];
    float mn, mx;
    const bool clamp = load_row<T, NV>(reinterpret_cast<const uint4*>(x + r * d), nvec, lane,
                                       bound, saturating, raw, mn, mx);
    const RowQuant quant(mn, mx);
    uint8_t* qr = buf + w.q(r);
    const uint32_t base = (uint32_t)(r * d) + kSaltQ;
    auto send = [&](int j, const unsigned (&c)[E / 4]) {
#pragma unroll
      for (int k = 0; k < E / 4; ++k) sent += word_crc(c[k], base + j * E + 4 * k);
      if constexpr (E == 4) {
        reinterpret_cast<unsigned*>(qr)[j] = c[0];
      } else if (wide) {
        reinterpret_cast<uint2*>(qr)[j] = make_uint2(c[0], c[1]);
      } else {
        reinterpret_cast<unsigned*>(qr)[2 * j] = c[0];
        reinterpret_cast<unsigned*>(qr)[2 * j + 1] = c[1];
      }
    };
    if (quant.fast)  // the same for the whole warp
      quantize_row<true, T, NV>(raw, nvec, lane, quant, clamp, bound, send);
    else
      quantize_row<false, T, NV>(raw, nvec, lane, quant, clamp, bound, send);
    if (lane == 0) {
      store_u32(buf + w.mn(r), __float_as_uint(mn));
      store_u32(buf + w.scale(r), __float_as_uint(quant.scale));
      sent += word_crc(__float_as_uint(mn), 4 * (uint32_t)r + kSaltMn) +
              word_crc(__float_as_uint(quant.scale), 4 * (uint32_t)r + kSaltScale);
    }
    __syncwarp();  // the row's bytes are in the buffer, visible to the warp
    got = receive_vec<T, NV>(buf, out, w, r, lane, wide);
  }
  finish(buf, ok, acc, sent, got, true);
}

template <typename T>
__global__ void __launch_bounds__(kCodecThreads)
remote_hop_scalar(const T* __restrict__ x, uint8_t* buf, T* __restrict__ out, uint8_t* ok,
                  uint32_t* acc, long long n, int d, float bound, int saturating) {
  const int lane = threadIdx.x % 32;
  const long long r = (long long)blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  const Wire w{n, d};
  uint32_t sent = 0, got = 0;
  if (r < n) {
    const T* xr = x + r * d;
    float mn = INFINITY, mx = -INFINITY;
    bool nan = false;
    for (int i = lane; i < d; i += 32) {
      const float v = widen(xr[i]);
      mn = fminf(mn, v);
      mx = fmaxf(mx, v);
      nan |= v != v;
    }
    mn = warp_reduce(mn, MinOp());
    mx = warp_reduce(mx, MaxOp());
    const bool clamp = row_extremes(mn, mx, __any_sync(0xffffffffu, nan), bound, saturating);
    const RowQuant quant(mn, mx);
    uint8_t* qr = buf + w.q(r);
    const uint32_t base = (uint32_t)(r * d) + kSaltQ;
    for (int i = lane; i < d; i += 32) {
      const float u = widen(xr[i]), v = clamp ? saturate(u, bound) : u;
      const uint32_t b = (quant.fast ? quant.code_of<true>(v) : quant.code_of<false>(v)) & 0xffu;
      qr[i] = (uint8_t)b;
      sent += byte_crc(b, base + i);
    }
    if (lane == 0) {
      store_u32(buf + w.mn(r), __float_as_uint(mn));
      store_u32(buf + w.scale(r), __float_as_uint(quant.scale));
      sent += word_crc(__float_as_uint(mn), 4 * (uint32_t)r + kSaltMn) +
              word_crc(__float_as_uint(quant.scale), 4 * (uint32_t)r + kSaltScale);
    }
    __syncwarp();
    got = receive_scalar<T>(buf, out, w, r, lane);
  }
  finish(buf, ok, acc, sent, got, true);
}

template <typename T, int NV>
__global__ void __launch_bounds__(kCodecThreads)
remote_hop_receive_kernel(const uint8_t* buf, T* __restrict__ out, uint8_t* ok, uint32_t* acc,
                          long long n, int d, int wide) {
  const int lane = threadIdx.x % 32;
  const long long r = (long long)blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  const Wire w{n, d};
  uint32_t got = 0;
  if (r < n) {
    if constexpr (NV == 0)
      got = receive_scalar<T>(buf, out, w, r, lane);
    else
      got = receive_vec<T, NV>(buf, out, w, r, lane, wide);
  }
  finish(const_cast<uint8_t*>(buf), ok, acc, 0u, got, false);
}

// The vector body takes a row of whole 16-byte vectors, 16-byte aligned, at
// most 32 a lane; 0 picks the scalar body, else the vectors a lane holds.
template <typename T>
int vectors_a_lane(const void* x, const void* out, int d) {
  constexpr int E = Vec16<T>::kElems;
  const int per_lane = (d / E + 31) / 32;
  if (d % E != 0 || (x != nullptr && !aligned16(x)) || !aligned16(out) || per_lane > 32) return 0;
  for (int nv : {1, 2, 3, 4, 6, 7, 8, 12, 16, 24, 32})
    if (per_lane <= nv) return nv;
  return 0;
}

// 16-bit rows' 8 codes a vector leave in one 8-byte store where the q leaf
// (at byte 8 + 4 N + r D) is 8-byte aligned: even N, D a multiple of 8
inline int wide_codes(const uint8_t* buf, long long n, int d) {
  return (reinterpret_cast<uintptr_t>(buf) % 8 == 0 && n % 2 == 0 && d % 8 == 0) ? 1 : 0;
}

template <typename T>
cudaError_t launch_hop(const T* x, uint8_t* buf, T* out, uint8_t* ok, uint32_t* acc,
                       long long n, int d, float bound, int saturating, cudaStream_t s) {
  const unsigned grid = row_blocks(n);
  const int wide = wide_codes(buf, n, d);
  switch (vectors_a_lane<T>(x, out, d)) {
#define EDGELLM_HOP_NV(NV)                                                                \
  case NV:                                                                                \
    remote_hop_vec<T, NV><<<grid, kCodecThreads, 0, s>>>(x, buf, out, ok, acc, n, d, bound, \
                                                         saturating, wide);               \
    break;
    EDGELLM_HOP_NV(1)
    EDGELLM_HOP_NV(2)
    EDGELLM_HOP_NV(3)
    EDGELLM_HOP_NV(4)
    EDGELLM_HOP_NV(6)
    EDGELLM_HOP_NV(7)
    EDGELLM_HOP_NV(8)
    EDGELLM_HOP_NV(12)
    EDGELLM_HOP_NV(16)
    EDGELLM_HOP_NV(24)
    EDGELLM_HOP_NV(32)
#undef EDGELLM_HOP_NV
    default:
      remote_hop_scalar<T><<<grid, kCodecThreads, 0, s>>>(x, buf, out, ok, acc, n, d, bound,
                                                          saturating);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_receive(const uint8_t* buf, T* out, uint8_t* ok, uint32_t* acc, long long n,
                           int d, cudaStream_t s) {
  const unsigned grid = row_blocks(n);
  const int wide = wide_codes(buf, n, d);
  switch (vectors_a_lane<T>(nullptr, out, d)) {
#define EDGELLM_RECEIVE_NV(NV)                                                       \
  case NV:                                                                           \
    remote_hop_receive_kernel<T, NV><<<grid, kCodecThreads, 0, s>>>(buf, out, ok, acc, n, \
                                                                   d, wide);         \
    break;
    EDGELLM_RECEIVE_NV(1)
    EDGELLM_RECEIVE_NV(2)
    EDGELLM_RECEIVE_NV(3)
    EDGELLM_RECEIVE_NV(4)
    EDGELLM_RECEIVE_NV(6)
    EDGELLM_RECEIVE_NV(7)
    EDGELLM_RECEIVE_NV(8)
    EDGELLM_RECEIVE_NV(12)
    EDGELLM_RECEIVE_NV(16)
    EDGELLM_RECEIVE_NV(24)
    EDGELLM_RECEIVE_NV(32)
#undef EDGELLM_RECEIVE_NV
    default:
      remote_hop_receive_kernel<T, 0><<<grid, kCodecThreads, 0, s>>>(buf, out, ok, acc, n, d,
                                                                    wide);
  }
  return cudaGetLastError();
}

}  // namespace edgellm

// x (N, D) float32 (dtype 0), bf16 (1) or fp16 (2) -> buf (8 + 8 N + N D)
// uint8, out (N, D) in x's dtype, ok (a bool byte). With `saturating` each
// widened value is first clamped to +-bound and NaN made 0. acc is 3 uint32
// of scratch, zero at the launch and left zero by it (one set a stream).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int edgellm_remote_hop(const void* x, int dtype, uint8_t* buf, void* out, uint8_t* ok,
                                  uint32_t* acc, long long n, int d, float bound, int saturating,
                                  void* stream) {
  using namespace edgellm;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch_hop(static_cast<const float*>(x), buf, static_cast<float*>(out), ok,
                             acc, n, d, bound, saturating, s);
    case 1:
      return (int)launch_hop(static_cast<const Bf16*>(x), buf, static_cast<Bf16*>(out), ok, acc,
                             n, d, bound, saturating, s);
    case 2:
      return (int)launch_hop(static_cast<const F16*>(x), buf, static_cast<F16*>(out), ok, acc, n,
                             d, bound, saturating, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// An arrived buffer -> out (N, D) float32 (dtype 0), bf16 (1) or fp16 (2) and
// ok (a bool byte); acc as above.
extern "C" int edgellm_remote_hop_receive(const uint8_t* buf, int dtype, void* out, uint8_t* ok,
                                          uint32_t* acc, long long n, int d, void* stream) {
  using namespace edgellm;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch_receive(buf, static_cast<float*>(out), ok, acc, n, d, s);
    case 1:
      return (int)launch_receive(buf, static_cast<Bf16*>(out), ok, acc, n, d, s);
    case 2:
      return (int)launch_receive(buf, static_cast<F16*>(out), ok, acc, n, d, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* edgellm_remote_hop_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
