// Batched GF(2^8) matrix x shards for Hopper (sm_90a): nibble tables in
// shared memory, one thread per 16 contiguous bytes of a shard column.
//
// Replaces: the Pallas TPU kernels minio_tpu/ops/erasure_pallas.py
// `_kernel` and `_kernel_salted` (launched by `_pallas_gf_matmul`).  Both
// compute out[b, r, s] = XOR_c  M[r, c] * x[b, c, s]  over GF(2^8), given
// as an (8R, 8C) plane-major GF(2) bit matrix; the salted form XORs a
// per-call byte into every input byte first.  Encode (R = parity rows),
// decode, reconstruct and heal all call this one kernel with different
// small matrices built on the host.
//
// What bounds it on an H100 SXM: memory.  At the main path's encode shape,
// x (32, 8, 131072) -> out (32, 4, 131072), it must read 32 MiB and write
// 16 MiB: 50.3 MB at 3.35 TB/s is about 15 us.  The 2-row degraded
// transform of the same batch moves 40 MiB, about 12.5 us.  The arithmetic
// is small beside that: counted as the TPU kernel's bit-plane product,
// 2 * 8R * 8C * S * B int8 operations, it is 17.2 G ops, about 9 us at the
// int8 tensor-core peak.
//
// Design.  The TPU kernel unpacks bytes into bit-planes because the TPU
// has no byte gather.  Hopper does, so this kernel computes the same
// linear map the way klauspost/reedsolomon and the repository's host codec
// do with vpshufb: multiplying a byte by a constant is linear over GF(2),
// so M[r,c] * x = LO[r,c][x & 15] ^ HI[r,c][x >> 4] with two 16-entry
// tables per (r, c).  The wrapper derives the tables from the bit matrix
// (R * C * 32 bytes, 1 KiB for EC:8+4) and the block stages them in shared
// memory.  Each table spans four consecutive 32-bit banks, so the lanes of
// a warp that look up one table never conflict: same word broadcasts,
// different words sit in different banks.  A thread loads 16 bytes of each
// of the C input rows at its column (one 16-byte load per row when the
// row start is 16-byte aligned, byte loads otherwise and on the ragged edge
// of S), and accumulates RB = 4 output rows at a time in registers; rows
// past the fourth re-read the inputs through L1/L2.  Any S is taken: the
// last thread of a row masks the edge.
//
// Later work, not done here: wgmma or int8 tensor-core bit-plane forms,
// TMA-fed pipelines, and fusing the mxh256 digest into this pass.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 16;   // bytes of one shard row per thread
constexpr int kRB = 4;     // output rows accumulated per pass over the inputs

__device__ __forceinline__ void load16(const uint8_t* src, int n,
                                       uint32_t w[4]) {
  if (n == kVec && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    uint4 v = __ldg(reinterpret_cast<const uint4*>(src));
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    return;
  }
  w[0] = w[1] = w[2] = w[3] = 0;
  // Fully unrolled so that w stays in registers (a runtime index would
  // put it in local memory for the fast path too).
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    if (i < n) {
      w[i >> 2] |= static_cast<uint32_t>(__ldg(src + i)) << (8 * (i & 3));
    }
  }
}

__device__ __forceinline__ void store16(uint8_t* dst, int n,
                                        const uint32_t w[4]) {
  if (n == kVec && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    return;
  }
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    if (i < n) dst[i] = static_cast<uint8_t>(w[i >> 2] >> (8 * (i & 3)));
  }
}

// tables: (R, C, 32) uint8, entries [0, 16) the low-nibble table and
// [16, 32) the high-nibble table of M[r, c].  x: (B, C, S), out: (B, R, S).
__global__ void __launch_bounds__(kThreads)
gf_matmul_kernel(const uint8_t* __restrict__ tables,
                 const uint8_t* __restrict__ x,
                 uint8_t* __restrict__ out,
                 int R, int C, long long S, uint32_t salt) {
  extern __shared__ uint8_t tab[];
  const int nt = R * C * 32;
  for (int i = threadIdx.x; i < nt; i += blockDim.x) tab[i] = tables[i];
  __syncthreads();

  const long long s0 =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * kVec;
  if (s0 >= S) return;
  const int n = static_cast<int>(S - s0 < kVec ? S - s0 : kVec);
  const long long b = blockIdx.y;
  const uint32_t salt4 = (salt & 0xFFu) * 0x01010101u;
  const uint8_t* xb = x + b * C * S + s0;
  uint8_t* ob = out + b * R * S + s0;

  for (int r0 = 0; r0 < R; r0 += kRB) {
    uint32_t acc[kRB][4];
#pragma unroll
    for (int rb = 0; rb < kRB; ++rb) {
      acc[rb][0] = acc[rb][1] = acc[rb][2] = acc[rb][3] = 0;
    }
    for (int c = 0; c < C; ++c) {
      uint32_t w[4];
      load16(xb + c * S, n, w);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        w[q] ^= salt4;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const uint32_t byte = (w[q] >> (8 * k)) & 0xFFu;
          const uint32_t lo = byte & 15u;
          const uint32_t hi = 16u + (byte >> 4);
#pragma unroll
          for (int rb = 0; rb < kRB; ++rb) {
            if (r0 + rb < R) {
              const uint8_t* t = tab + ((r0 + rb) * C + c) * 32;
              acc[rb][q] ^= static_cast<uint32_t>(t[lo] ^ t[hi]) << (8 * k);
            }
          }
        }
      }
    }
#pragma unroll
    for (int rb = 0; rb < kRB; ++rb) {
      if (r0 + rb < R) store16(ob + (r0 + rb) * S, n, acc[rb]);
    }
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  Launches on `stream` and
// returns the cudaError_t of the launch (0 on success); it never
// synchronises.  Shapes: tables (R, C, 32), x (B, C, S), out (B, R, S),
// all contiguous uint8 on the current device.
extern "C" int gf_matmul_launch(const void* tables, const void* x, void* out,
                                int B, int R, int C, long long S, int salt,
                                void* stream) {
  if (B <= 0 || R <= 0 || S <= 0) return 0;
  if (C <= 0 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const long long segs = (S + kVec - 1) / kVec;
  const dim3 grid(static_cast<unsigned>((segs + kThreads - 1) / kThreads),
                  static_cast<unsigned>(B));
  const size_t smem = static_cast<size_t>(R) * C * 32;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        gf_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  gf_matmul_kernel<<<grid, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(tables), static_cast<const uint8_t*>(x),
      static_cast<uint8_t*>(out), R, C, S,
      static_cast<uint32_t>(salt));
  return static_cast<int>(cudaGetLastError());
}
