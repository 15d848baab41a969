// Batched GF(2^8) matrix x shards for Hopper (sm_90a): row-packed nibble
// tables in shared memory, every input row of a thread in flight before
// the first lookup, and one byte transpose per output word.
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
// 16 MiB: 50.3 MB at 3.35 TB/s is 15.0 us.  The 2-row degraded transform
// of the same batch moves 41.9 MB, 12.5 us.  Counted as the TPU kernel's
// bit-plane product, 2 * 8R * 8C * S * B int8 operations, the encode is
// 17.2 G ops, 8.7 us at the int8 tensor-core peak.
//
// Design.  The TPU kernel unpacks bytes into bit-planes because the TPU has
// no byte gather.  Hopper has one, so the kernel computes the same linear
// map as klauspost/reedsolomon does with vpshufb: multiplying a byte by a
// constant is linear over GF(2), so M[r,c] * x = LO[r,c][x & 15] ^
// HI[r,c][x >> 4].  What the first form of this kernel lost was issue
// slots: byte-wide tables gave one byte of one output row per lookup, so
// R = 4 cost 8 LDS.U8 and about 20 integer instructions per input byte,
// 4x the time of its bytes bound.  Here:
// - Row-packed tables.  The wrapper packs the tables of four output rows
//   into one uint32 entry, laid out (G, C, 2, 16) with G = ceil(R / 4):
//   byte r' of [g, c, 0, v] is M[4g + r', c] * v, of [g, c, 1, v] is
//   M[4g + r', c] * (v << 4).  One input byte then costs two 32-bit
//   lookups and one 3-input XOR for up to four output rows.  Each
//   half-table is 16 words, 16-word aligned: lanes reading one word get a
//   broadcast and lanes reading different words hit different banks, so a
//   lookup never conflicts.
// - Offsets without per-byte shifts.  Per input word w (four columns),
//   (w << 2) & kNibbleMask and (w >> 2) & kNibbleMask hold the byte
//   offsets of the four low and four high nibbles' entries; one
//   __byte_perm (PRMT, selector kOffsetSel + k) takes out the k-th.  The
//   loop over input rows is unrolled (the kernel is a template on C), so
//   each table's address is an immediate: LDS [offset + imm].
// - Accumulate per column, transpose once.  A thread owns 16 consecutive
//   columns and keeps one word per column whose four bytes are the four
//   output rows of group g.  After the last input row, each 4-column block
//   is turned into four row words by eight PRMT (kTransposeSel), and each
//   output row gets one 16-byte store.  Rows past the fourth (R > 4) loop
//   over g with the input words still in registers.
// - Every input row in flight.  A thread issues its C 16-byte loads (128 B
//   at C = 8) before staging the tables and before the first lookup; at
//   24 warps an SM (78 registers, three blocks) that is 96 KB an SM, far
//   more than the ~18 KB that Little's law asks at 3.35 TB/s and ~700 ns.
//   So no TMA or cp.async ring.
// - Rows at any offset.  The tail block of a PUT has rows at every offset
//   mod 16.  The unaligned variant (kAligned = false) loads the two
//   aligned 16-byte granules around a thread's 16 bytes (the second only
//   where it holds a byte of the row) and realigns them with word selects
//   and four funnel shifts; it stores 16 bytes where the output row is
//   16-byte aligned, else bytes (outside the lookups: a PUT's tail block
//   is one launch of 10 blocks).  The launch takes the aligned variant
//   when x, out and S are all 16-byte aligned, as at every full block of
//   the main path.
// - Tables are staged per group of four output rows (one 16-row chunk of
//   input rows at a time when C > 16), so shared memory stays at 2 KiB for
//   any R and C.
//
// Rejected: bit-sliced LOP3 with a runtime matrix (one masked LOP3 per set
// bit of the 32x64 bit matrix per 32 columns, plus the transposes into and
// out of bit-planes: at least as many instructions as the tables and much
// more code); int8 tensor cores on bit-planes, the TPU's form (8.7 us at
// the dense peak only through wgmma, and unpacking 8 planes a byte into
// fragment layouts and packing the result costs ALU work comparable to the
// tables); full 256-entry byte tables (one lookup a byte, but random
// indices over 64 banks conflict about 3.5-way).
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3 at 700 W).  Per input
// byte at C = 8, R <= 4, the SASS holds 2 LDS.32 and 4.9 32-bit integer
// instructions (2.25 PRMT, 1.5 LOP3), 8.1 in all, against 8 LDS.U8 and
// 21.9 for byte-wide tables.  0.0254 ms at the encode shape, 59% of the
// bytes bound and 2.4x the byte-table kernel in the same run; 0.0243 ms
// for the 2-row transform; 0.0146 ms for a PUT tail block (1, 8, 38401).
// A persistent form that loaded each thread's next tile while it computed
// this one measured the same 0.0254 ms, so it was not kept.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 16;    // bytes of one shard row per thread
constexpr int kMaxC = 16;   // input rows held in registers at once
constexpr uint32_t kNibbleMask = 0x3C3C3C3Cu;
constexpr uint32_t kOffsetSel = 0x4440u;   // + k: byte k, zero-extended

// The 4x4 byte transpose as byte permutes: v[4 + i] =
// __byte_perm(v[x], v[y], sel) for step i, with v[0..3] the column words
// a0..a3 (byte r of a_k: output row r at column k).  Byte j of
// __byte_perm(p, q, s) is byte (s >> 4j) & 7 of the eight bytes p (0-3),
// q (4-7).  v[8..11] are the row words (byte k of row r: column k).
struct PermStep {
  int x, y;
  uint32_t sel;
};

__host__ __device__ constexpr PermStep transpose_step(int i) {
  constexpr PermStep kTransposeSel[8] = {
      {0, 1, 0x5140},  // t0 = a0.0 a1.0 a0.1 a1.1
      {0, 1, 0x7362},  // t1 = a0.2 a1.2 a0.3 a1.3
      {2, 3, 0x5140},  // t2 = a2.0 a3.0 a2.1 a3.1
      {2, 3, 0x7362},  // t3 = a2.2 a3.2 a2.3 a3.3
      {4, 6, 0x5410},  // row 0 = a0.0 a1.0 a2.0 a3.0
      {4, 6, 0x7632},  // row 1 = a0.1 a1.1 a2.1 a3.1
      {5, 7, 0x5410},  // row 2 = a0.2 a1.2 a2.2 a3.2
      {5, 7, 0x7632},  // row 3 = a0.3 a1.3 a2.3 a3.3
  };
  return kTransposeSel[i];
}

template <int i>
__device__ __forceinline__ void permute(uint32_t (&v)[12]) {
  constexpr PermStep s = transpose_step(i);
  v[4 + i] = __byte_perm(v[s.x], v[s.y], s.sel);
}

// row[r][q] = the row word of output row r at columns 4q..4q+3.
__device__ __forceinline__ void transpose(const uint32_t (&acc)[16],
                                          uint32_t (&row)[4][4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t v[12] = {acc[4 * q], acc[4 * q + 1], acc[4 * q + 2],
                      acc[4 * q + 3]};
    permute<0>(v);
    permute<1>(v);
    permute<2>(v);
    permute<3>(v);
    permute<4>(v);
    permute<5>(v);
    permute<6>(v);
    permute<7>(v);
#pragma unroll
    for (int r = 0; r < 4; ++r) row[r][q] = v[8 + r];
  }
}

// 16 bytes of a row at p (the row ends at `end`).  Aligned: one 16-byte
// load.  Unaligned: the aligned granule that holds p and, where the row
// reaches into it, the next one; then realigned in registers.
template <bool kAligned>
__device__ __forceinline__ void load16(const uint8_t* p, const uint8_t* end,
                                       uint32_t (&w)[4]) {
  if constexpr (kAligned) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  } else {
    const uintptr_t a = reinterpret_cast<uintptr_t>(p);
    const uint32_t o = static_cast<uint32_t>(a & 15);
    const uint4* g = reinterpret_cast<const uint4*>(a - o);
    const uint4 v0 = __ldg(g);
    uint4 v1 = make_uint4(0, 0, 0, 0);
    if (o != 0 && reinterpret_cast<const uint8_t*>(g + 1) < end) {
      v1 = __ldg(g + 1);
    }
    uint32_t u[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
    if (o & 8) {
#pragma unroll
      for (int i = 0; i < 6; ++i) u[i] = u[i + 2];
    }
    if (o & 4) {
#pragma unroll
      for (int i = 0; i < 5; ++i) u[i] = u[i + 1];
    }
    const uint32_t sh = (o & 3) * 8;
#pragma unroll
    for (int q = 0; q < 4; ++q) w[q] = __funnelshift_r(u[q], u[q + 1], sh);
  }
}

// The first n (<= 16) bytes of v to dst: one 16-byte store where dst is
// 16-byte aligned and n = 16, else bytes.
template <bool kAligned>
__device__ __forceinline__ void store16(uint8_t* dst, int n,
                                        const uint32_t (&v)[4]) {
  if (kAligned ||
      (n == kVec && (reinterpret_cast<uintptr_t>(dst) & 15) == 0)) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      if (i < n) dst[i] = static_cast<uint8_t>(v[i >> 2] >> (8 * (i & 3)));
    }
  }
}

// Rows [0, rows) of xb at column s0 into w (rows past `rows` and
// threads past the row end get zeros), salted.
template <int kC, bool kAligned>
__device__ __forceinline__ void load_rows(uint32_t (&w)[kC][4],
                                          const uint8_t* xb, int rows,
                                          long long S, long long s0,
                                          bool active, uint32_t salt4) {
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    w[c][0] = w[c][1] = w[c][2] = w[c][3] = 0;
    if (active && c < rows) {
      load16<kAligned>(xb + c * S + s0, xb + (c + 1) * S, w[c]);
    }
  }
  if (salt4 != 0) {
#pragma unroll
    for (int c = 0; c < kC; ++c) {
#pragma unroll
      for (int q = 0; q < 4; ++q) w[c][q] ^= salt4;
    }
  }
}

// The table word at byte offset `off` of the half-table at t.
__device__ __forceinline__ uint32_t lookup(const uint32_t* t, uint32_t off) {
  return *reinterpret_cast<const uint32_t*>(
      reinterpret_cast<const uint8_t*>(t) + off);
}

// acc[col] ^= T[c][0][x & 15] ^ T[c][1][x >> 4] for the byte x of every
// input row c < rows at this thread's column col.
template <int kC, bool kGuard>
__device__ __forceinline__ void accumulate(uint32_t (&acc)[16],
                                           const uint32_t (&w)[kC][4],
                                           const uint32_t* tab, int rows) {
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    if (kGuard && c >= rows) break;
    const uint32_t* lo = tab + 32 * c;
    const uint32_t* hi = lo + 16;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t lo4 = (w[c][q] << 2) & kNibbleMask;
      const uint32_t hi4 = (w[c][q] >> 2) & kNibbleMask;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        acc[4 * q + k] ^= lookup(lo, __byte_perm(lo4, 0, kOffsetSel + k)) ^
                          lookup(hi, __byte_perm(hi4, 0, kOffsetSel + k));
      }
    }
  }
}

// `words` (a multiple of 4) table words from global to shared memory.
__device__ __forceinline__ void stage(uint32_t* tab, const uint32_t* src,
                                      int words) {
  for (int i = threadIdx.x; i < words / 4; i += kThreads) {
    reinterpret_cast<uint4*>(tab)[i] =
        __ldg(reinterpret_cast<const uint4*>(src) + i);
  }
}

// tables: (G, C, 2, 16) uint32 row-packed nibble tables; x: (B, C, S),
// out: (B, R, S).  One thread per 16 columns of one block b.  kChunked:
// C > kC, taken kC input rows at a time (inputs re-read per group);
// otherwise C == kC and the inputs stay in registers for every group.
// Threads past the row end run along (loads and stores off) because the
// block stages the tables of every group together.
template <int kC, bool kAligned, bool kChunked>
__global__ void __launch_bounds__(kThreads, kC <= 8 ? 3 : 2)
gf_matmul_kernel(const uint32_t* __restrict__ tables,
                 const uint8_t* __restrict__ x, uint8_t* __restrict__ out,
                 int R, int C, long long S, uint32_t salt) {
  __shared__ __align__(16) uint32_t tab[kC * 32];
  const int nc = kChunked ? C : kC;
  const long long s0 =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * kVec;
  const bool active = s0 < S;
  const int n = active ? static_cast<int>(S - s0 < kVec ? S - s0 : kVec) : 0;
  const long long b = blockIdx.y;
  const uint8_t* xb = x + b * nc * S;
  uint8_t* ob = out + b * R * S;
  const uint32_t salt4 = (salt & 0xFFu) * 0x01010101u;
  const int groups = (R + 3) >> 2;

  uint32_t w[kC][4];
  if constexpr (!kChunked) {
    load_rows<kC, kAligned>(w, xb, kC, S, s0, active, salt4);
  }
#pragma unroll 1
  for (int g = 0; g < groups; ++g) {
    uint32_t acc[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] = 0;
    if constexpr (!kChunked) {
      if (g > 0) __syncthreads();   // every thread is done with group g-1
      stage(tab, tables + static_cast<long long>(g) * kC * 32, kC * 32);
      __syncthreads();
      // The lookup offsets do not depend on g.  Left alone, the compiler
      // computes all 32 * kC of them once, before the loop, and keeps
      // them live: 255 registers and spills at C = 8, one block an SM.
      // An empty asm that "changes" w keeps them inside the loop.
#pragma unroll
      for (int c = 0; c < kC; ++c) {
#pragma unroll
        for (int q = 0; q < 4; ++q) asm volatile("" : "+r"(w[c][q]));
      }
      accumulate<kC, false>(acc, w, tab, kC);
    } else {
#pragma unroll 1
      for (int c0 = 0; c0 < nc; c0 += kC) {
        const int rows = nc - c0 < kC ? nc - c0 : kC;
        if (g > 0 || c0 > 0) __syncthreads();
        stage(tab, tables + (static_cast<long long>(g) * nc + c0) * 32,
              rows * 32);
        load_rows<kC, kAligned>(w, xb + c0 * S, rows, S, s0, active, salt4);
        __syncthreads();
        accumulate<kC, true>(acc, w, tab, rows);
      }
    }
    uint32_t row[4][4];
    transpose(acc, row);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (active && 4 * g + r < R) {
        store16<kAligned>(ob + (4 * g + r) * S + s0, n, row[r]);
      }
    }
  }
}

using Kernel = void (*)(const uint32_t*, const uint8_t*, uint8_t*, int, int,
                        long long, uint32_t);

template <bool kAligned>
Kernel pick(int C) {
  switch (C) {
    case 1: return gf_matmul_kernel<1, kAligned, false>;
    case 2: return gf_matmul_kernel<2, kAligned, false>;
    case 3: return gf_matmul_kernel<3, kAligned, false>;
    case 4: return gf_matmul_kernel<4, kAligned, false>;
    case 5: return gf_matmul_kernel<5, kAligned, false>;
    case 6: return gf_matmul_kernel<6, kAligned, false>;
    case 7: return gf_matmul_kernel<7, kAligned, false>;
    case 8: return gf_matmul_kernel<8, kAligned, false>;
    case 9: return gf_matmul_kernel<9, kAligned, false>;
    case 10: return gf_matmul_kernel<10, kAligned, false>;
    case 11: return gf_matmul_kernel<11, kAligned, false>;
    case 12: return gf_matmul_kernel<12, kAligned, false>;
    case 13: return gf_matmul_kernel<13, kAligned, false>;
    case 14: return gf_matmul_kernel<14, kAligned, false>;
    case 15: return gf_matmul_kernel<15, kAligned, false>;
    case 16: return gf_matmul_kernel<16, kAligned, false>;
    default: return gf_matmul_kernel<kMaxC, kAligned, true>;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  Launches on `stream` and
// returns the cudaError_t of the launch (0 on success); it never
// synchronises.  Shapes: tables (ceil(R / 4), C, 2, 16) uint32 (16-byte
// aligned), x (B, C, S) and out (B, R, S) contiguous uint8, all on the
// current device.
extern "C" int gf_matmul_launch(const void* tables, const void* x, void* out,
                                int B, int R, int C, long long S, int salt,
                                void* stream) {
  if (B <= 0 || R <= 0 || S <= 0) return 0;
  if (C <= 0 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(tables) & 15) != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(out)) & 15) == 0 &&
                       (S & 15) == 0;
  const long long segs = (S + kVec - 1) / kVec;
  const dim3 grid(static_cast<unsigned>((segs + kThreads - 1) / kThreads),
                  static_cast<unsigned>(B));
  const Kernel kernel = aligned ? pick<true>(C) : pick<false>(C);
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(tables), static_cast<const uint8_t*>(x),
      static_cast<uint8_t*>(out), R, C, S, static_cast<uint32_t>(salt));
  return static_cast<int>(cudaGetLastError());
}
