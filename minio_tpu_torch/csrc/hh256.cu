// Multi-stream HighwayHash-256 for Hopper (sm_90a): one thread per stream
// runs the whole chain in 64-bit registers.
//
// Replaces: the Pallas TPU kernel minio_tpu/ops/highwayhash_pallas.py
// `_kernel` (update `_update_lanes`, built by `_bulk_fn`), which advances
// the bulk multiple-of-32 packet prefix of many streams, and the XLA
// program around it in minio_tpu/ops/highwayhash_jax.py (`_hh256_impl`):
// the remainder packet and the finalisation.  Every row of an (n, L) uint8
// array is one stream; the result is its 32-byte HighwayHash-256 under a
// 32-byte key, bit-identical to the spec (ops/highwayhash.py) for any L,
// L = 0 included.
//
// What the TPU kernel computes, not its blocks.  The TPU has no 64-bit
// integers and no 32x32 -> 64 multiply, so the Pallas kernel splits every
// lane into two uint32 arrays and builds each product from 16-bit partial
// products; its sequential grid axis carries the state from one packet
// chunk to the next.  Hopper has both natively, so here the state is 16
// uint64_t in registers, each product one wide multiply, and the packet
// chain a loop inside the thread.  The readable 64-bit forms of the same
// steps are in native/highwayhash.cc (ZipperMergeAndAdd, Update,
// UpdateRemainder, PermuteAndUpdate, ModularReduction, FinishOne).
//
// What bounds it on an H100 SXM.  At the main path's PUT shape, (n, L) =
// (384, 131072), it must read 50.3 MB and write 12 KiB: about 15.0 us at
// 3.35 TB/s.  The sm_90a build spends about 206 32-bit integer
// instructions on one 32-byte packet (cuobjdump -sass of the packet loop,
// counted by chip_smoke.py).  About 172 of them run on the integer ALU
// pipe (LOP3 and SHF for the zipper's byte moves, IADD3 for the 64-bit
// adds), about 17 on the FMA pipe (IMAD for the wide multiplies) and 16 on
// either, so the ALU pipe is the busier one: 384 * 4106 * 172 = 272 M
// instructions, about 16.2 us at 132 SMs x 64 ALU lanes x 1.98 GHz.
// Operations bound it, just ahead of bytes.
//
// Design, and where it falls short of that bound.  A PUT batch gives only
// 384 streams, 12 warps on a card of 132 SMs, and each stream is a chain of
// 4096 dependent packet updates: the kernel is latency-bound, many times
// its bound.  It does what is cheap against that: blocks of one warp, so
// the warps land on separate SMs; each thread loads the next four packets
// (128 bytes, eight 16-byte loads) while it hashes the current four, so a
// load's latency hides behind the previous group's arithmetic.  Rows that
// do not start on a 16-byte boundary (a tail shard of odd size) are read
// with unrolled byte loads, so the words stay in registers.  Ways out of
// the latency bound, for a later change: two threads per stream (lane
// pairs {0,1} and {2,3} meet only in the finalisation's permute), two
// streams per thread for instruction-level parallelism, and more streams
// per launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;  // one warp per block
constexpr int kGroup = 4;     // packets loaded one group ahead

struct State {
  uint64_t v0[4], v1[4], mul0[4], mul1[4];
};

__device__ __forceinline__ uint64_t rot32(uint64_t x) {
  return (x >> 32) | (x << 32);
}

__device__ __forceinline__ void zipper_merge_and_add(uint64_t v1,
                                                     uint64_t v0,
                                                     uint64_t& a1,
                                                     uint64_t& a0) {
  a0 += (((v0 & 0xff000000ull) | (v1 & 0xff00000000ull)) >> 24) |
        (((v0 & 0xff0000000000ull) | (v1 & 0xff000000000000ull)) >> 16) |
        (v0 & 0xff0000ull) | ((v0 & 0xff00ull) << 32) |
        ((v1 & 0xff00000000000000ull) >> 8) | (v0 << 56);
  a1 += (((v1 & 0xff000000ull) | (v0 & 0xff00000000ull)) >> 24) |
        (v1 & 0xff0000ull) | ((v1 & 0xff0000000000ull) >> 16) |
        ((v1 & 0xff00ull) << 24) | ((v0 & 0xff000000000000ull) >> 8) |
        ((v1 & 0xffull) << 48) | (v0 & 0xff00000000000000ull);
}

__device__ __forceinline__ uint64_t mul32x32(uint64_t a, uint64_t b) {
  return static_cast<uint64_t>(static_cast<uint32_t>(a)) *
         static_cast<uint32_t>(b);
}

__device__ __forceinline__ void update(State& s, const uint64_t* lanes) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    s.v1[i] += s.mul0[i] + lanes[i];
    s.mul0[i] ^= mul32x32(s.v1[i], s.v0[i] >> 32);
    s.v0[i] += s.mul1[i];
    s.mul1[i] ^= mul32x32(s.v0[i], s.v1[i] >> 32);
  }
  zipper_merge_and_add(s.v1[1], s.v1[0], s.v0[1], s.v0[0]);
  zipper_merge_and_add(s.v1[3], s.v1[2], s.v0[3], s.v0[2]);
  zipper_merge_and_add(s.v0[1], s.v0[0], s.v1[1], s.v1[0]);
  zipper_merge_and_add(s.v0[3], s.v0[2], s.v1[3], s.v1[2]);
}

__device__ __forceinline__ uint64_t load_u64_bytes(const uint8_t* p) {
  uint64_t v = 0;
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    v |= static_cast<uint64_t>(__ldg(p + b)) << (8 * b);
  }
  return v;
}

// `count` packets (32 bytes each) at p into w[0 .. 4 * count), as
// little-endian 64-bit lanes.
template <int count>
__device__ __forceinline__ void load_packets(const uint8_t* p, bool aligned,
                                             uint64_t* w) {
  if (aligned) {
    const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int i = 0; i < 2 * count; ++i) {
      const uint4 v = __ldg(q + i);
      w[2 * i] = (static_cast<uint64_t>(v.y) << 32) | v.x;
      w[2 * i + 1] = (static_cast<uint64_t>(v.w) << 32) | v.z;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4 * count; ++i) w[i] = load_u64_bytes(p + 8 * i);
  }
}

// The final packet for the 0 < r < 32 bytes at `tail` (cf.
// UpdateRemainder, native/highwayhash.cc:164).  Unrolled over the 32 packet
// bytes so that the lanes stay in registers.
__device__ __forceinline__ void update_remainder(State& s,
                                                 const uint8_t* tail, int r) {
  const int mod4 = r & 3;
  const int base = r & ~3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    s.v0[i] += (static_cast<uint64_t>(r) << 32) + r;
    const uint32_t lo = static_cast<uint32_t>(s.v1[i]);
    const uint32_t hi = static_cast<uint32_t>(s.v1[i] >> 32);
    s.v1[i] = (static_cast<uint64_t>((hi << r) | (hi >> (32 - r))) << 32) |
              ((lo << r) | (lo >> (32 - r)));
  }
  uint64_t lanes[4] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    int src = -1;
    if (i < base) {
      src = i;
    } else if (r & 16) {
      if (i >= 28) src = base + mod4 - 4 + (i - 28);
    } else if (mod4) {
      if (i == 16) src = base;
      if (i == 17) src = base + (mod4 >> 1);
      if (i == 18) src = base + mod4 - 1;
    }
    if (src >= 0) {
      lanes[i >> 3] |= static_cast<uint64_t>(__ldg(tail + src))
                       << (8 * (i & 7));
    }
  }
  update(s, lanes);
}

__device__ __forceinline__ void modular_reduction(uint64_t a3u, uint64_t a2,
                                                  uint64_t a1, uint64_t a0,
                                                  uint64_t& m1,
                                                  uint64_t& m0) {
  const uint64_t a3 = a3u & 0x3FFFFFFFFFFFFFFFull;
  m1 = a1 ^ ((a3 << 1) | (a2 >> 63)) ^ ((a3 << 2) | (a2 >> 62));
  m0 = a0 ^ (a2 << 1) ^ (a2 << 2);
}

__global__ void __launch_bounds__(kThreads)
hh256_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ out,
             long long n, long long L, uint64_t k0, uint64_t k1,
             uint64_t k2, uint64_t k3) {
  const long long row_index =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row_index >= n) return;
  const uint8_t* row = x + row_index * L;
  const bool aligned = (reinterpret_cast<uintptr_t>(row) & 15) == 0;

  const uint64_t init0[4] = {0xdbe6d5d5fe4cce2full, 0xa4093822299f31d0ull,
                             0x13198a2e03707344ull, 0x243f6a8885a308d3ull};
  const uint64_t init1[4] = {0x3bd39e10cb0ef593ull, 0xc0acf169b5f18a8cull,
                             0xbe5466cf34e90c6cull, 0x452821e638d01377ull};
  const uint64_t key[4] = {k0, k1, k2, k3};
  State s;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    s.v0[i] = init0[i] ^ key[i];
    s.v1[i] = init1[i] ^ rot32(key[i]);
    s.mul0[i] = init0[i];
    s.mul1[i] = init1[i];
  }

  const long long packets = L >> 5;
  const long long groups = packets / kGroup;
  uint64_t cur[4 * kGroup];
  if (groups > 0) load_packets<kGroup>(row, aligned, cur);
  for (long long g = 0; g < groups; ++g) {
    // The next group's loads go out before this group's arithmetic; the
    // last group reloads itself (in bounds, unused).
    const long long gn = g + 1 < groups ? g + 1 : g;
    uint64_t nxt[4 * kGroup];
    load_packets<kGroup>(row + gn * 32 * kGroup, aligned, nxt);
#pragma unroll
    for (int j = 0; j < kGroup; ++j) update(s, cur + 4 * j);
#pragma unroll
    for (int j = 0; j < 4 * kGroup; ++j) cur[j] = nxt[j];
  }
  for (long long p = groups * kGroup; p < packets; ++p) {
    uint64_t w[4];
    load_packets<1>(row + p * 32, aligned, w);
    update(s, w);
  }
  const int r = static_cast<int>(L & 31);
  if (r) update_remainder(s, row + packets * 32, r);

  for (int round = 0; round < 10; ++round) {
    const uint64_t p[4] = {rot32(s.v0[2]), rot32(s.v0[3]), rot32(s.v0[0]),
                           rot32(s.v0[1])};
    update(s, p);
  }
  uint64_t m0a, m1a, m0b, m1b;
  modular_reduction(s.v1[1] + s.mul1[1], s.v1[0] + s.mul1[0],
                    s.v0[1] + s.mul0[1], s.v0[0] + s.mul0[0], m1a, m0a);
  modular_reduction(s.v1[3] + s.mul1[3], s.v1[2] + s.mul1[2],
                    s.v0[3] + s.mul0[3], s.v0[2] + s.mul0[2], m1b, m0b);
  uint64_t* o = reinterpret_cast<uint64_t*>(out + row_index * 32);
  o[0] = m0a;
  o[1] = m1a;
  o[2] = m0b;
  o[3] = m1b;
}

}  // namespace

// Plain C entry point (bound with ctypes).  Launches on `stream` and
// returns the cudaError_t of the launch (0 on success); it never
// synchronises.  x: (n, L) contiguous uint8; out: (n, 32) contiguous uint8,
// 8-byte aligned; k0..k3: the key as four little-endian 64-bit words.
extern "C" int hh256_launch(const void* x, void* out, long long n,
                            long long L, unsigned long long k0,
                            unsigned long long k1, unsigned long long k2,
                            unsigned long long k3, void* stream) {
  if (n <= 0) return 0;
  if (L < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFll) return static_cast<int>(cudaErrorInvalidValue);
  hh256_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<uint8_t*>(out), n, L, k0,
      k1, k2, k3);
  return static_cast<int>(cudaGetLastError());
}
