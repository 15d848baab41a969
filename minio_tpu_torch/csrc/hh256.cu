// Multi-stream HighwayHash-256 for Hopper (sm_90a): two threads per
// stream, the zipper merge as byte permutes, and the rows staged through
// shared memory by asynchronous copies.
//
// Replaces: the Pallas TPU kernel minio_tpu/ops/highwayhash_pallas.py
// `_kernel` (update `_update_lanes`, built by `_bulk_fn`), which advances
// the bulk multiple-of-32 packet prefix of many streams, and the XLA
// program around it in minio_tpu/ops/highwayhash_jax.py (`_hh256_impl`):
// the remainder packet and the finalisation.  Every row of an (n, L) uint8
// array is one stream; the result is its 32-byte HighwayHash-256 under a
// 32-byte key, bit-identical to the spec (ops/highwayhash.py) for any L,
// L = 0 included, and for rows at any byte alignment.
//
// What the TPU kernel computes, not its blocks.  The TPU has no 64-bit
// integers and no 32x32 -> 64 multiply, so the Pallas kernel splits every
// lane into two uint32 arrays and builds each product from 16-bit partial
// products; its sequential grid axis carries the state from one packet
// chunk to the next.  Hopper has both natively: here the state is
// uint64_t in registers, each product one wide multiply, and the packet
// chain a loop inside the thread.  The readable 64-bit forms of the same
// steps are in native/highwayhash.cc (ZipperMergeAndAdd, Update,
// UpdateRemainder, PermuteAndUpdate, ModularReduction, FinishOne).
//
// Design, for the shapes the main path launches (a PUT batch is 384 rows
// of 128 KiB, a GET batch 256, a tail block 12 rows of an odd length):
// - Two threads per stream.  The four 64-bit lanes mix only in pairs
//   {0,1} and {2,3} during the bulk and remainder packets: each zipper
//   merge reads and writes one pair.  So thread 2s + h of a warp carries
//   lanes {2h, 2h+1} of stream s (8 uint64_t of state) and hashes its own
//   16 bytes of every packet.  The pairs meet only in the 10 permute
//   rounds of the finalisation, where each thread takes its partner's v0
//   by __shfl_xor_sync (four 32-bit shuffles a round); each thread then
//   reduces its pair and writes its own 16 digest bytes.  The chain per
//   packet stays as long as with one thread, but each thread issues half
//   of the instructions, and 384 rows are 24 warps, not 12.
// - The zipper as byte permutes.  Each 32-bit word of a zipper addend
//   takes its bytes from at most three 32-bit words of the lane pair, so
//   an addend word is one __byte_perm (PRMT), or two where three source
//   words meet: six per zipper, selectors in the table kZipSel.  (Shifts
//   and masks compile to LOP3/SHF chains of about 30 instructions a
//   zipper.)
// - Rows staged through shared memory with cp.async (16-byte LDGSTS, L1
//   bypassed).  Each warp owns a ring of kStages chunks of kPacketsPerTrip
//   packets per stream; while it hashes chunk c, chunks c+1 and c+2 are in
//   flight (32 packets, some 3000 clocks at the measured 94 clocks a
//   packet: well beyond the latency of device memory).  cp.async and not
//   the bulk (TMA) copy: each thread of a pair copies alternate 16-byte
//   granules of its own
//   row with constant offsets, one instruction a copy and no barrier
//   object, and its source-size operand clamps the copies of the last
//   chunk to the row's end, which the bulk copy (whole 16-byte units)
//   cannot.  Registers hold only the packet being hashed.
// - Misaligned rows.  Both copy forms need 16-byte aligned addresses, and
//   a tail shard's rows (38401 B) start at every offset mod 16.  A row's
//   window starts at its aligned-down address (it never leaves the 16-byte
//   granules that hold the row's first and last bytes) and a thread
//   realigns its 16 bytes in shared memory with five 4-byte loads and four
//   funnel shifts.  When every row is 16-byte aligned (x aligned and
//   L % 16 == 0, the usual batch) the launch takes the hh256_aligned
//   variant, one 16-byte load a packet; otherwise every row takes the
//   hh256_unaligned one.  No byte-wise global load is left.
// - Bank conflicts.  A stream's slot in a stage is kSlotBytes = chunk +
//   32 bytes, 32 mod 128: the four streams of a quarter warp read the same
//   packet offset on four disjoint 32-byte bank groups.
// - Launch shape: one warp (16 streams) per block, so that at a PUT
//   batch's 24 warps each runs alone on its own SM: the chain of one warp,
//   not the sharing of an SM, sets the time.  The ring takes 26,112 bytes,
//   so eight blocks fit an SM when a launch brings more rows.  Threads
//   past the last row hash the last row again and store nothing, so every
//   thread of a warp takes the same path through copies, __syncwarp and
//   shuffles; 2n threads are even, so no live thread lacks its partner.
//
// What bounds it on an H100 SXM.  At (n, L) = (384, 131072) it must read
// 50.3 MB and write 12 KiB: about 15.0 us at 3.35 TB/s.  chip_smoke.py
// counts the packet loop's SASS (cuobjdump -sass) per thread and per
// packet by issuing pipe: in the aligned variant 42.7 32-bit integer
// instructions (32.3 of them on the integer ALU pipe: 12 PRMT, 12 adds,
// 8 LOP3 for the xors) and 45.9 in all, against 205.5 per packet of the
// one-thread design.  Times two threads per stream, spread over the
// card, the operations bound is 6.1 us, so bytes bound it.
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3 at 700 W): 0.194 ms at
// (384, 131072), 94 SM clocks per packet, against 1.53 ms and about 740
// clocks for the one-thread design in the same run.  That is the issue
// rate of one warp, not memory: a warp runs on one of its SM's four
// sub-partitions, whose integer ALU pipe is 16 lanes wide, so each of the
// 32.3 ALU instructions holds it two clocks, 64.6 clocks a packet at
// best; dependent steps (about eight a packet: add, carry, two permutes,
// twice) leave it idle for the rest.  At 24 warps the other 504
// sub-partitions of the card stay idle, so the bound over the whole card
// is out of reach at this n; with more rows the same kernel reaches
// 2.5 TB/s, about 75% of the bytes bound, at (4224, 131072) and
// (16896, 131072).
// Four threads per stream would halve the per-warp work again, at two
// shuffles on every packet's chain.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;          // one warp per block
constexpr int kThreadsPerStream = 2;  // one thread per lane pair
constexpr int kStreams = kThreads / kThreadsPerStream;
constexpr int kPacketsPerTrip = 16;   // packets a packet-loop trip hashes
constexpr int kChunkBytes = 32 * kPacketsPerTrip;
constexpr int kStages = 3;            // chunks in a warp's ring
// A stream's slot: a chunk and the 16 bytes a misaligned row reaches
// into, padded to 32 mod 128 bytes.
constexpr int kSlotBytes = kChunkBytes + 32;
constexpr int kStageBytes = kStreams * kSlotBytes;
constexpr int kRingBytes = kStages * kStageBytes;

// One 32-bit word of a zipper addend as byte permutes of the lane pair's
// words w0 = even.lo, w1 = even.hi, w2 = odd.lo, w3 = odd.hi:
// t = __byte_perm(w[x], w[y], sel), then, where z >= 0,
// __byte_perm(t, w[z], sel2).  Byte b of __byte_perm(a, b', s) is byte
// (s >> 4b) & 7 of the eight bytes a (0-3), b' (4-7).  The comments give
// the word's four bytes as indices into the pair's 16 little-endian bytes
// (even lane 0-7, odd lane 8-15), cf. ZipperMergeAndAdd.
struct ZipWord {
  int x, y;
  unsigned sel;
  int z;
  unsigned sel2;
};

__host__ __device__ constexpr ZipWord zip_word_of(int k) {
  constexpr ZipWord kZipSel[4] = {
      {0, 3, 0x0243, 1, 0x5210},  // even addend, lo: bytes 3, 12, 2, 5
      {0, 3, 0x0716, -1, 0},      // even addend, hi: bytes 14, 1, 15, 0
      {1, 2, 0x0607, 3, 0x5210},  // odd addend, lo: bytes 11, 4, 10, 13
      {1, 2, 0x3425, -1, 0},      // odd addend, hi: bytes 9, 6, 8, 7
  };
  return kZipSel[k];
}

template <int k>
__device__ __forceinline__ uint32_t zip_word(const uint32_t (&w)[4]) {
  constexpr ZipWord e = zip_word_of(k);
  const uint32_t t = __byte_perm(w[e.x], w[e.y], e.sel);
  if constexpr (e.z < 0) {
    return t;
  } else {
    return __byte_perm(t, w[e.z], e.sel2);
  }
}

// One thread's half of a stream's state: lanes {2h, 2h+1}.
struct Half {
  uint64_t v0[2], v1[2], mul0[2], mul1[2];
};

__device__ __forceinline__ uint64_t rot32(uint64_t x) {
  return (x >> 32) | (x << 32);
}

__device__ __forceinline__ uint64_t mul32x32(uint64_t a, uint64_t b) {
  return static_cast<uint64_t>(static_cast<uint32_t>(a)) *
         static_cast<uint32_t>(b);
}

// add[0] += even addend, add[1] += odd addend of the zipper merge of v.
__device__ __forceinline__ void zipper_merge_and_add(const uint64_t (&v)[2],
                                                     uint64_t (&add)[2]) {
  const uint32_t w[4] = {static_cast<uint32_t>(v[0]),
                         static_cast<uint32_t>(v[0] >> 32),
                         static_cast<uint32_t>(v[1]),
                         static_cast<uint32_t>(v[1] >> 32)};
  add[0] += (static_cast<uint64_t>(zip_word<1>(w)) << 32) | zip_word<0>(w);
  add[1] += (static_cast<uint64_t>(zip_word<3>(w)) << 32) | zip_word<2>(w);
}

__device__ __forceinline__ void update(Half& s, uint64_t lane0,
                                       uint64_t lane1) {
  const uint64_t lanes[2] = {lane0, lane1};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    s.v1[i] += s.mul0[i] + lanes[i];
    s.mul0[i] ^= mul32x32(s.v1[i], s.v0[i] >> 32);
    s.v0[i] += s.mul1[i];
    s.mul1[i] ^= mul32x32(s.v0[i], s.v1[i] >> 32);
  }
  zipper_merge_and_add(s.v1, s.v0);
  zipper_merge_and_add(s.v0, s.v1);
}

// This thread's 16 packet bytes at p in shared memory, as two lanes: one
// 16-byte load where p is 16-byte aligned, else five 4-byte loads and
// four funnel shifts.
template <bool kAligned>
__device__ __forceinline__ void load_half(const uint8_t* p, uint64_t& l0,
                                          uint64_t& l1) {
  uint32_t o[4];
  if constexpr (kAligned) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    o[0] = q.x;
    o[1] = q.y;
    o[2] = q.z;
    o[3] = q.w;
  } else {
    const int misalign = static_cast<int>(reinterpret_cast<uintptr_t>(p) & 3);
    const uint32_t* q = reinterpret_cast<const uint32_t*>(p - misalign);
    const uint32_t shift = 8 * misalign;
    uint32_t w[5];
#pragma unroll
    for (int k = 0; k < 5; ++k) w[k] = q[k];
#pragma unroll
    for (int k = 0; k < 4; ++k) o[k] = __funnelshift_r(w[k], w[k + 1], shift);
  }
  l0 = (static_cast<uint64_t>(o[1]) << 32) | o[0];
  l1 = (static_cast<uint64_t>(o[3]) << 32) | o[2];
}

// The final packet for the 0 < r < 32 bytes at `tail` in shared memory
// (cf. UpdateRemainder, native/highwayhash.cc:164), this thread's half:
// packet bytes 16h .. 16h + 15.
__device__ __forceinline__ void update_remainder(Half& s, const uint8_t* tail,
                                                 int r, int h) {
  const int mod4 = r & 3;
  const int base = r & ~3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    s.v0[i] += (static_cast<uint64_t>(r) << 32) + r;
    const uint32_t lo = static_cast<uint32_t>(s.v1[i]);
    const uint32_t hi = static_cast<uint32_t>(s.v1[i] >> 32);
    s.v1[i] = (static_cast<uint64_t>((hi << r) | (hi >> (32 - r))) << 32) |
              ((lo << r) | (lo >> (32 - r)));
  }
  uint64_t lanes[2] = {0, 0};
#pragma unroll
  for (int b = 0; b < 16; ++b) {
    const int i = 16 * h + b;
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
      lanes[b >> 3] |= static_cast<uint64_t>(tail[src]) << (8 * (b & 7));
    }
  }
  update(s, lanes[0], lanes[1]);
}

__device__ __forceinline__ void modular_reduction(uint64_t a3u, uint64_t a2,
                                                  uint64_t a1, uint64_t a0,
                                                  uint64_t& m1,
                                                  uint64_t& m0) {
  const uint64_t a3 = a3u & 0x3FFFFFFFFFFFFFFFull;
  m1 = a1 ^ ((a3 << 1) | (a2 >> 63)) ^ ((a3 << 2) | (a2 >> 62));
  m0 = a0 ^ (a2 << 1) ^ (a2 << 2);
}

__device__ __forceinline__ void cp_async16(uint8_t* smem, const uint8_t* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

// Copies `bytes` (1..16) and zero-fills the rest of the 16.
__device__ __forceinline__ void cp_async16_clamped(uint8_t* smem,
                                                   const uint8_t* gmem,
                                                   int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
}

// This thread's granules (h, h + 2, ...) of one chunk's window, which
// lies inside the row: the chunk, and for the unaligned variant the
// granule its last packet reaches into.
template <bool kAligned>
__device__ __forceinline__ void copy_window(uint8_t* dst, const uint8_t* src,
                                            int h) {
#pragma unroll
  for (int j = 0; j < kChunkBytes / 32; ++j) {
    cp_async16(dst + 32 * j, src + 32 * j);
  }
  if (!kAligned && h == 0) cp_async16(dst + kChunkBytes, src + kChunkBytes);
}

template <bool kAligned>
__device__ __forceinline__ void hh256_body(uint8_t* ring,
                                           const uint8_t* __restrict__ x,
                                           uint8_t* __restrict__ out,
                                           long long n, long long L,
                                           uint64_t k0, uint64_t k1,
                                           uint64_t k2, uint64_t k3) {
  // A chunk's window: its packets, plus the granule that a misaligned
  // row's last packet reaches into.
  constexpr int kWindow = kChunkBytes + (kAligned ? 0 : 16);
  const int h = threadIdx.x & 1;
  const int slot = threadIdx.x >> 1;
  const long long stream = static_cast<long long>(blockIdx.x) * kStreams + slot;
  // Past the last row: hash the last row again, store nothing.
  const bool live = stream < n;
  const long long row_index = live ? stream : n - 1;
  const uint8_t* row = x + row_index * L;
  const int o =
      kAligned ? 0 : static_cast<int>(reinterpret_cast<uintptr_t>(row) & 15);
  const uint8_t* win = row - o;
  const uint8_t* row_end = row + L;
  uint8_t* my_slot = ring + slot * kSlotBytes;

  Half s;
  {
    const uint64_t key[2] = {h ? k2 : k0, h ? k3 : k1};
    const uint64_t init0[2] = {
        h ? 0x13198a2e03707344ull : 0xdbe6d5d5fe4cce2full,
        h ? 0x243f6a8885a308d3ull : 0xa4093822299f31d0ull};
    const uint64_t init1[2] = {
        h ? 0xbe5466cf34e90c6cull : 0x3bd39e10cb0ef593ull,
        h ? 0x452821e638d01377ull : 0xc0acf169b5f18a8cull};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      s.v0[i] = init0[i] ^ key[i];
      s.v1[i] = init1[i] ^ rot32(key[i]);
      s.mul0[i] = init0[i];
      s.mul1[i] = init1[i];
    }
  }

  const long long packets = L >> 5;
  const int r = static_cast<int>(L & 31);
  const long long chunks = (L + kChunkBytes - 1) / kChunkBytes;
  // Chunks whose whole window lies inside the row copy unclamped.
  const long long open_chunks =
      L >= kWindow ? (L - kWindow) / kChunkBytes + 1 : 0;
  const long long full_chunks = packets / kPacketsPerTrip;

  // Chunk c into ring stage `stage`: this thread copies granules h, h+2,
  // ... of its row's window.  Always one commit group, even if empty.
  auto issue = [&](long long c, int stage) {
    uint8_t* dst = my_slot + stage * kStageBytes + 16 * h;
    const uint8_t* src = win + c * kChunkBytes + 16 * h;
    if (c < open_chunks) {
      copy_window<kAligned>(dst, src, h);
    } else if (c < chunks) {
#pragma unroll 1
      for (int g = h; g < kWindow / 16; g += 2) {
        const uint8_t* from = win + c * kChunkBytes + 16 * g;
        const long long left = row_end - from;
        if (left > 0) {
          cp_async16_clamped(my_slot + stage * kStageBytes + 16 * g, from,
                             left < 16 ? static_cast<int>(left) : 16);
        }
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) issue(c, c);

  int stage = 0;                  // ring stage of chunk c
  int ahead = kStages - 1;        // ring stage of chunk c + kStages - 1
  long long c = 0;
  // The packet loop: full chunks whose look-ahead copy is unclamped.
  const long long main_chunks =
      full_chunks < open_chunks - (kStages - 1) ? full_chunks
                                                : open_chunks - (kStages - 1);
  for (; c < main_chunks; ++c) {
    __syncwarp();  // every thread is done with the stage `ahead` reuses
    copy_window<kAligned>(my_slot + ahead * kStageBytes + 16 * h,
                          win + (c + kStages - 1) * kChunkBytes + 16 * h, h);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // this thread's copies of chunk c ...
    __syncwarp();                  // ... and every other thread's
    const uint8_t* p = my_slot + stage * kStageBytes + o + 16 * h;
#pragma unroll
    for (int j = 0; j < kPacketsPerTrip; ++j) {
      uint64_t l0, l1;
      load_half<kAligned>(p + 32 * j, l0, l1);
      update(s, l0, l1);
    }
    stage = stage == kStages - 1 ? 0 : stage + 1;
    ahead = ahead == kStages - 1 ? 0 : ahead + 1;
  }
  // The last chunks: clamped copies, a partial chunk.
  for (; c < chunks; ++c) {
    __syncwarp();
    issue(c + kStages - 1, ahead);
    cp_async_wait<kStages - 1>();
    __syncwarp();
    const uint8_t* p = my_slot + stage * kStageBytes + o + 16 * h;
    const long long rest = packets - c * kPacketsPerTrip;
    const int count = rest < kPacketsPerTrip ? static_cast<int>(rest)
                                             : kPacketsPerTrip;
#pragma unroll 1
    for (int j = 0; j < count; ++j) {
      uint64_t l0, l1;
      load_half<kAligned>(p + 32 * j, l0, l1);
      update(s, l0, l1);
    }
    if (c == chunks - 1 && r) {
      // The remainder lies in the last chunk, after its whole packets.
      update_remainder(s, my_slot + stage * kStageBytes + o + 32 * count, r,
                       h);
    }
    stage = stage == kStages - 1 ? 0 : stage + 1;
    ahead = ahead == kStages - 1 ? 0 : ahead + 1;
  }

  // PermuteAndUpdate: lanes 0, 1 take rot32 of v0 lanes 2, 3 and lanes
  // 2, 3 of v0 lanes 0, 1, which the partner thread holds.
#pragma unroll 1
  for (int round = 0; round < 10; ++round) {
    const uint64_t p0 = __shfl_xor_sync(
        0xffffffffu, static_cast<unsigned long long>(s.v0[0]), 1);
    const uint64_t p1 = __shfl_xor_sync(
        0xffffffffu, static_cast<unsigned long long>(s.v0[1]), 1);
    update(s, rot32(p0), rot32(p1));
  }
  uint64_t m0, m1;
  modular_reduction(s.v1[1] + s.mul1[1], s.v1[0] + s.mul1[0],
                    s.v0[1] + s.mul0[1], s.v0[0] + s.mul0[0], m1, m0);
  if (live) {
    uint64_t* dst = reinterpret_cast<uint64_t*>(out + row_index * 32 + 16 * h);
    dst[0] = m0;
    dst[1] = m1;
  }
}

// Every row 16-byte aligned: one 16-byte shared load a packet per thread.
__global__ void __launch_bounds__(kThreads)
hh256_aligned(const uint8_t* __restrict__ x, uint8_t* __restrict__ out,
              long long n, long long L, uint64_t k0, uint64_t k1,
              uint64_t k2, uint64_t k3) {
  __shared__ __align__(16) uint8_t ring[kRingBytes];
  hh256_body<true>(ring, x, out, n, L, k0, k1, k2, k3);
}

// Rows at any offset: windows from the aligned-down address, realigned in
// shared memory.
__global__ void __launch_bounds__(kThreads)
hh256_unaligned(const uint8_t* __restrict__ x, uint8_t* __restrict__ out,
                long long n, long long L, uint64_t k0, uint64_t k1,
                uint64_t k2, uint64_t k3) {
  __shared__ __align__(16) uint8_t ring[kRingBytes];
  hh256_body<false>(ring, x, out, n, L, k0, k1, k2, k3);
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
  const long long blocks = (n + kStreams - 1) / kStreams;
  if (blocks > 0x7FFFFFFFll) return static_cast<int>(cudaErrorInvalidValue);
  const bool aligned =
      (reinterpret_cast<uintptr_t>(x) & 15) == 0 && (L & 15) == 0;
  auto kernel = aligned ? hh256_aligned : hh256_unaligned;
  kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<uint8_t*>(out), n, L, k0,
      k1, k2, k3);
  return static_cast<int>(cudaGetLastError());
}
