"""Copy of minio_tpu/ops/highwayhash.py: the port keeps its own, so that it imports
nothing of the JAX package.

HighwayHash-256 — bit-identical to the reference's bitrot hash.

The reference's default bitrot algorithm is HighwayHash256S (streaming), keyed
with a magic 256-bit key (reference cmd/bitrot.go:37). Every shard block
written to disk is framed as [32-byte HighwayHash256 | shard bytes]
(reference cmd/bitrot-streaming.go). To be able to verify/produce the
reference's on-disk frames, this implementation must match the upstream
HighwayHash algorithm exactly; it is validated against the reference's
self-test golden chain (reference cmd/bitrot.go:215-220) in
tests/test_highwayhash.py.

Implementation notes: 4x64-bit lanes held as python ints (masked to 64 bits).
A numpy-vectorized multi-stream variant (many independent hashes advanced in
lockstep — the shape the TPU kernel parallelizes over) lives in
`HighwayHashVec`. State update math follows the published HighwayHash
portable algorithm (google/highwayhash hh_portable.h).
"""

from __future__ import annotations

import struct

import numpy as np

MASK64 = (1 << 64) - 1

# HighwayHash init constants (sqrt/pi derived, from the published algorithm).
INIT0 = (0xDBE6D5D5FE4CCE2F, 0xA4093822299F31D0,
         0x13198A2E03707344, 0x243F6A8885A308D3)
INIT1 = (0x3BD39E10CB0EF593, 0xC0ACF169B5F18A8C,
         0xBE5466CF34E90C6C, 0x452821E638D01377)

# Magic bitrot key: HH-256 of the first 100 decimals of pi with a zero key
# (reference cmd/bitrot.go:37).
MAGIC_KEY = bytes([
    0x4B, 0xE7, 0x34, 0xFA, 0x8E, 0x23, 0x8A, 0xCD,
    0x26, 0x3E, 0x83, 0xE6, 0xBB, 0x96, 0x85, 0x52,
    0x04, 0x0F, 0x93, 0x5D, 0xA3, 0x9F, 0x44, 0x14,
    0x97, 0xE0, 0x9D, 0x13, 0x22, 0xDE, 0x36, 0xA0,
])

SIZE = 32        # digest bytes (256-bit)
BLOCK_SIZE = 32  # hash.Hash BlockSize (one 32-byte packet), per the Go package


def _rot32_within64(x: int, count: int) -> int:
    """Rotate each 32-bit half of a 64-bit lane left by count."""
    lo = x & 0xFFFFFFFF
    hi = x >> 32
    lo = ((lo << count) | (lo >> (32 - count))) & 0xFFFFFFFF if count else lo
    hi = ((hi << count) | (hi >> (32 - count))) & 0xFFFFFFFF if count else hi
    return (hi << 32) | lo


class HighwayHash256:
    """Streaming HighwayHash-256 over 32-byte packets."""

    def __init__(self, key: bytes = MAGIC_KEY):
        if len(key) != 32:
            raise ValueError("key must be 32 bytes")
        self.key = struct.unpack("<4Q", key)
        self.reset()

    def reset(self) -> None:
        k = self.key
        self.v0 = [INIT0[i] ^ k[i] for i in range(4)]
        self.v1 = [INIT1[i] ^ (((k[i] >> 32) | (k[i] << 32)) & MASK64)
                   for i in range(4)]
        self.mul0 = list(INIT0)
        self.mul1 = list(INIT1)
        self._buf = b""

    # -- core update ----------------------------------------------------------

    def _update_packet(self, lanes: tuple[int, int, int, int]) -> None:
        v0, v1, mul0, mul1 = self.v0, self.v1, self.mul0, self.mul1
        for i in range(4):
            v1[i] = (v1[i] + mul0[i] + lanes[i]) & MASK64
            mul0[i] ^= ((v1[i] & 0xFFFFFFFF) * (v0[i] >> 32)) & MASK64
            v0[i] = (v0[i] + mul1[i]) & MASK64
            mul1[i] ^= ((v0[i] & 0xFFFFFFFF) * (v1[i] >> 32)) & MASK64
        self._zipper_merge_and_add(v1[1], v1[0], v0, 1, 0)
        self._zipper_merge_and_add(v1[3], v1[2], v0, 3, 2)
        self._zipper_merge_and_add(v0[1], v0[0], v1, 1, 0)
        self._zipper_merge_and_add(v0[3], v0[2], v1, 3, 2)

    @staticmethod
    def _zipper_merge_and_add(v1: int, v0: int, add: list[int],
                              i1: int, i0: int) -> None:
        add[i0] = (add[i0] + (
            (((v0 & 0xFF000000) | (v1 & 0xFF00000000)) >> 24)
            | (((v0 & 0xFF0000000000) | (v1 & 0xFF000000000000)) >> 16)
            | (v0 & 0xFF0000)
            | ((v0 & 0xFF00) << 32)
            | ((v1 & 0xFF00000000000000) >> 8)
            | ((v0 << 56) & MASK64)
        )) & MASK64
        add[i1] = (add[i1] + (
            (((v1 & 0xFF000000) | (v0 & 0xFF00000000)) >> 24)
            | (v1 & 0xFF0000)
            | ((v1 & 0xFF0000000000) >> 16)
            | ((v1 & 0xFF00) << 24)
            | ((v0 & 0xFF000000000000) >> 8)
            | ((v1 & 0xFF) << 48)
            | (v0 & 0xFF00000000000000)
        )) & MASK64

    # -- streaming interface --------------------------------------------------

    def update(self, data: bytes) -> "HighwayHash256":
        buf = self._buf + data
        n = (len(buf) // 32) * 32
        for off in range(0, n, 32):
            self._update_packet(struct.unpack_from("<4Q", buf, off))
        self._buf = buf[n:]
        return self

    write = update  # Go hash.Hash naming

    def _update_remainder(self, bytes_: bytes) -> None:
        size_mod32 = len(bytes_)
        assert 0 < size_mod32 < 32
        size_mod4 = size_mod32 & 3
        remainder = bytes_[size_mod32 & ~3:]
        for i in range(4):
            self.v0[i] = (self.v0[i] + ((size_mod32 << 32) + size_mod32)) & MASK64
            self.v1[i] = _rot32_within64(self.v1[i], size_mod32)
        packet = bytearray(32)
        packet[: size_mod32 & ~3] = bytes_[: size_mod32 & ~3]
        if size_mod32 & 16:
            # Reads the 4 bytes ending at remainder+size_mod4, which may reach
            # back before the remainder start (Load3 AllowReadBeforeAndReturn).
            for i in range(4):
                packet[28 + i] = bytes_[(size_mod32 & ~3) + size_mod4 - 4 + i]
        elif size_mod4:
            packet[16] = remainder[0]
            packet[17] = remainder[size_mod4 >> 1]
            packet[18] = remainder[size_mod4 - 1]
        self._update_packet(struct.unpack("<4Q", bytes(packet)))

    def _permute_and_update(self) -> None:
        v0 = self.v0
        permuted = (
            ((v0[2] >> 32) | (v0[2] << 32)) & MASK64,
            ((v0[3] >> 32) | (v0[3] << 32)) & MASK64,
            ((v0[0] >> 32) | (v0[0] << 32)) & MASK64,
            ((v0[1] >> 32) | (v0[1] << 32)) & MASK64,
        )
        self._update_packet(permuted)

    @staticmethod
    def _modular_reduction(a3u: int, a2: int, a1: int, a0: int) -> tuple[int, int]:
        a3 = a3u & 0x3FFFFFFFFFFFFFFF
        m1 = a1 ^ (((a3 << 1) | (a2 >> 63)) & MASK64) ^ (((a3 << 2) | (a2 >> 62)) & MASK64)
        m0 = a0 ^ ((a2 << 1) & MASK64) ^ ((a2 << 2) & MASK64)
        return m1, m0

    def digest(self) -> bytes:
        """Finalize a copy of the state and return the 32-byte digest."""
        st = self._clone()
        if st._buf:
            st._update_remainder(st._buf)
        for _ in range(10):
            st._permute_and_update()
        m1a, m0a = self._modular_reduction(
            (st.v1[1] + st.mul1[1]) & MASK64, (st.v1[0] + st.mul1[0]) & MASK64,
            (st.v0[1] + st.mul0[1]) & MASK64, (st.v0[0] + st.mul0[0]) & MASK64)
        m1b, m0b = self._modular_reduction(
            (st.v1[3] + st.mul1[3]) & MASK64, (st.v1[2] + st.mul1[2]) & MASK64,
            (st.v0[3] + st.mul0[3]) & MASK64, (st.v0[2] + st.mul0[2]) & MASK64)
        return struct.pack("<4Q", m0a, m1a, m0b, m1b)

    sum256 = digest

    def _clone(self) -> "HighwayHash256":
        c = object.__new__(HighwayHash256)
        c.key = self.key
        c.v0 = list(self.v0)
        c.v1 = list(self.v1)
        c.mul0 = list(self.mul0)
        c.mul1 = list(self.mul1)
        c._buf = self._buf
        return c


def highwayhash256(data: bytes, key: bytes = MAGIC_KEY) -> bytes:
    """One-shot 256-bit HighwayHash."""
    return HighwayHash256(key).update(data).digest()


# ---------------------------------------------------------------------------
# Vectorized multi-stream variant: N independent hashes advanced in lockstep.
# This is the data layout the TPU bitrot kernel uses — one hash state per
# shard-block, parallel across the batch (cf. SURVEY.md §7 hard part #3:
# parallelize across shard streams, not within one).
# ---------------------------------------------------------------------------

class HighwayHashVec:
    """N parallel HighwayHash-256 states over uint64 numpy lanes.

    All streams must consume identically-sized inputs (the bitrot use case:
    every shard block in a batch has the same shard_size).
    """

    def __init__(self, n: int, key: bytes = MAGIC_KEY):
        k = np.frombuffer(key, dtype="<u8").astype(np.uint64)
        init0 = np.array(INIT0, dtype=np.uint64)
        init1 = np.array(INIT1, dtype=np.uint64)
        krot = (k >> np.uint64(32)) | (k << np.uint64(32))
        self.n = n
        self.v0 = np.broadcast_to(init0 ^ k, (n, 4)).copy()
        self.v1 = np.broadcast_to(init1 ^ krot, (n, 4)).copy()
        self.mul0 = np.broadcast_to(init0, (n, 4)).copy()
        self.mul1 = np.broadcast_to(init1, (n, 4)).copy()

    def _update_packets(self, lanes: np.ndarray) -> None:
        """lanes: (n, 4) uint64 — one 32-byte packet per stream."""
        v0, v1, mul0, mul1 = self.v0, self.v1, self.mul0, self.mul1
        M32 = np.uint64(0xFFFFFFFF)
        S32 = np.uint64(32)
        v1 += mul0 + lanes
        mul0 ^= (v1 & M32) * (v0 >> S32)
        v0 += mul1
        mul1 ^= (v0 & M32) * (v1 >> S32)
        self._zipper(v1, v0)
        self._zipper(v0, v1)

    @staticmethod
    def _zipper(src: np.ndarray, dst: np.ndarray) -> None:
        """dst[:, {0,1}] += zipper_merge(src[:, {0,1}]), same for {2,3}."""
        def u(x):
            return np.uint64(x)
        for (i0, i1) in ((0, 1), (2, 3)):
            v0 = src[:, i0]
            v1 = src[:, i1]
            dst[:, i0] += (
                (((v0 & u(0xFF000000)) | (v1 & u(0xFF00000000))) >> u(24))
                | (((v0 & u(0xFF0000000000)) | (v1 & u(0xFF000000000000))) >> u(16))
                | (v0 & u(0xFF0000))
                | ((v0 & u(0xFF00)) << u(32))
                | ((v1 & u(0xFF00000000000000)) >> u(8))
                | (v0 << u(56)))
            dst[:, i1] += (
                (((v1 & u(0xFF000000)) | (v0 & u(0xFF00000000))) >> u(24))
                | (v1 & u(0xFF0000))
                | ((v1 & u(0xFF0000000000)) >> u(16))
                | ((v1 & u(0xFF00)) << u(24))
                | ((v0 & u(0xFF000000000000)) >> u(8))
                | ((v1 & u(0xFF)) << u(48))
                | (v0 & u(0xFF00000000000000)))

    def update(self, data: np.ndarray) -> "HighwayHashVec":
        """data: (n, L) uint8 with L % 32 == 0 — bulk packets for all streams."""
        n, L = data.shape
        assert n == self.n and L % 32 == 0
        lanes = data.reshape(n, L // 32, 4, 8).view("<u8")[..., 0].astype(np.uint64)
        for p in range(L // 32):
            self._update_packets(lanes[:, p, :])
        return self

    def update_remainder(self, data: np.ndarray) -> "HighwayHashVec":
        """data: (n, r) uint8, 0 < r < 32 — identical tail for all streams."""
        n, r = data.shape
        assert n == self.n and 0 < r < 32
        size_mod4 = r & 3
        base = r & ~3
        self.v0 += np.uint64((r << 32) + r)
        # rotate32 each half of every v1 lane by r bits
        lo = self.v1 & np.uint64(0xFFFFFFFF)
        hi = self.v1 >> np.uint64(32)
        rr = np.uint64(r)
        lo = ((lo << rr) | (lo >> np.uint64(32 - r))) & np.uint64(0xFFFFFFFF)
        hi = ((hi << rr) | (hi >> np.uint64(32 - r))) & np.uint64(0xFFFFFFFF)
        self.v1 = (hi << np.uint64(32)) | lo
        packet = np.zeros((n, 32), dtype=np.uint8)
        packet[:, :base] = data[:, :base]
        remainder = data[:, base:]
        if r & 16:
            for i in range(4):
                packet[:, 28 + i] = data[:, base + size_mod4 - 4 + i]
        elif size_mod4:
            packet[:, 16] = remainder[:, 0]
            packet[:, 17] = remainder[:, size_mod4 >> 1]
            packet[:, 18] = remainder[:, size_mod4 - 1]
        lanes = packet.reshape(n, 4, 8).view("<u8")[..., 0].astype(np.uint64)
        self._update_packets(lanes)
        return self

    def digest(self) -> np.ndarray:
        """Finalize all streams; returns (n, 32) uint8 digests."""
        st = HighwayHashVec.__new__(HighwayHashVec)
        st.n = self.n
        st.v0, st.v1 = self.v0.copy(), self.v1.copy()
        st.mul0, st.mul1 = self.mul0.copy(), self.mul1.copy()
        for _ in range(10):
            v0 = st.v0
            swap = lambda x: (x >> np.uint64(32)) | (x << np.uint64(32))
            permuted = np.stack(
                [swap(v0[:, 2]), swap(v0[:, 3]), swap(v0[:, 0]), swap(v0[:, 1])],
                axis=1)
            st._update_packets(permuted)
        def modred(a3u, a2, a1, a0):
            a3 = a3u & np.uint64(0x3FFFFFFFFFFFFFFF)
            m1 = a1 ^ ((a3 << np.uint64(1)) | (a2 >> np.uint64(63))) \
                 ^ ((a3 << np.uint64(2)) | (a2 >> np.uint64(62)))
            m0 = a0 ^ (a2 << np.uint64(1)) ^ (a2 << np.uint64(2))
            return m1, m0
        m1a, m0a = modred(st.v1[:, 1] + st.mul1[:, 1], st.v1[:, 0] + st.mul1[:, 0],
                          st.v0[:, 1] + st.mul0[:, 1], st.v0[:, 0] + st.mul0[:, 0])
        m1b, m0b = modred(st.v1[:, 3] + st.mul1[:, 3], st.v1[:, 2] + st.mul1[:, 2],
                          st.v0[:, 3] + st.mul0[:, 3], st.v0[:, 2] + st.mul0[:, 2])
        out = np.stack([m0a, m1a, m0b, m1b], axis=1)
        return out.astype("<u8").view(np.uint8).reshape(self.n, 32)


def highwayhash256_batch(blocks: np.ndarray, key: bytes = MAGIC_KEY) -> np.ndarray:
    """Hash a batch of equal-length blocks: (n, L) uint8 -> (n, 32) digests."""
    n, L = blocks.shape
    h = HighwayHashVec(n, key)
    base = (L // 32) * 32
    if base:
        h.update(blocks[:, :base])
    if L % 32:
        h.update_remainder(blocks[:, base:])
    return h.digest()
