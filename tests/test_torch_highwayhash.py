"""The port's plain HighwayHash-256 (minio_tpu_torch.ops.highwayhash_torch)
against the JAX package's device program on the JAX CPU backend, the
scalar spec and the numpy multi-stream spec, byte-exact, over every
length class (empty, bulk packets, each remainder branch); the wrapper of
the Hopper kernel on the host; and a numpy model of the Hopper kernel's
arithmetic (csrc/hh256.cu: two threads per stream, the zipper as byte
permutes with the selector table read from the source, rows realigned
from 16-byte windows), which cannot run here, against the same oracles."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from minio_tpu.ops import highwayhash as jax_spec
from minio_tpu.ops.highwayhash_jax import hh256_batch_jax
from minio_tpu_torch.ops import highwayhash, highwayhash_cuda
from minio_tpu_torch.ops.highwayhash_torch import hh256_rows_ref

HH256_CU = (Path(__file__).resolve().parent.parent / "minio_tpu_torch"
            / "csrc" / "hh256.cu")
U64 = np.uint64
M32 = U64(0xFFFFFFFF)

# The length classes of tests/test_highwayhash_jax.py: bulk packets and
# L = 0, one length per remainder branch (r & 16, r & 3), and an odd
# remainder like a k=12 shard's.
LENGTHS = ([0, 1, 31, 32, 64, 100, 1024]
           + [64 + r for r in (1, 3, 4, 8, 15, 16, 17, 20, 23, 31)]
           + [87382 % 512 + 22])


@pytest.mark.parametrize("length", LENGTHS)
def test_matches_jax_and_spec(length):
    x = np.random.default_rng(length).integers(0, 256, (3, length),
                                               dtype=np.uint8)
    got = hh256_rows_ref(torch.from_numpy(x)).numpy()
    assert got.shape == (3, 32)
    assert np.array_equal(got, np.asarray(hh256_batch_jax(x)))
    assert np.array_equal(got, np.stack([
        np.frombuffer(jax_spec.highwayhash256(r.tobytes()), dtype=np.uint8)
        for r in x]))
    if length:                     # the numpy spec takes L > 0 only
        assert np.array_equal(got, jax_spec.highwayhash256_batch(x))


def test_constants_equal_the_jax_package():
    """The 'weights' carried across: key and init words."""
    assert highwayhash.MAGIC_KEY == jax_spec.MAGIC_KEY
    assert highwayhash.INIT0 == jax_spec.INIT0
    assert highwayhash.INIT1 == jax_spec.INIT1


def test_other_key_matches_spec():
    key = bytes(range(32))
    x = np.random.default_rng(9).integers(0, 256, (2, 77), dtype=np.uint8)
    got = hh256_rows_ref(torch.from_numpy(x), key).numpy()
    for i in range(2):
        assert got[i].tobytes() == jax_spec.highwayhash256(x[i].tobytes(),
                                                           key)


def test_rows_independent_and_bit_sensitive():
    x = np.zeros((3, 70), dtype=np.uint8)
    x[1, 69] = 1
    x[2, 0] = 0x80
    d = hh256_rows_ref(torch.from_numpy(x)).numpy()
    assert len({r.tobytes() for r in d}) == 3


def test_empty_batch():
    assert hh256_rows_ref(torch.zeros((0, 40), dtype=torch.uint8)).shape == \
        (0, 32)


def test_wrapper_runs_the_plain_version_on_the_host():
    x = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (4, 45), dtype=np.uint8))
    before = highwayhash_cuda.LAUNCHES
    got = highwayhash_cuda.hh256_rows(x)
    assert highwayhash_cuda.LAUNCHES == before       # no kernel on the host
    assert torch.equal(got, hh256_rows_ref(x))


def test_wrapper_rejects_bad_input():
    with pytest.raises(TypeError):
        highwayhash_cuda.hh256_rows(torch.zeros(2, 8, dtype=torch.int32))
    with pytest.raises(TypeError):
        highwayhash_cuda.hh256_rows(torch.zeros(2, 2, 8, dtype=torch.uint8))
    with pytest.raises(ValueError):
        highwayhash_cuda.hh256_rows(torch.zeros(2, 8, dtype=torch.uint8),
                                    key=b"short")


# -- A numpy model of the Hopper kernel's arithmetic (csrc/hh256.cu) --------


def byte_perm(x, y, sel: int) -> np.ndarray:
    """PTX `prmt.b32` in its default mode (CUDA's __byte_perm) on uint32
    arrays: byte b of the result is byte (sel >> 4b) & 7 of the eight
    bytes x (0-3), y (4-7); where bit 3 of that nibble is set, the chosen
    byte's top bit is replicated over the byte."""
    both = (np.asarray(y, dtype=U64) << U64(32)) | np.asarray(x, dtype=U64)
    out = np.zeros(both.shape, dtype=U64)
    for b in range(4):
        nibble = (sel >> (4 * b)) & 0xF
        byte = (both >> U64(8 * (nibble & 7))) & U64(0xFF)
        if nibble & 8:
            byte = np.where(byte & U64(0x80), U64(0xFF), U64(0))
        out |= byte << U64(8 * b)
    return out.astype(np.uint32)


def zip_table() -> list[tuple[int, int, int, int, int]]:
    """The kernel's selector table kZipSel, parsed from its source: per
    addend word (even lo, even hi, odd lo, odd hi), (x, y, sel, z, sel2)."""
    body = re.search(r"kZipSel\[4\] = \{(.*?)\n\s*\};", HH256_CU.read_text(),
                     re.S).group(1)
    rows = re.findall(r"\{(-?\d+), (-?\d+), (0x[0-9a-fA-F]+), (-?\d+), "
                      r"(0x[0-9a-fA-F]+|0)\}", body)
    assert len(rows) == 4, body
    return [(int(x), int(y), int(s, 16), int(z), int(s2, 0))
            for x, y, s, z, s2 in rows]


def zipper_by_table(even, odd, table):
    """The even and odd zipper addends of a lane pair, as the kernel's
    byte permutes compute them."""
    w = [even & M32, even >> U64(32), odd & M32, odd >> U64(32)]
    words = []
    for x, y, sel, z, sel2 in table:
        t = byte_perm(w[x], w[y], sel)
        if z >= 0:
            t = byte_perm(t, w[z], sel2)
        words.append(t.astype(U64))
    return words[0] | (words[1] << U64(32)), words[2] | (words[3] << U64(32))


def rot32(x):
    return (x >> U64(32)) | (x << U64(32))


class HalfModel:
    """One thread's half of n streams' state: lanes {2h, 2h+1}."""

    def __init__(self, n: int, h: int, key: bytes, table):
        k = np.frombuffer(key, dtype="<u8").astype(U64)[2 * h:2 * h + 2]
        init0 = np.array(jax_spec.INIT0[2 * h:2 * h + 2], dtype=U64)
        init1 = np.array(jax_spec.INIT1[2 * h:2 * h + 2], dtype=U64)
        self.h, self.table = h, table
        self.v0 = np.tile(init0 ^ k, (n, 1))
        self.v1 = np.tile(init1 ^ rot32(k), (n, 1))
        self.mul0 = np.tile(init0, (n, 1))
        self.mul1 = np.tile(init1, (n, 1))

    def update(self, lanes):
        """lanes: (n, 2) uint64, this thread's 16 bytes of the packet."""
        v0, v1, mul0, mul1 = self.v0, self.v1, self.mul0, self.mul1
        v1 += mul0 + lanes
        mul0 ^= (v1 & M32) * (v0 >> U64(32))
        v0 += mul1
        mul1 ^= (v0 & M32) * (v1 >> U64(32))
        a0, a1 = zipper_by_table(v1[:, 0], v1[:, 1], self.table)
        v0[:, 0] += a0
        v0[:, 1] += a1
        a0, a1 = zipper_by_table(v0[:, 0], v0[:, 1], self.table)
        v1[:, 0] += a0
        v1[:, 1] += a1

    def update_remainder(self, window, off, r: int):
        """The final packet of r bytes at window[:, off:], this thread's
        bytes 16h .. 16h + 15 of it, as `update_remainder` builds them."""
        mod4, base = r & 3, r & ~3
        self.v0 += U64((r << 32) + r)
        lo, hi = self.v1 & M32, self.v1 >> U64(32)
        rr, rl = U64(r), U64(32 - r)
        self.v1 = ((((hi << rr) | (hi >> rl)) & M32) << U64(32)) | \
            (((lo << rr) | (lo >> rl)) & M32)
        packet = np.zeros((len(window), 16), dtype=np.uint8)
        rows = np.arange(len(window))
        for b in range(16):
            i = 16 * self.h + b
            src = -1
            if i < base:
                src = i
            elif r & 16:
                if i >= 28:
                    src = base + mod4 - 4 + (i - 28)
            elif mod4:
                src = {16: base, 17: base + (mod4 >> 1),
                       18: base + mod4 - 1}.get(i, -1)
            if src >= 0:
                packet[:, b] = window[rows, off + src]
        self.update(packet.view("<u8").astype(U64))


def load_half(window, off):
    """Each row's 16 bytes at window[i, off[i]:], as the unaligned kernel
    loads them: five 4-byte words from the aligned-down offset, four
    funnel shifts right by 8 * (off % 4)."""
    base = off & ~3
    idx = base[:, None] + np.arange(20)
    words = np.take_along_axis(window, idx, axis=1).copy().view("<u4")
    both = (words[:, 1:].astype(U64) << U64(32)) | words[:, :4].astype(U64)
    shift = (8 * (off & 3)).astype(U64)[:, None]
    out = ((both >> shift) & M32).astype(np.uint32)
    return out.view("<u8").astype(U64)


def kernel_model(buf: np.ndarray, start: int, n: int, length: int,
                 key: bytes = highwayhash.MAGIC_KEY) -> np.ndarray:
    """What csrc/hh256.cu computes for rows buf[start + i * L:][:L]:
    each row's window starts at its 16-byte aligned-down address and is
    zero past the row's end (the clamped copies); two half-states per
    stream hash their own 16 bytes of every packet and of the remainder
    packet; the 10 permute rounds take the partner's v0 (the shuffle);
    each half writes its 16 digest bytes."""
    table = zip_table()
    starts = start + np.arange(n) * length
    o = starts & 15
    window = np.zeros((n, 15 + length + 64), dtype=np.uint8)
    for i in range(n):
        window[i, :o[i] + length] = buf[starts[i] - o[i]:starts[i] + length]
    halves = [HalfModel(n, h, key, table) for h in (0, 1)]
    packets, r = divmod(length, 32)
    for p in range(packets):
        for h, half in enumerate(halves):
            half.update(load_half(window, o + 32 * p + 16 * h))
    if r:
        for half in halves:
            # One offset per row: the remainder follows the row's packets.
            half.update_remainder(
                np.stack([window[i, o[i] + 32 * packets:][:32]
                          for i in range(n)]), 0, r)
    for _ in range(10):
        partner = [rot32(half.v0.copy()) for half in halves[::-1]]
        for half, lanes in zip(halves, partner):
            half.update(lanes)
    out = np.zeros((n, 32), dtype=np.uint8)
    for h, half in enumerate(halves):
        a3 = (half.v1[:, 1] + half.mul1[:, 1]) & U64(0x3FFFFFFFFFFFFFFF)
        a2 = half.v1[:, 0] + half.mul1[:, 0]
        a1 = half.v0[:, 1] + half.mul0[:, 1]
        a0 = half.v0[:, 0] + half.mul0[:, 0]
        m1 = a1 ^ ((a3 << U64(1)) | (a2 >> U64(63))) \
            ^ ((a3 << U64(2)) | (a2 >> U64(62)))
        m0 = a0 ^ (a2 << U64(1)) ^ (a2 << U64(2))
        out[:, 16 * h:16 * h + 16] = np.stack(
            [m0, m1], axis=1).astype("<u8").view(np.uint8)
    return out


def test_byte_perm_follows_prmt():
    x, y = np.uint32(0x44332211), np.uint32(0x88776655)
    assert byte_perm(x, y, 0x3210) == x
    assert byte_perm(x, y, 0x7654) == y
    assert byte_perm(x, y, 0x0415) == 0x11552266
    assert byte_perm(x, y, 0x00F0) == 0x1111FF11      # byte 7 = 0x88 < 0


def test_selector_table_equals_the_spec_zipper():
    """The kernel's six permutes per zipper give the spec's shift-and-mask
    addends, on random words."""
    table = zip_table()
    assert sum(2 if z >= 0 else 1 for *_, z, _s in table) == 6
    # __byte_perm reads three bits of a nibble, prmt four: none set bit 3.
    assert all(s & 0x8888 == 0 and s2 & 0x8888 == 0
               for _, _, s, _, s2 in table)
    rng = np.random.default_rng(12)
    src = rng.integers(0, 2**64, (1000, 4), dtype=np.uint64)
    want = np.zeros_like(src)
    jax_spec.HighwayHashVec._zipper(src, want)
    for pair in ((0, 1), (2, 3)):
        a0, a1 = zipper_by_table(src[:, pair[0]], src[:, pair[1]], table)
        assert np.array_equal(a0, want[:, pair[0]])
        assert np.array_equal(a1, want[:, pair[1]])


@pytest.mark.parametrize("length", LENGTHS)
def test_kernel_model_matches_plain_jax_and_spec(length):
    x = np.random.default_rng(length).integers(0, 256, (3, length),
                                               dtype=np.uint8)
    got = kernel_model(x.reshape(-1), 0, 3, length)
    assert np.array_equal(got, hh256_rows_ref(torch.from_numpy(x)).numpy())
    assert np.array_equal(got, np.asarray(hh256_batch_jax(x)))
    if length:
        assert np.array_equal(got, jax_spec.highwayhash256_batch(x))


@pytest.mark.parametrize("offset", [1, 7, 13])
@pytest.mark.parametrize("length", [100, 87382 % 512 + 22])
def test_kernel_model_rows_at_odd_offsets(offset, length):
    """Rows starting off a 16-byte boundary (a tail shard's rows): every
    row of an (3, L) block that starts `offset` bytes into its buffer."""
    rng = np.random.default_rng(offset * 1000 + length)
    buf = rng.integers(0, 256, offset + 3 * length + 5, dtype=np.uint8)
    x = buf[offset:offset + 3 * length].reshape(3, length)
    got = kernel_model(buf, offset, 3, length)
    assert np.array_equal(got, hh256_rows_ref(torch.from_numpy(x.copy()))
                          .numpy())
    assert np.array_equal(got, np.asarray(hh256_batch_jax(x.copy())))
    assert np.array_equal(got, jax_spec.highwayhash256_batch(x))
