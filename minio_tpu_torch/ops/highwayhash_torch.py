"""Multi-stream HighwayHash-256 in plain torch ops: the plain version of
the Hopper kernel csrc/hh256.cu.

Counterpart of minio_tpu/ops/highwayhash_jax.py (`_hh256_impl`): N
independent streams, one per row of an (N, L) uint8 tensor, advance in
lockstep, one 32-byte packet per step; then the remainder packet (L % 32
bytes), 10 permute rounds and the modular reduction.  Bit-identical to
the spec in ops/highwayhash.py for any L, L = 0 included.

torch has no uint64, and a 32x32 -> 64 product overflows int64, so every
64-bit lane is a (lo, hi) pair of 32-bit values held in int64, masked
after each add and shift.  The product is built from 16-bit partial
products of one operand, each below 2^48.  Each of the four state words
(v0, v1, mul0, mul1) is one int64 tensor of shape (4 lanes, N, 2), the
last axis [lo, hi], so that an add, xor or mask is one torch op for all
lanes and both halves.  The zipper merge is a fixed byte permutation of
each lane pair, done as one gather on the little-endian bytes.

`hh256_rows_ref` runs on the tensor's device; the CPU tests hold it to
the JAX package and the spec, and chip_smoke.py holds the kernel to it.
"""

from __future__ import annotations

import numpy as np
import torch

from .highwayhash import INIT0, INIT1, MAGIC_KEY

M32 = 0xFFFFFFFF

# Byte j of the two zipper-merge addends of a lane pair, as an index into
# the pair's 16 little-endian bytes (even lane 0..7, odd lane 8..15); cf.
# ZipperMergeAndAdd, native/highwayhash.cc:108.
_ZIPPER = (3, 12, 2, 5, 14, 1, 15, 0,          # addend of the even lane
           11, 4, 10, 13, 9, 6, 8, 7)          # addend of the odd lane


def _word(values, n: int, device) -> torch.Tensor:
    """Four python 64-bit ints -> a (4, n, 2) [lo, hi] int64 tensor."""
    t = torch.tensor([[v & M32, v >> 32] for v in values], dtype=torch.int64,
                     device=device)
    return t[:, None, :].expand(4, n, 2).contiguous()


def _add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    s = a + b
    s[..., 1] += s[..., 0] >> 32
    return s & M32


def _mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Full 64-bit product of two 32-bit values, as [lo, hi]."""
    p0 = a * (b & 0xFFFF)                      # < 2^48
    p1 = a * (b >> 16)                         # < 2^48, weight 2^16
    low = p0 + ((p1 & 0xFFFF) << 16)           # < 2^49
    return torch.stack([low & M32, (low >> 32) + (p1 >> 16)], dim=-1)


def _zipper(src: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """(4, n, 2) -> the (4, n, 2) zipper-merge addends of lane pairs
    (0, 1) and (2, 3)."""
    n = src.shape[1]
    raw = src.permute(1, 0, 2).contiguous().view(torch.uint8)
    pairs = raw.reshape(n, 2, 2, 2, 8)[..., :4].reshape(n, 2, 16)
    words = torch.zeros((n, 2, 2, 2, 8), dtype=torch.uint8,
                        device=src.device)
    words[..., :4] = pairs[:, :, index].reshape(n, 2, 2, 2, 4)
    return words.view(torch.int64).reshape(n, 4, 2).permute(1, 0, 2)


def _update(state, lanes: torch.Tensor, index: torch.Tensor):
    """One packet for all streams; lanes is (4, n, 2)."""
    v0, v1, mul0, mul1 = state
    v1 = _add(v1 + mul0, lanes)
    mul0 = mul0 ^ _mul(v1[..., 0], v0[..., 1])
    v0 = _add(v0, mul1)
    mul1 = mul1 ^ _mul(v0[..., 0], v1[..., 1])
    v0 = _add(v0, _zipper(v1, index))
    v1 = _add(v1, _zipper(v0, index))
    return v0, v1, mul0, mul1


def _lanes(packets: torch.Tensor) -> torch.Tensor:
    """(n, P, 32) uint8 -> (P, 4, n, 2) int64: little-endian 64-bit
    lanes as [lo, hi] 32-bit words."""
    n, p, _ = packets.shape
    b = packets.reshape(n, p, 4, 2, 4).to(torch.int64)
    words = (b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16)
             | (b[..., 3] << 24))                      # (n, P, 4, 2)
    return words.permute(1, 2, 0, 3)


def _remainder_packet(tail: torch.Tensor) -> torch.Tensor:
    """(n, r) uint8, 0 < r < 32 -> the padded final packet (n, 32)
    (cf. `_remainder_packet`, highwayhash_jax.py:196)."""
    n, r = tail.shape
    mod4, base = r & 3, r & ~3
    packet = torch.zeros((n, 32), dtype=torch.uint8, device=tail.device)
    packet[:, :base] = tail[:, :base]
    if r & 16:
        packet[:, 28:] = tail[:, base + mod4 - 4:base + mod4]
    elif mod4:
        packet[:, 16] = tail[:, base]
        packet[:, 17] = tail[:, base + (mod4 >> 1)]
        packet[:, 18] = tail[:, base + mod4 - 1]
    return packet


def _shl(a: torch.Tensor, s: int) -> torch.Tensor:
    """64-bit left shift of [lo, hi] by 0 < s < 32."""
    lo, hi = a[..., 0], a[..., 1]
    return torch.stack([(lo << s) & M32, ((hi << s) | (lo >> (32 - s))) & M32],
                       dim=-1)


def _modular_reduction(a3: torch.Tensor, a2: torch.Tensor, a1: torch.Tensor,
                       a0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(m1, m0) of `ModularReduction`, native/highwayhash.cc:207."""
    a3 = a3.clone()
    a3[..., 1] &= 0x3FFFFFFF
    top = a2[..., 1]
    m1 = a1 ^ _shl(a3, 1) ^ _shl(a3, 2)
    m1[..., 0] ^= (top >> 31) ^ (top >> 30)
    return m1, a0 ^ _shl(a2, 1) ^ _shl(a2, 2)


def _finalize(state, index: torch.Tensor) -> torch.Tensor:
    """10 permute rounds + modular reduction -> (n, 32) uint8."""
    order = torch.tensor([2, 3, 0, 1], device=index.device)
    for _ in range(10):
        # Permuted lane i is v0 lane order[i] rotated by 32: lo <-> hi.
        state = _update(state, state[0][order].flip(-1), index)
    v0, v1, mul0, mul1 = state
    a = _add(v1, mul1)
    b = _add(v0, mul0)
    m1a, m0a = _modular_reduction(a[1], a[0], b[1], b[0])
    m1b, m0b = _modular_reduction(a[3], a[2], b[3], b[2])
    w = torch.stack([m0a, m1a, m0b, m1b], dim=1)       # (n, 4, 2) [lo, hi]
    shifts = torch.arange(0, 32, 8, dtype=torch.int64, device=w.device)
    return ((w[..., None] >> shifts) & 0xFF).to(torch.uint8).reshape(-1, 32)


def _init_state(n: int, key: bytes, device):
    k = [int(v) for v in np.frombuffer(key, dtype="<u8")]
    rot = [((v >> 32) | (v << 32)) & ((1 << 64) - 1) for v in k]
    return (_word([a ^ b for a, b in zip(INIT0, k)], n, device),
            _word([a ^ b for a, b in zip(INIT1, rot)], n, device),
            _word(INIT0, n, device), _word(INIT1, n, device))


def hh256_rows_ref(x: torch.Tensor, key: bytes = MAGIC_KEY) -> torch.Tensor:
    """(n, L) uint8 -> (n, 32) uint8 HighwayHash-256 digests, plain torch
    ops on x's device.  Any L, including 0."""
    if x.dtype != torch.uint8 or x.dim() != 2:
        raise TypeError("hh256_rows_ref expects an (n, L) uint8 tensor")
    if len(key) != 32:
        raise ValueError("key must be 32 bytes")
    n, length = x.shape
    index = torch.tensor(_ZIPPER, device=x.device)
    state = _init_state(n, key, x.device)
    n_packets = length // 32
    if n_packets:
        lanes = _lanes(x[:, :n_packets * 32].reshape(n, n_packets, 32))
        for p in range(n_packets):
            state = _update(state, lanes[p], index)
    r = length % 32
    if r:
        v0, v1, mul0, mul1 = state
        v0 = _add(v0, torch.full_like(v0, r))        # v0 += (r << 32) + r
        v1 = ((v1 << r) | (v1 >> (32 - r))) & M32     # each half rotl r
        lanes = _lanes(_remainder_packet(x[:, n_packets * 32:])[:, None])
        state = _update((v0, v1, mul0, mul1), lanes[0], index)
    return _finalize(state, index)
