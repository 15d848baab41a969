"""Copy of minio_tpu/utils/siphash.py: the port keeps its own, so that it imports
nothing of the JAX package, and both packages place every name on the
same set.

SipHash-2-4 — used for object -> erasure-set placement.

The reference routes each object to a set with
sipHashMod(key, cardinality, deploymentID) — SipHash-2-4 keyed by the
deployment UUID (cmd/erasure-sets.go:734). Implementing the
same function keeps our placement decisions identical for a given layout.
"""

from __future__ import annotations

MASK = (1 << 64) - 1


def _rotl(x: int, b: int) -> int:
    return ((x << b) | (x >> (64 - b))) & MASK


def siphash24(key: bytes, data: bytes) -> int:
    """SipHash-2-4 returning a 64-bit int; key is 16 bytes."""
    if len(key) != 16:
        raise ValueError("key must be 16 bytes")
    k0 = int.from_bytes(key[:8], "little")
    k1 = int.from_bytes(key[8:], "little")
    v0 = k0 ^ 0x736F6D6570736575
    v1 = k1 ^ 0x646F72616E646F6D
    v2 = k0 ^ 0x6C7967656E657261
    v3 = k1 ^ 0x7465646279746573

    def sipround():
        nonlocal v0, v1, v2, v3
        v0 = (v0 + v1) & MASK
        v1 = _rotl(v1, 13)
        v1 ^= v0
        v0 = _rotl(v0, 32)
        v2 = (v2 + v3) & MASK
        v3 = _rotl(v3, 16)
        v3 ^= v2
        v0 = (v0 + v3) & MASK
        v3 = _rotl(v3, 21)
        v3 ^= v0
        v2 = (v2 + v1) & MASK
        v1 = _rotl(v1, 17)
        v1 ^= v2
        v2 = _rotl(v2, 32)

    b = len(data) & 0xFF
    end = len(data) - (len(data) % 8)
    for off in range(0, end, 8):
        m = int.from_bytes(data[off:off + 8], "little")
        v3 ^= m
        sipround()
        sipround()
        v0 ^= m
    m = b << 56
    tail = data[end:]
    m |= int.from_bytes(tail, "little")
    v3 ^= m
    sipround()
    sipround()
    v0 ^= m
    v2 ^= 0xFF
    for _ in range(4):
        sipround()
    return (v0 ^ v1 ^ v2 ^ v3) & MASK


def sip_hash_mod(key: str, cardinality: int, deployment_id: bytes) -> int:
    """Object placement hash (cmd/erasure-sets.go:734)."""
    if cardinality <= 0:
        return -1
    return siphash24(deployment_id, key.encode()) % cardinality
