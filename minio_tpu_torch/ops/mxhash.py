"""Copy of minio_tpu/ops/mxhash.py: the port keeps its own, so that it imports
nothing of the JAX package.

mxh256: a TPU-native bitrot checksum built from exact integer matmuls.

Role: the device-fast bitrot algorithm in the registry
(storage/bitrot_io.py), the role HighwayHash256S plays in the reference
(reference cmd/bitrot.go:39).  HighwayHash's dependent 64-bit
multiply chain has no fast TPU lowering (measured ~1-2 GB/s on the VPU,
see ops/highwayhash_pallas.py); mxh256 is designed so the whole digest is
MXU work: bytes enter a matmul directly, with NO bit-plane unpack and NO
sequential dependency, so verify runs at erasure-codec speed.

Construction (spec, implemented twice: here in exact-integer numpy — the
golden reference — and on the device in ops/mxhash_torch.py):

  - The message is zero-padded to a multiple of C=256 bytes and split
    into chunks; bytes are read as int8 (two's complement).
  - Each chunk is multiplied by a fixed pseudorandom matrix A of shape
    (256, 8) with ODD int8 entries, accumulating exactly in int32:
    |sum| <= 256*128*255 < 2^24, so the arithmetic is exact integer
    linear algebra — no modular reduction, no rounding, bit-identical on
    any backend.  The 8 int32 words are serialized little-endian into a
    32-byte chunk digest.
  - The (n_chunks * 32)-byte digest string is hashed again by the same
    rule, shrinking 8x per level, until one 32-byte digest remains
    (a static number of levels for a static input length).
  - The final digest is XORed with a 32-byte length tag
    SHA256(seed || len) — levels only see zero-padded content, the tag
    pins the exact byte length (kills zero-pad/length ambiguity).

Detection strength (bitrot = NON-adversarial media corruption, the same
threat model as the reference's fixed-key HighwayHash use):
  - any single corrupted byte is detected with certainty (A's entries are
    odd, hence nonzero: one byte's delta changes all 8 words);
  - a corruption confined to one chunk escapes only if its delta vector
    is an exact integer null vector of A^T — probability ~2^-56 over the
    pseudorandom A for a 2-byte error, astronomically less for bursts;
  - corruption spanning chunks must additionally collide through every
    higher level.
mxh256 is an error-detection code, not a cryptographic MAC.

Matrix/tag material derives from SHA-256 streams of fixed seeds, so the
function is a stable public spec with golden vectors (ops/selftest.py).
"""

from __future__ import annotations

import functools
import hashlib
import struct

import numpy as np

CHUNK = 256        # bytes hashed per matmul row
WORDS = 8          # int32 accumulators per chunk
DIGEST_SIZE = 4 * WORDS   # 32 bytes, same frame slot as HighwayHash256

_SEED_A = b"minio-tpu/mxh256/A/v1"
_SEED_LEN = b"minio-tpu/mxh256/len/v1"


def _sha_stream(seed: bytes, nbytes: int) -> bytes:
    out = bytearray()
    i = 0
    while len(out) < nbytes:
        out += hashlib.sha256(seed + struct.pack("<Q", i)).digest()
        i += 1
    return bytes(out[:nbytes])


@functools.lru_cache(maxsize=1)
def matrix_a() -> np.ndarray:
    """The fixed (CHUNK, WORDS) odd-int8 mixing matrix (spec constant)."""
    raw = np.frombuffer(_sha_stream(_SEED_A, CHUNK * WORDS), dtype=np.uint8)
    return (raw | 1).astype(np.int8).reshape(CHUNK, WORDS)


def length_tag(n: int) -> np.ndarray:
    """32-byte length tag XORed into the final digest."""
    d = hashlib.sha256(_SEED_LEN + struct.pack("<Q", n)).digest()
    return np.frombuffer(d, dtype=np.uint8)


def _level_np(rows: np.ndarray) -> np.ndarray:
    """One tree level: (n, L) uint8 -> (n, 32*ceil(L/256)) uint8."""
    n, ln = rows.shape
    pad = (-ln) % CHUNK
    if pad or ln == 0:
        rows = np.pad(rows, ((0, 0), (0, max(pad, CHUNK - ln))))
    chunks = rows.reshape(n, -1, CHUNK).view(np.int8)
    # Exact: int32 accumulation of int8 x int8 products.
    h = chunks.astype(np.int32) @ matrix_a().astype(np.int32)  # (n, nc, 8)
    return np.ascontiguousarray(h.astype("<i4")).view(np.uint8).reshape(n, -1)


def mxh256_batch(blocks: np.ndarray) -> np.ndarray:
    """(n, L) uint8 -> (n, 32) uint8 digests (the golden host path)."""
    blocks = np.ascontiguousarray(np.asarray(blocks, dtype=np.uint8))
    if blocks.ndim != 2:
        raise ValueError("mxh256_batch expects (n, L)")
    n, ln = blocks.shape
    cur = blocks
    while True:
        cur = _level_np(cur)
        if cur.shape[1] == DIGEST_SIZE:
            break
    return cur ^ length_tag(ln)[None, :]


def mxh256(data: bytes) -> bytes:
    """Digest of one byte string."""
    buf = np.frombuffer(data, dtype=np.uint8)[None, :]
    return mxh256_batch(np.ascontiguousarray(buf))[0].tobytes()
