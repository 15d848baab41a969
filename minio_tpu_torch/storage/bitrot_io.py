"""Streaming bitrot framing: [32-byte digest | shard block] per block.

The subset of minio_tpu/storage/bitrot_io.py that the erasure data path,
heal and multipart use, with the same on-disk layout (the reference's
streaming bitrot writer/reader, cmd/bitrot-streaming.go): a shard file
of logical size L and shard block size S is ceil(L/S) frames of
`32 + min(S, remaining)` bytes.  Hashing itself is not here: every
digest comes from the device programs in ops/fused.py, never from a
host hasher.  This package writes mxh256 and HighwayHash256S and
verifies both.
"""

from __future__ import annotations

import os

import numpy as np

from .errors import ErrFileCorrupt

# Digest size of every algorithm an object may record (cf. cmd/bitrot.go:39).
DIGEST_SIZES = {"mxh256": 32, "highwayhash256S": 32, "highwayhash256": 32,
                "sha256": 32, "blake2b512": 64}

# Default for reading frames whose metadata predates per-object algo
# recording.
DEFAULT_ALGO = "highwayhash256S"

# Algorithms the JAX package may write (32-byte digests only).
WRITE_ALGORITHMS = ("mxh256", "highwayhash256S", "sha256")


def write_algo() -> str:
    """Bitrot algorithm for NEW objects: env MTPU_BITROT_ALGO, default
    mxh256.  This package writes mxh256 and highwayhash256S, the two with
    a device digest; naming sha256 is NotImplementedError, an unknown
    algorithm ValueError."""
    algo = os.environ.get("MTPU_BITROT_ALGO", "mxh256")
    if algo not in WRITE_ALGORITHMS:
        raise ValueError(
            f"MTPU_BITROT_ALGO={algo!r} not one of {WRITE_ALGORITHMS}")
    if algo == "sha256":
        raise NotImplementedError(
            "MTPU_BITROT_ALGO='sha256': minio_tpu_torch has no device "
            "digest for sha256; it writes mxh256 or highwayhash256S")
    return algo


def digest_size(algo: str = DEFAULT_ALGO) -> int:
    try:
        return DIGEST_SIZES[algo]
    except KeyError:
        raise ErrFileCorrupt(f"unknown bitrot algorithm {algo!r}") from None


def bitrot_shard_file_size(size: int, shard_size: int,
                           algo: str = DEFAULT_ALGO) -> int:
    """On-disk size of a shard file of logical size `size`
    (cf. cmd/bitrot.go:146)."""
    if size == 0:
        return 0
    return -(-size // shard_size) * digest_size(algo) + size


def frame_shard_views(blocks: np.ndarray | None, parity: np.ndarray | None,
                      digests: np.ndarray, algo: str = DEFAULT_ALGO,
                      shards: np.ndarray | None = None) -> list[np.ndarray]:
    """The on-disk frame layout over one batch.

    Either `shards` already shard-major (n_shards, nb, S), or blocks
    (nb, K, S) and parity (nb, M, S) in the codec's block-major layout;
    digests (n_shards, nb, hs) shard-major, from the device.  Returns one
    view per shard over one (n_shards, nb, hs+S) buffer: shard i's
    frames, contiguous.
    """
    hs = digest_size(algo)
    if shards is not None:
        n_shards, nb, shard_size = shards.shape
        framed = np.empty((n_shards, nb, hs + shard_size), dtype=np.uint8)
        framed[:, :, hs:] = shards
        framed[:, :, :hs] = digests
        return [framed[i].reshape(-1) for i in range(n_shards)]
    nb, k, shard_size = blocks.shape
    m = parity.shape[1]
    framed = np.empty((k + m, nb, hs + shard_size), dtype=np.uint8)
    framed[:k, :, hs:] = blocks.transpose(1, 0, 2)
    framed[k:, :, hs:] = parity.transpose(1, 0, 2)
    framed[:, :, :hs] = digests
    return [framed[i].reshape(-1) for i in range(k + m)]


def split_frames(buf: np.ndarray, n_frames: int, shard_size: int,
                 algo: str = DEFAULT_ALGO) -> tuple[np.ndarray, np.ndarray]:
    """View `n_frames` whole frames at the start of `buf` as
    (hashes (n, hs), blocks (n, shard_size)); no copy, no verify (the
    device checks the digests)."""
    hs = digest_size(algo)
    frames = buf[:n_frames * (hs + shard_size)].reshape(
        n_frames, hs + shard_size)
    return frames[:, :hs], frames[:, hs:]
