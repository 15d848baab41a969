"""Streaming bitrot framing: [32-byte digest | shard block] per block.

The subset of minio_tpu/storage/bitrot_io.py that the erasure data path
uses, with the same on-disk layout (the reference's streaming bitrot
writer/reader, cmd/bitrot-streaming.go): a shard file of logical size L
and shard block size S is ceil(L/S) frames of `32 + min(S, remaining)`
bytes.  Hashing itself is not here: the digests come from the device
programs in ops/fused.py, and mxh256 is the one algorithm this package
writes and verifies.
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
    mxh256.  This package writes only mxh256; naming another valid
    algorithm is NotImplementedError, an unknown one ValueError."""
    algo = os.environ.get("MTPU_BITROT_ALGO", "mxh256")
    if algo not in WRITE_ALGORITHMS:
        raise ValueError(
            f"MTPU_BITROT_ALGO={algo!r} not one of {WRITE_ALGORITHMS}")
    if algo != "mxh256":
        raise NotImplementedError(
            f"MTPU_BITROT_ALGO={algo!r}: minio_tpu_torch writes mxh256 "
            "only; other algorithms come with later slices of the port")
    return algo


def digest_size(algo: str = DEFAULT_ALGO) -> int:
    try:
        return DIGEST_SIZES[algo]
    except KeyError:
        raise ErrFileCorrupt(f"unknown bitrot algorithm {algo!r}") from None


def frame_shard_views(blocks: np.ndarray, parity: np.ndarray,
                      digests: np.ndarray,
                      algo: str = DEFAULT_ALGO) -> list[np.ndarray]:
    """The on-disk frame layout over one batch.

    blocks (nb, K, S) and parity (nb, M, S) in the codec's block-major
    layout, digests (K+M, nb, hs) shard-major.  Returns K+M per-shard
    views over one (K+M, nb, hs+S) buffer: shard i's frames, contiguous.
    """
    hs = digest_size(algo)
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
