"""Streaming bitrot framing: [32-byte digest | shard block] per block.

The subset of minio_tpu/storage/bitrot_io.py that the erasure data path,
heal and multipart use, with the same on-disk layout (the reference's
streaming bitrot writer/reader, cmd/bitrot-streaming.go): a shard file
of logical size L and shard block size S is ceil(L/S) frames of
`32 + min(S, remaining)` bytes.

The digest of a frame is the object's recorded algorithm.  mxh256 and
HighwayHash256S come from the device programs in ops/fused.py; sha256
and blake2b512 have no device program (here or in the JAX package) and
take the host route, hashlib (`host_hash_batch`, the JAX package's
`_hash_batch` rows for them).  This package writes mxh256,
HighwayHash256S and sha256 and reads all five, the whole-file digest of
legacy xl.json objects (`whole_file_digest`) included.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np

from .errors import ErrFileCorrupt

# Digest size of every algorithm an object may record (cf. cmd/bitrot.go:39).
DIGEST_SIZES = {"mxh256": 32, "highwayhash256S": 32, "highwayhash256": 32,
                "sha256": 32, "blake2b512": 64}

# Default for reading frames whose metadata predates per-object algo
# recording.
DEFAULT_ALGO = "highwayhash256S"

# Algorithms selectable for new writes (32-byte digests only, so the
# frame geometry, and so the shard file sizes, do not depend on it).
WRITE_ALGORITHMS = ("mxh256", "highwayhash256S", "sha256")

#: The host route: algorithms with no device program, by hashlib name
#: (cf. the hashlib rows of the JAX registry, storage/bitrot_io.py).
_HASHLIB = {"sha256": "sha256", "blake2b512": "blake2b"}
HOST_ALGOS = tuple(_HASHLIB)


def write_algo() -> str:
    """Bitrot algorithm for NEW objects: env MTPU_BITROT_ALGO, default
    mxh256.  An unknown name is ValueError (checked again by the boot's
    self-tests), not a storage corruption error."""
    algo = os.environ.get("MTPU_BITROT_ALGO", "mxh256")
    if algo not in WRITE_ALGORITHMS:
        raise ValueError(
            f"MTPU_BITROT_ALGO={algo!r} not one of {WRITE_ALGORITHMS}")
    return algo


def host_hash_batch(blocks: np.ndarray, algo: str) -> np.ndarray:
    """(n, L) uint8 -> (n, digest_size) digests of a host-route algorithm
    (sha256, blake2b512), one hashlib call a row.  Any other algorithm
    raises ValueError: its digest runs on the device."""
    name = _HASHLIB.get(algo)
    if name is None:
        raise ValueError(f"bitrot algorithm {algo!r} has no host route")
    blocks = np.ascontiguousarray(blocks)
    out = np.empty((blocks.shape[0], DIGEST_SIZES[algo]), dtype=np.uint8)
    for i in range(blocks.shape[0]):
        out[i] = np.frombuffer(hashlib.new(name, blocks[i]).digest(),
                               dtype=np.uint8)
    return out


def whole_file_digests(files: list, algo: str = DEFAULT_ALGO,
                       device=None) -> list[bytes]:
    """Legacy whole-file bitrot (cf. cmd/bitrot-whole.go): one digest over
    each whole shard file.  A host-route algorithm is hashlib; HighwayHash
    (and mxh256) runs each file as one row of its whole length through
    the device program (ops/fused.hash_rows) on `device` (None = the CUDA
    card), files of one length in one call: the shard files of one part
    all have the same length."""
    digest_size(algo)                      # an unknown algorithm raises
    if algo in HOST_ALGOS:
        return [hashlib.new(_HASHLIB[algo], f).digest() for f in files]
    from ..ops import fused
    out: list = [None] * len(files)
    by_len: dict[int, list[int]] = {}
    for i, f in enumerate(files):
        by_len.setdefault(len(f), []).append(i)
    for length, idx in by_len.items():
        rows = np.empty((len(idx), length), dtype=np.uint8)
        for r, i in enumerate(idx):
            rows[r] = np.frombuffer(files[i], dtype=np.uint8)
        got = fused.hash_rows(rows, algo, device=device).cpu().numpy()
        for r, i in enumerate(idx):
            out[i] = got[r].tobytes()
    return out


def whole_file_digest(data, algo: str = DEFAULT_ALGO, device=None) -> bytes:
    """The whole-file digest of one shard file (`whole_file_digests`)."""
    return whole_file_digests([data], algo, device)[0]


def verify_whole_file(data, want: bytes, algo: str = DEFAULT_ALGO,
                      device=None) -> None:
    if whole_file_digest(data, algo, device) != want:
        raise ErrFileCorrupt(f"whole-file bitrot mismatch ({algo})")


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
