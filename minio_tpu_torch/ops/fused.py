"""Codec + bitrot digest over one device buffer: the PUT and GET programs.

Counterpart of minio_tpu/ops/fused.py:132-213.  Each call copies its
input bytes to the device once; the GF(2^8) kernel and the mxh256 digest
both read that one tensor, one after the other on the same stream, and
the host gets back only what it needs (parity or rebuilt rows, and the
32-byte digests).  Output layouts are the JAX package's:

- `encode_and_hash`: parity (B, M, S) and digests (K+M, B, 32),
  shard-major to match the frame writer's (n_shards, n_blocks) order;
- `verify_and_transform`: digests of the input rows (B, K, 32) and the
  rebuilt target rows (B, T, S), or None when there are no targets.

mxh256 is the one digest with a device path in this package.  Objects
recorded under HighwayHash need the HighwayHash device path, which a
later slice of the port adds.
"""

from __future__ import annotations

import functools

import torch

from . import devices
from .erasure_torch import ReedSolomon
from .mxhash_torch import mxh256_rows

# Algorithms with a device digest in this package.
DEVICE_ALGOS = ("mxh256",)


def check_algo(algo: str) -> None:
    """Raise unless `algo` has a device digest here."""
    if algo in DEVICE_ALGOS:
        return
    if algo.startswith("highwayhash"):
        raise NotImplementedError(
            f"bitrot algorithm {algo!r}: the HighwayHash device path is "
            "not ported yet (a later slice of the PyTorch port adds it); "
            "read this object with the JAX package")
    raise NotImplementedError(f"bitrot algorithm {algo!r} has no device "
                              "path in minio_tpu_torch")


@functools.lru_cache(maxsize=64)
def _codec(k: int, m: int, device: str) -> ReedSolomon:
    return ReedSolomon(k, m, device=device)


def _rows_digest(x: torch.Tensor) -> torch.Tensor:
    """(B, R, S) -> (B, R, 32) mxh256 of every row."""
    b, r, s = x.shape
    return mxh256_rows(x.reshape(b * r, s)).reshape(b, r, 32)


def encode_and_hash(x, k: int, m: int, algo: str = "mxh256", device=None):
    """((B, K, S) data) -> ((B, M, S) parity, (K+M, B, 32) digests).

    The PUT program: parity and the bitrot digest of every shard-block in
    one pass over the device copy of `x`.  Results are tensors on the
    device (None means the CUDA card; "cpu" runs the plain versions).
    """
    check_algo(algo)
    dev = devices.resolve(device)
    xt = devices.put(x, dev)
    parity = _codec(k, m, str(dev)).encode_blocks(xt)
    digests = torch.cat([_rows_digest(xt), _rows_digest(parity)], dim=1)
    return parity, digests.transpose(0, 1).contiguous()


def verify_and_transform(x, k: int, m: int, sources: tuple[int, ...],
                         targets: tuple[int, ...], algo: str = "mxh256",
                         device=None):
    """((B, K, S) shard rows) -> ((B, K, 32) digests, (B, T, S) rebuilt).

    Digests are of the INPUT rows (the caller compares them with the
    frame hashes); rebuilt rows are the GF transform sources -> targets.
    With no targets only the digest runs and the second result is None.
    """
    check_algo(algo)
    dev = devices.resolve(device)
    xt = devices.put(x, dev)
    digests = _rows_digest(xt)
    if not targets:
        return digests, None
    out = _codec(k, m, str(dev)).transform_blocks(xt, tuple(sources),
                                                  tuple(targets))
    return digests, out
