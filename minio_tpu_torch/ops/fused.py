"""Codec + bitrot digest over one device buffer: the PUT, GET and heal
programs.

Counterpart of minio_tpu/ops/fused.py:94-213.  Each call copies its
input bytes to the device once; the GF(2^8) kernel and the digest both
read that one tensor, one after the other on the same stream, and the
host gets back only what it needs (parity or rebuilt rows, and the
32-byte digests).  Output layouts are the JAX package's:

- `encode_and_hash`: parity (B, M, S) and digests (K+M, B, 32),
  shard-major to match the frame writer's (n_shards, n_blocks) order;
- `verify_and_transform`: digests of the input rows (B, K, 32) and the
  rebuilt target rows (B, T, S), or None when there are no targets;
- `hash_rows`: digests (N, 32) of N rows (heal's frames of rebuilt rows,
  the coalescer's digest dispatches).  It is the counterpart of the JAX
  `hash_rows_async`: every launch here is asynchronous already, so it
  returns the tensor on the device and the caller syncs when it copies
  the digests back.

An input already on the device (a coalescer lane's staged batch, a cached
shard batch) passes straight through; bytes from the host are placed with
`devices.put`, which counts them in the ledger of ops/devcache.py.

`ITEMS` counts, per kernel, the work items the programs compute: one per
direct call, and the number of requests packed into a coalesced dispatch
(the `items` argument).  Launches (the wrappers' counts) equal the items
when nothing is coalesced and are at most the items otherwise.

The digest is the object's recorded bitrot algorithm: mxh256
(ops/mxhash_torch.py) or HighwayHash-256 (ops/highwayhash_cuda.py, the
hand-written kernel on the card).  sha256 and blake2b512 have no device
program, here or in the JAX package: they take the host route
(`HOST_ALGOS`, hashlib through storage/bitrot_io.host_hash_batch), chosen
by the algorithm and never as a fallback, while the GF(2^8) work of the
same call still runs on the device.  The digests of a host-route call
are a CPU tensor, taken from the host copy of the input when the caller
passed one.  `check_algo` is the gate of the device digests: any other
name raises.
"""

from __future__ import annotations

import functools
import threading

import torch

import numpy as np

from ..storage import bitrot_io
from . import devices
from .erasure_torch import ReedSolomon
from .highwayhash import MAGIC_KEY
from .highwayhash_cuda import hh256_rows
from .mxhash_torch import mxh256_rows

# Algorithms with a device digest (usable in the fused programs).
DEVICE_ALGOS = ("mxh256", "highwayhash256S", "highwayhash256")
#: Algorithms with no device program: their digests are hashlib's.
HOST_ALGOS = bitrot_io.HOST_ALGOS

#: Work items per kernel since the last reset (see the module docstring).
ITEMS = {"gf_matmul": 0, "hh256": 0, "mxh256": 0}
_ITEMS_LOCK = threading.Lock()


def _count_items(algo: str | None, gf: bool, items: int) -> None:
    with _ITEMS_LOCK:
        if algo is not None and algo not in HOST_ALGOS:
            ITEMS["mxh256" if algo == "mxh256" else "hh256"] += items
        if gf:
            ITEMS["gf_matmul"] += items


def reset_items() -> None:
    with _ITEMS_LOCK:
        for k in ITEMS:
            ITEMS[k] = 0


def check_algo(algo: str) -> None:
    """Raise unless `algo` has a device digest here."""
    if algo not in DEVICE_ALGOS:
        raise NotImplementedError(
            f"bitrot algorithm {algo!r} has no device program (device "
            f"digests: {', '.join(DEVICE_ALGOS)})")


def is_host_algo(algo: str) -> bool:
    """Whether `algo` takes the host route; otherwise `check_algo` must
    pass (an unknown name raises)."""
    if algo in HOST_ALGOS:
        return True
    check_algo(algo)
    return False


def _host_digests(x, algo: str) -> torch.Tensor:
    """(..., S) rows (numpy, or a tensor on any device) -> (..., hs)
    hashlib digests as a CPU tensor."""
    a = x if isinstance(x, np.ndarray) else x.cpu().numpy()
    d = bitrot_io.host_hash_batch(a.reshape(-1, a.shape[-1]), algo)
    return torch.from_numpy(d.reshape(*a.shape[:-1], d.shape[-1]))


@functools.lru_cache(maxsize=64)
def _codec(k: int, m: int, device: str) -> ReedSolomon:
    return ReedSolomon(k, m, device=device)


def _digest_rows(x: torch.Tensor, algo: str) -> torch.Tensor:
    """(..., S) uint8 -> (..., 32): the algorithm's device digest of
    every row."""
    rows = x.flatten(0, -2).contiguous()
    if algo == "mxh256":
        d = mxh256_rows(rows)
    else:
        d = hh256_rows(rows, MAGIC_KEY)
    return d.reshape(*x.shape[:-1], 32)


def hash_rows(x, algo: str, device=None, items: int = 1) -> torch.Tensor:
    """((N, S) rows) -> (N, 32) digests on the device (None means the
    CUDA card; "cpu" runs the plain versions); a host-route algorithm's
    (N, hs) digests on the host."""
    if is_host_algo(algo):
        if len(getattr(x, "shape", ())) != 2:
            raise ValueError("hash_rows takes (N, S) rows")
        return _host_digests(x, algo)
    xt = devices.put(x, devices.resolve(device))
    if xt.dim() != 2:
        raise ValueError(f"hash_rows takes (N, S) rows, got "
                         f"{tuple(xt.shape)}")
    _count_items(algo, False, items)
    return _digest_rows(xt, algo)


def encode_and_hash(x, k: int, m: int, algo: str = "mxh256", device=None,
                    items: int = 1):
    """((B, K, S) data) -> ((B, M, S) parity, (K+M, B, 32) digests).

    The PUT program: parity and the bitrot digest of every shard-block in
    one pass over the device copy of `x`.  Results are tensors on the
    device (None means the CUDA card; "cpu" runs the plain versions),
    but a host-route algorithm's digests, which are on the host.
    """
    host = is_host_algo(algo)
    dev = devices.resolve(device)
    xt = devices.put(x, dev)
    _count_items(algo, True, items)
    parity = _codec(k, m, str(dev)).encode_blocks(xt)
    if host:
        digests = torch.cat([_host_digests(x if isinstance(x, np.ndarray)
                                           else xt, algo),
                             _host_digests(parity, algo)], dim=1)
    else:
        # One digest launch over all K+M rows of the batch.
        digests = _digest_rows(torch.cat([xt, parity], dim=1), algo)
    return parity, digests.transpose(0, 1).contiguous()


def verify_and_transform(x, k: int, m: int, sources: tuple[int, ...],
                         targets: tuple[int, ...], algo: str = "mxh256",
                         device=None, items: int = 1):
    """((B, K, S) shard rows) -> ((B, K, 32) digests, (B, T, S) rebuilt).

    Digests are of the INPUT rows (the caller compares them with the
    frame hashes); rebuilt rows are the GF transform sources -> targets,
    parity rows included.  With no targets only the digest runs and the
    second result is None.  A host-route algorithm's digests are hashed
    on the host, and with no targets nothing goes to the device.
    """
    if is_host_algo(algo):
        digests = _host_digests(x, algo)
        if not targets:
            return digests, None
        dev = devices.resolve(device)
        xt = devices.put(x, dev)
        _count_items(algo, True, items)
        return digests, _codec(k, m, str(dev)).transform_blocks(
            xt, tuple(sources), tuple(targets))
    dev = devices.resolve(device)
    xt = devices.put(x, dev)
    _count_items(algo, bool(targets), items)
    digests = _digest_rows(xt, algo)
    if not targets:
        return digests, None
    out = _codec(k, m, str(dev)).transform_blocks(xt, tuple(sources),
                                                  tuple(targets))
    return digests, out


def transform(x, k: int, m: int, sources: tuple[int, ...],
              targets: tuple[int, ...], device=None,
              items: int = 1) -> torch.Tensor:
    """((B, K, S) rows of shards `sources`) -> (B, T, S) rows of shards
    `targets` on the device: the GF(2^8) program alone, for legacy
    whole-file objects, whose digests cover whole shard files and were
    checked before (storage/bitrot_io.whole_file_digests)."""
    dev = devices.resolve(device)
    xt = devices.put(x, dev)
    _count_items(None, True, items)
    return _codec(k, m, str(dev)).transform_blocks(xt, tuple(sources),
                                                   tuple(targets))
