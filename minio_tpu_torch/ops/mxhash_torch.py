"""mxh256 on torch tensors: the digest as exact integer matmuls.

Counterpart of minio_tpu/ops/mxhash_jax.py, which the JAX package left
to XLA rather than to a Pallas kernel; here it is plain torch ops and a
`torch.matmul` on the tensor's device.  Spec: ops/mxhash.py.

Every tree level is a (rows, 256) x (256, 8) product of int8 values,
|sum| <= 256 * 128 * 128 = 2^22.  The product runs in float64, where
that is exact, and which no process-wide TF32 or matmul-precision setting
touches: the digest stays exact whatever precision the application has
chosen for its own float32 products, from any thread.

`LAUNCHES` counts the calls on a CUDA tensor (one digest program of a few
device ops each), so a run can read how often its path ran mxh256 on the
card; calls on the CPU are not counted.
"""

from __future__ import annotations

import functools
import threading

import numpy as np
import torch

from . import mxhash

#: mxh256_rows calls on the card since the last reset (under
#: _LAUNCHES_LOCK: heal workers hash from several threads).
LAUNCHES = 0
_LAUNCHES_LOCK = threading.Lock()


def _count_launch() -> None:
    global LAUNCHES
    with _LAUNCHES_LOCK:
        LAUNCHES += 1


@functools.lru_cache(maxsize=8)
def _matrix_a(device: str) -> torch.Tensor:
    a = torch.from_numpy(mxhash.matrix_a().astype(np.float64)).to(device)
    if a.is_cuda:
        # Shared by every stream (the coalescer's lanes): the copy must
        # land before another stream reads it.
        torch.cuda.current_stream(a.device).synchronize()
    return a


def _level(rows: torch.Tensor) -> torch.Tensor:
    """(n, L) uint8 -> (n, 32*ceil(L/256)) uint8: one tree level."""
    n, ln = rows.shape
    pad = (-ln) % mxhash.CHUNK
    if pad or ln == 0:
        rows = torch.nn.functional.pad(rows, (0, max(pad, mxhash.CHUNK - ln)))
    chunks = rows.reshape(n, -1, mxhash.CHUNK).view(torch.int8)
    h = torch.matmul(chunks.to(torch.float64),
                     _matrix_a(str(rows.device)))            # (n, nc, 8)
    # Words serialise little-endian: byte k of word w -> offset 4w + k.
    return h.to(torch.int32).contiguous().view(torch.uint8).reshape(n, -1)


def mxh256_rows(x: torch.Tensor) -> torch.Tensor:
    """(n, L) uint8 tensor -> (n, 32) uint8 digests on the same device."""
    if x.dtype != torch.uint8 or x.dim() != 2:
        raise TypeError("mxh256_rows expects an (n, L) uint8 tensor")
    n, ln = x.shape
    if n == 0:
        return torch.empty((0, mxhash.DIGEST_SIZE), dtype=torch.uint8,
                           device=x.device)
    cur = x.contiguous()
    while True:
        cur = _level(cur)
        if cur.shape[1] == mxhash.DIGEST_SIZE:
            break
    tag = torch.from_numpy(mxhash.length_tag(ln).copy()).to(x.device)
    if x.device.type == "cuda":
        _count_launch()
    return cur ^ tag[None, :]
