"""The hand-written Hopper HighwayHash-256 kernel (csrc/hh256.cu): binding
and wrapper.

Replaces the Pallas TPU kernel `highwayhash_pallas._kernel`
(minio_tpu/ops/highwayhash_pallas.py:76, built by `_bulk_fn` at :104)
together with the XLA remainder and finalisation around it
(minio_tpu/ops/highwayhash_jax.py:279-325): one launch hashes every row
from the key to the digest.  ops/cuda_build.py builds the source at first
use.

`hh256_rows` launches the kernel for a CUDA tensor and raises if it
cannot; for a CPU tensor it runs the plain PyTorch version
(`highwayhash_torch.hh256_rows_ref`).  `LAUNCHES` counts kernel launches,
so a run can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from . import cuda_build
from .highwayhash import MAGIC_KEY
from .highwayhash_torch import hh256_rows_ref

#: Kernel launches since the last reset (the wrapper adds one per launch,
#: under _LAUNCHES_LOCK: concurrent heals launch from several threads).
LAUNCHES = 0
_LAUNCHES_LOCK = threading.Lock()

LIBRARY = cuda_build.Library(
    "hh256.cu", "hh256_launch",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
     ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64,
     ctypes.c_void_p])


def _count_launch() -> None:
    global LAUNCHES
    with _LAUNCHES_LOCK:
        LAUNCHES += 1


def hh256_rows(x: torch.Tensor, key: bytes = MAGIC_KEY) -> torch.Tensor:
    """(n, L) uint8 -> (n, 32) uint8 HighwayHash-256 of every row.

    A CUDA `x` launches the kernel on the current stream (any n, any L);
    a CPU `x` runs the plain version.
    """
    if not isinstance(x, torch.Tensor) or x.dtype != torch.uint8 \
            or x.dim() != 2:
        raise TypeError("x must be an (n, L) uint8 tensor")
    if len(key) != 32:
        raise ValueError("key must be 32 bytes")
    if x.device.type == "cpu":
        return hh256_rows_ref(x, key)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    n, length = x.shape
    out = torch.empty((n, 32), dtype=torch.uint8, device=x.device)
    if n == 0:
        return out
    words = [int(w) for w in np.frombuffer(key, dtype="<u8")]
    launch = LIBRARY.fn()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = launch(x.data_ptr(), out.data_ptr(), n, length, *words, stream)
    if err != 0:
        raise RuntimeError(f"hh256 kernel launch failed: CUDA error {err}")
    _count_launch()
    return out
