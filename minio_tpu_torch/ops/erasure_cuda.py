"""The hand-written Hopper GF(2^8) kernel (csrc/gf_matmul.cu): build,
binding and wrapper.

Replaces the Pallas TPU kernels `erasure_pallas._kernel` and
`_kernel_salted` (minio_tpu/ops/erasure_pallas.py:58,64, launched by
`_pallas_gf_matmul` at :73).  ops/cuda_build.py compiles the source with
nvcc into a shared library with a plain C interface at first use and
loads it with ctypes.

`gf_matmul_blocks` launches the kernel for a CUDA tensor and raises if
it cannot; for a CPU tensor it runs the plain PyTorch version
(`erasure_torch.gf_matmul_blocks_ref`).  `LAUNCHES` counts kernel
launches, so a run can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from . import cuda_build, erasure_torch

#: Kernel launches since the last reset (the wrapper adds one per launch,
#: under _LAUNCHES_LOCK: concurrent heals launch from several threads).
LAUNCHES = 0
_LAUNCHES_LOCK = threading.Lock()

LIBRARY = cuda_build.Library(
    "gf_matmul.cu", "gf_matmul_launch",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
     ctypes.c_void_p])
_TABLES: dict[tuple, torch.Tensor] = {}
_TABLES_LOCK = threading.Lock()
_TABLES_MAX = 4096


def nibble_tables(mat_bits) -> np.ndarray:
    """(8R, 8C) plane-major bit matrix -> (G, C, 2, 16) uint32 row-packed
    nibble tables, G = ceil(R / 4).

    Byte r' of entry [g, c, 0, v] is M[4g + r', c] * v and byte r' of
    [g, c, 1, v] is M[4g + r', c] * (v << 4); rows past R are 0.  The
    column products M[r, c] * 2^j are read straight off the bit matrix:
    column j*C+c of output rows i*R+r holds bit i of M[r, c] * 2^j.
    Works for any GF(2)-linear byte map, so it is exact for every matrix
    the codec builds.  1 KiB for EC:8+4.
    """
    m = np.asarray(mat_bits).astype(np.uint8)
    r8, c8 = m.shape
    rows, cols = r8 // 8, c8 // 8
    m = m.reshape(8, rows, 8, cols)                         # [i, r, j, c]
    weights = (1 << np.arange(8, dtype=np.uint32)).reshape(8, 1, 1, 1)
    col = (m.astype(np.uint32) * weights).sum(axis=0)       # [r, j, c]
    col = col.transpose(0, 2, 1).astype(np.uint8)           # [r, c, j]
    v = np.arange(16)
    sel = ((v[:, None] >> np.arange(4)[None, :]) & 1).astype(bool)  # [v, j]
    groups = -(-rows // 4)
    prod = np.zeros((4 * groups, cols, 2, 16), dtype=np.uint8)  # [r, c, h, v]
    for j in range(4):
        prod[:rows, :, 0] ^= np.where(sel[:, j], col[:, :, j, None], 0
                                      ).astype(np.uint8)
        prod[:rows, :, 1] ^= np.where(sel[:, j], col[:, :, j + 4, None], 0
                                      ).astype(np.uint8)
    packed = prod.reshape(groups, 4, cols, 2, 16).transpose(0, 2, 3, 4, 1)
    return np.ascontiguousarray(packed).view("<u4")[..., 0].astype(np.uint32)


def _device_tables(mat_bits, device: torch.device) -> torch.Tensor:
    """Nibble tables on `device` (their bytes, as uint8), cached per
    (matrix, device).

    Threads share the cache.  A caller holds the tensor it got until its
    launch is enqueued, so a clear() by another thread cannot free it
    before then; after that the caching allocator hands its block out
    again only in the stream's order, behind the launch."""
    m = np.asarray(mat_bits).astype(np.uint8)
    key = (m.shape, m.tobytes(), str(device))
    with _TABLES_LOCK:
        t = _TABLES.get(key)
    if t is None:
        t = torch.from_numpy(nibble_tables(m).view(np.uint8)).to(device)
        if t.is_cuda:
            # Threads launch on streams of their own (the coalescer's
            # lanes): the copy must land before another stream reads it.
            torch.cuda.current_stream(t.device).synchronize()
        with _TABLES_LOCK:
            if len(_TABLES) >= _TABLES_MAX:
                _TABLES.clear()
            t = _TABLES.setdefault(key, t)
    return t


def _count_launch() -> None:
    global LAUNCHES
    with _LAUNCHES_LOCK:
        LAUNCHES += 1


def gf_matmul_blocks(mat_bits, x: torch.Tensor, rows: int,
                     salt: int | None = None) -> torch.Tensor:
    """Batched GF(2^8) matmul: (B, C, S) uint8 -> (B, R, S) uint8.

    mat_bits: (8R, 8C) plane-major bit matrix with R == rows.  A CUDA
    `x` launches the kernel on the current stream (any S, any B up to
    65535); a CPU `x` runs the plain version.  `salt`: the low byte is
    XORed into every input byte inside the kernel.
    """
    if not isinstance(x, torch.Tensor) or x.dtype != torch.uint8 \
            or x.dim() != 3:
        raise TypeError("x must be a (B, C, S) uint8 tensor")
    b, c, s = x.shape
    mshape = tuple(np.shape(mat_bits))
    if mshape != (8 * rows, 8 * c):
        raise ValueError(f"matrix {mshape} does not fit {rows} rows x "
                         f"{c} input rows")
    if x.device.type == "cpu":
        return erasure_torch.gf_matmul_blocks_ref(mat_bits, x, rows,
                                                  salt=salt)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if b > 65535:
        raise ValueError(f"batch {b} > 65535 blocks per launch")
    if rows * c * 32 > 227 * 1024:
        raise ValueError(f"{rows}x{c} tables exceed shared memory")
    out = torch.empty((b, rows, s), dtype=torch.uint8, device=x.device)
    if b == 0 or s == 0 or rows == 0:
        return out
    tables = _device_tables(mat_bits, x.device)
    launch = LIBRARY.fn()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = launch(
            tables.data_ptr(), x.data_ptr(), out.data_ptr(), b, rows, c, s,
            0 if salt is None else int(salt) & 0xFF, stream)
    if err != 0:
        raise RuntimeError(f"gf_matmul kernel launch failed: CUDA error "
                           f"{err}")
    _count_launch()
    return out
