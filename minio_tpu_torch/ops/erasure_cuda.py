"""The hand-written Hopper GF(2^8) kernel (csrc/gf_matmul.cu): build,
binding and wrapper.

Replaces the Pallas TPU kernels `erasure_pallas._kernel` and
`_kernel_salted` (minio_tpu/ops/erasure_pallas.py:58,64, launched by
`_pallas_gf_matmul` at :73).  The source is compiled with nvcc into a
shared library with a plain C interface at first use, into
`minio_tpu_torch/build/` (listed in .gitignore), and loaded with ctypes.

`gf_matmul_blocks` launches the kernel for a CUDA tensor and raises if
it cannot; for a CPU tensor it runs the plain PyTorch version
(`erasure_torch.gf_matmul_blocks_ref`).  `LAUNCHES` counts kernel
launches, so a run can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np
import torch

from . import erasure_torch

PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = PKG_DIR / "csrc" / "gf_matmul.cu"
BUILD_DIR = PKG_DIR / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

#: Kernel launches since the last reset (the wrapper adds one per launch).
LAUNCHES = 0

_LIB = None
_LIB_LOCK = threading.Lock()
_TABLES: dict[tuple, torch.Tensor] = {}


def nvcc() -> str:
    """The nvcc executable: $NVCC, then PATH, then $CUDA_HOME/bin."""
    found = os.environ.get("NVCC") or shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(home) / "bin" / "nvcc")


def library_path() -> Path:
    """Where the built library lives; named by the source's content hash
    so an edited source is rebuilt and never loaded stale."""
    h = hashlib.sha256(SOURCE.read_bytes()
                       + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libgf_matmul-{h}.so"


def build(verbose: bool = False) -> tuple[Path, str]:
    """Compile the kernel unless this source's library already exists.

    Returns (library path, compiler output).  `verbose` adds
    `-Xptxas -v` (registers, shared memory and spills per kernel).
    Raises RuntimeError when nvcc fails or is missing.
    """
    out = library_path()
    if out.exists() and not verbose:
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}")
    cmd = [nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"nvcc not found ({cmd[0]}): cannot build "
                           f"{SOURCE.name}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {SOURCE.name}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr


def _lib():
    global _LIB
    if _LIB is None:
        with _LIB_LOCK:
            if _LIB is None:
                path, _ = build()
                lib = ctypes.CDLL(str(path))
                fn = lib.gf_matmul_launch
                fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                               ctypes.c_int, ctypes.c_longlong,
                               ctypes.c_int, ctypes.c_void_p]
                fn.restype = ctypes.c_int
                _LIB = lib
    return _LIB


def nibble_tables(mat_bits) -> np.ndarray:
    """(8R, 8C) plane-major bit matrix -> (R, C, 32) uint8 tables.

    Entry [r, c, v] (v < 16) is M[r, c] * v and [r, c, 16 + v] is
    M[r, c] * (v << 4), read straight off the bit matrix: column j*C+c
    of output rows i*R+r holds bit i of M[r, c] * 2^j.  Works for any
    GF(2)-linear byte map, so it is exact for every matrix the codec
    builds.
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
    out = np.zeros((rows, cols, 32), dtype=np.uint8)
    for j in range(4):
        out[:, :, :16] ^= np.where(sel[:, j], col[:, :, j, None], 0
                                   ).astype(np.uint8)
        out[:, :, 16:] ^= np.where(sel[:, j], col[:, :, j + 4, None], 0
                                   ).astype(np.uint8)
    return out


def _device_tables(mat_bits, device: torch.device) -> torch.Tensor:
    """Nibble tables on `device`, cached per (matrix, device)."""
    m = np.asarray(mat_bits).astype(np.uint8)
    key = (m.shape, m.tobytes(), str(device))
    t = _TABLES.get(key)
    if t is None:
        t = torch.from_numpy(nibble_tables(m)).to(device)
        if len(_TABLES) >= 4096:
            _TABLES.clear()
        _TABLES[key] = t
    return t


def gf_matmul_blocks(mat_bits, x: torch.Tensor, rows: int,
                     salt: int | None = None) -> torch.Tensor:
    """Batched GF(2^8) matmul: (B, C, S) uint8 -> (B, R, S) uint8.

    mat_bits: (8R, 8C) plane-major bit matrix with R == rows.  A CUDA
    `x` launches the kernel on the current stream (any S, any B up to
    65535); a CPU `x` runs the plain version.  `salt`: the low byte is
    XORed into every input byte inside the kernel.
    """
    global LAUNCHES
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
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.gf_matmul_launch(
            tables.data_ptr(), x.data_ptr(), out.data_ptr(), b, rows, c, s,
            0 if salt is None else int(salt) & 0xFF, stream)
    if err != 0:
        raise RuntimeError(f"gf_matmul kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    return out
