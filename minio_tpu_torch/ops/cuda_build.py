"""Build and load the port's hand-written CUDA kernels (csrc/*.cu).

Each source is compiled with nvcc into a shared library with a plain C
interface, named by the hash of its content and flags, under
`minio_tpu_torch/build/` (listed in .gitignore), and loaded with ctypes
at first use.  An edited source is therefore rebuilt and never loaded
stale.  `build` starts one nvcc per missing library, all at once, so
building every kernel costs about as long as the slowest one.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]


def nvcc() -> str:
    """The nvcc executable: $NVCC, then PATH, then $CUDA_HOME/bin."""
    found = os.environ.get("NVCC") or shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(home) / "bin" / "nvcc")


def library_path(source: Path) -> Path:
    """Where `source`'s library lives: named by its content hash."""
    h = hashlib.sha256(source.read_bytes()
                       + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{source.stem}-{h}.so"


def build(sources: list[Path], verbose: bool = False
          ) -> dict[Path, tuple[Path, str]]:
    """Compile every source whose library does not exist yet, one nvcc
    process per source, all started together.

    Returns {source: (library path, compiler output)}.  `verbose` adds
    `-Xptxas -v` (registers, shared memory and spills per kernel) and
    rebuilds even a library that exists.  Raises RuntimeError when nvcc
    is missing or fails on any source.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    result = {}
    try:
        for src in sources:
            out = library_path(src)
            if out.exists() and not verbose:
                result[src] = (out, "")
                continue
            tmp = out.with_suffix(f".tmp{os.getpid()}")
            cmd = [nvcc(), *NVCC_FLAGS,
                   *(["-Xptxas", "-v"] if verbose else []),
                   "-o", str(tmp), str(src)]
            try:
                proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True)
            except FileNotFoundError as e:
                raise RuntimeError(f"nvcc not found ({cmd[0]}): cannot "
                                   f"build {src.name}") from e
            running[src] = (out, tmp, proc)
        failed = []
        for src, (out, tmp, proc) in running.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed on {src.name}:\n{log}")
                continue
            os.replace(tmp, out)
            result[src] = (out, log)
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for _, _, proc in running.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return result


class Library:
    """One source's launch function, built and loaded at first use.

    `symbol` is the extern "C" launch function; `argtypes` its ctypes
    argument types (c_void_p for every pointer and the stream).  It
    returns the launch's cudaError_t.
    """

    def __init__(self, source_name: str, symbol: str, argtypes: list):
        self.source = CSRC / source_name
        self.symbol = symbol
        self.argtypes = argtypes
        self._fn = None
        self._lock = threading.Lock()

    def fn(self):
        if self._fn is None:
            with self._lock:
                if self._fn is None:
                    path, _ = build([self.source])[self.source]
                    fn = getattr(ctypes.CDLL(str(path)), self.symbol)
                    fn.argtypes = self.argtypes
                    fn.restype = ctypes.c_int
                    self._fn = fn
        return self._fn
