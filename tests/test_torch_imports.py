"""Guards of the PyTorch/CUDA port: no module of minio_tpu_torch and not
chip_smoke.py imports JAX, the JAX package or the host codecs in
native/; entry points run on the CUDA card unless the caller asks for the
CPU, and without CUDA they raise instead of falling back."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from minio_tpu_torch.engine.erasure_set import ErasureSet
from minio_tpu_torch.ops import devices, fused
from minio_tpu_torch.ops.erasure_torch import ReedSolomon
from minio_tpu_torch.storage.drive import LocalDrive

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "minio_tpu", "native")
PKG = ROOT / "minio_tpu_torch"
SOURCES = sorted(p for p in PKG.rglob("*.py")
                 if (PKG / "build") not in p.parents) + [
    ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    """True for a module named exactly like a forbidden package or
    inside one (minio_tpu_torch is not inside minio_tpu)."""
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _imports(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "id", getattr(node.func, "attr", ""))
              in ("__import__", "import_module")):
            names.append(node.args[0].value)
    return names


def test_guard_matches_exact_package_names():
    assert _forbidden("minio_tpu") and _forbidden("minio_tpu.ops.gf256")
    assert _forbidden("jax.numpy") and _forbidden("native.ecio_native")
    assert not _forbidden("minio_tpu_torch.ops.fused")
    assert not _forbidden("nativelike")


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_forbidden_imports(path):
    bad = [n for n in _imports(path) if _forbidden(n)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_covers_every_subpackage():
    """Every subpackage of the port, cluster/, parallel/, background/
    and the S3 server's server/, bucket/, config/, topology/ and iam/
    among them, has its modules in the scan."""
    subpackages = {p.parent.relative_to(PKG) for p in PKG.rglob("__init__.py")
                   if (PKG / "build") not in p.parents}
    scanned = {p.parent.relative_to(PKG) for p in SOURCES
               if PKG in p.parents}
    assert {Path("cluster"), Path("parallel"), Path("background"),
            Path("server"), Path("bucket"), Path("config"),
            Path("topology"), Path("iam")} <= subpackages <= scanned
    for mod in ("cluster/nslock.py", "cluster/dynamic_timeout.py",
                "parallel/pipeline.py", "storage/format.py",
                "utils/siphash.py", "engine/metacache.py", "engine/sets.py",
                "engine/pools.py", "background/heal_ops.py",
                "server/server.py", "server/handlers.py",
                "server/sigv4.py", "server/api_errors.py",
                "server/client.py", "server/__main__.py",
                "bucket/metadata.py", "config/config.py",
                "topology/endpoints.py", "iam/iam.py", "iam/policy.py",
                "iam/oidc.py", "iam/ldap.py", "server/sigv2.py",
                "server/postpolicy.py", "server/extract.py",
                "utils/streams.py", "ops/shm_arena.py", "ops/bpool.py",
                "ops/zerocopy.py", "ops/selftest.py",
                "storage/diskio.py", "storage/health_wrap.py",
                "storage/recovery.py", "background/mrf.py",
                "ops/ipc_ring.py", "ops/ipc_knobs.py", "ops/ipc_dispatch.py",
                "server/workers.py", "server/boot.py",
                "ops/metalanes.py", "storage/naughty.py",
                "storage/chaos.py"):
        assert PKG / mod in SOURCES, mod


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_raises_without_cuda(tmp_path, monkeypatch):
    _no_cuda(monkeypatch)
    drives = [LocalDrive(str(tmp_path / f"d{i}")) for i in range(4)]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ErasureSet(drives)
    with pytest.raises(RuntimeError):
        ErasureSet(drives, device="cuda")
    with pytest.raises(RuntimeError):
        ReedSolomon(2, 2)
    with pytest.raises(RuntimeError):
        fused.encode_and_hash(b"\0" * 8, 2, 2)
    with pytest.raises(RuntimeError):
        fused.hash_rows(b"\0" * 8, "highwayhash256S")
    with pytest.raises(RuntimeError):
        devices.resolve()


def test_explicit_cpu_works(tmp_path, monkeypatch):
    _no_cuda(monkeypatch)
    drives = [LocalDrive(str(tmp_path / f"d{i}")) for i in range(4)]
    with ErasureSet(drives, device="cpu") as es:
        assert es.device == torch.device("cpu")
        es.make_bucket("bkt")
        es.put_object("bkt", "o", b"hello port")
        assert bytes(es.get_object("bkt", "o")[1]) == b"hello port"


def test_device_for_set_wraps(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert [devices.device_for_set(i) for i in range(6)] == [0, 1, 2, 3, 0, 1]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert devices.device_for_set(5) == 0


def test_chip_smoke_fails_without_cuda(tmp_path):
    """On a host without CUDA the smoke script exits non-zero and prints
    no result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          capture_output=True, text=True, env=env,
                          cwd=tmp_path, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
