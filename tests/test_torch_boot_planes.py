"""The engine's boot planes in the port (minio_tpu_torch: ops/selftest.py,
storage/recovery.py, LocalDrive.sweep_stale and the standalone boot's
order; device="cpu") held to the JAX package.

- The startup self-tests pass, count one GF and one mxh256 work item per
  device, and raise on a corrupted spec table or a device program that
  computes wrong bytes or fails, naming the device.
- The recovery sweep counts and leaves what the JAX drive's sweep does
  on twin trees, through health wrappers and None gaps.
- `python -m minio_tpu_torch.server` runs self-tests, the sweep, the
  health wrap and MRF in the JAX package's order, refuses to serve on a
  failing self-test, sweeps seeded debris, and stops its MRF queue and
  probers on drain.
"""

import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from minio_tpu.storage import recovery as jax_recovery
from minio_tpu.storage.drive import LocalDrive as JaxLocalDrive
from minio_tpu_torch.background import mrf
from minio_tpu_torch.engine.sets import ErasureSets
from minio_tpu_torch.ops import fused, gf256, highwayhash, mxhash, selftest
from minio_tpu_torch.server import __main__ as boot
from minio_tpu_torch.server import server as server_mod
from minio_tpu_torch.storage import health_wrap as hw
from minio_tpu_torch.storage import recovery
from minio_tpu_torch.storage.drive import MULTIPART_DIR, SYS_VOL, TMP_DIR
from minio_tpu_torch.storage.drive import LocalDrive

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def no_threads_left():
    def live():
        return {t for t in threading.enumerate()
                if t.name.startswith(("ThreadPoolExecutor", "mtpu-mrf",
                                      "mtpu-drive-probe"))}
    before = live()
    yield
    assert not live() - before


# -- self-tests ------------------------------------------------------------------

def test_self_tests_pass_and_count_one_item_each():
    fused.reset_items()
    selftest.run_startup_self_tests("cpu")
    assert fused.ITEMS == {"gf_matmul": 1, "hh256": 0, "mxh256": 1}


def _corrupt_mul_table(monkeypatch):
    bad = gf256.mul_table().copy()
    bad[2:, 7] ^= 0x5A
    monkeypatch.setattr(gf256, "mul_table", lambda: bad)


def _corrupt_mxh_matrix(monkeypatch):
    bad = mxhash.matrix_a().copy()
    bad[17, 3] = -bad[17, 3]
    monkeypatch.setattr(mxhash, "matrix_a", lambda: bad)


def _corrupt_hh_init(monkeypatch):
    monkeypatch.setattr(highwayhash, "INIT0",
                        (highwayhash.INIT0[0] ^ 1,) + highwayhash.INIT0[1:])


@pytest.mark.parametrize("corrupt,check,match", [
    (_corrupt_mul_table, selftest.erasure_self_test, "erasure self-test"),
    (_corrupt_mxh_matrix, selftest.mxhash_self_test, "mxh256"),
    (_corrupt_hh_init, selftest.bitrot_self_test, "HighwayHash256"),
], ids=["gf256", "mxh256", "highwayhash"])
def test_corrupted_spec_table_raises(monkeypatch, corrupt, check, match):
    check()
    corrupt(monkeypatch)
    with pytest.raises(selftest.SelfTestError, match=match):
        check()
    with pytest.raises(selftest.SelfTestError):
        selftest.run_startup_self_tests("cpu")


def test_device_lane_mismatch_and_failure_name_the_device(monkeypatch):
    real = fused.encode_and_hash

    def flipped(*a, **kw):
        parity, digests = real(*a, **kw)
        parity = parity.clone()
        parity[0, 0, 0] ^= 1
        return parity, digests
    monkeypatch.setattr(fused, "encode_and_hash", flipped)
    with pytest.raises(selftest.SelfTestError,
                       match="encode mismatch on cpu"):
        selftest.device_lane_self_test("cpu")

    def broken(*a, **kw):
        raise RuntimeError("no kernel image")
    monkeypatch.setattr(fused, "encode_and_hash", broken)
    with pytest.raises(selftest.SelfTestError,
                       match="launch failed on cpu: no kernel image"):
        selftest.device_lane_self_test("cpu")


def test_device_lane_without_cuda_raises(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        selftest.device_lane_self_test()


def test_misconfigured_write_algo_fails_boot(monkeypatch):
    monkeypatch.setenv("MTPU_BITROT_ALGO", "nope")
    with pytest.raises(ValueError):
        selftest.run_startup_self_tests("cpu")


# -- the recovery sweep ----------------------------------------------------------

def _seed_debris(root, seed):
    """Stale staging, trash and multipart files under one drive root;
    returns (tmp entries, stage files) seeded."""
    rng = np.random.default_rng(seed)
    sys_dir = os.path.join(root, SYS_VOL)
    os.makedirs(os.path.join(sys_dir, TMP_DIR), exist_ok=True)
    n_tmp = int(rng.integers(1, 5))
    for i in range(n_tmp):
        if i % 2:
            p = os.path.join(sys_dir, TMP_DIR, f"put-{i:04x}", "part.1")
            os.makedirs(os.path.dirname(p), exist_ok=True)
        else:
            p = os.path.join(sys_dir, TMP_DIR, f"trash-{i:04x}")
        with open(p, "wb") as f:
            f.write(rng.bytes(100))
    n_stage = int(rng.integers(0, 4))
    up = os.path.join(sys_dir, MULTIPART_DIR, "abc", "upload-1")
    os.makedirs(up, exist_ok=True)
    for i in range(n_stage):
        with open(os.path.join(up, f"stage-{i:04x}.{i + 1}"), "wb") as f:
            f.write(b"x")
    for keep in ("part.1", "part.1.meta", "xl.meta"):
        with open(os.path.join(up, keep), "wb") as f:
            f.write(b"keep")
    return n_tmp, n_stage


def _tree(root):
    out = []
    for dirpath, dirs, files in os.walk(root):
        rel = os.path.relpath(dirpath, root)
        out += [os.path.join(rel, d) + "/" for d in dirs
                if not d.startswith(f"{TMP_DIR}-old-")]
        out += [os.path.join(rel, f) for f in files]
    return sorted(out)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_sweep_stale_equals_jax(tmp_path, seed):
    port = LocalDrive(str(tmp_path / "p"))
    jax = JaxLocalDrive(str(tmp_path / "j"))
    for d in (port, jax):
        _seed_debris(d.root, seed)
    assert _tree(port.root) == _tree(jax.root)
    got, want = port.sweep_stale(), jax.sweep_stale()
    assert got == want
    assert got["tmp_entries"] > 0 and got["meta_journal"] == 0
    assert _tree(port.root) == _tree(jax.root)
    assert os.listdir(os.path.join(port.root, SYS_VOL, TMP_DIR)) == []
    assert port.sweep_stale() == {"tmp_entries": 0, "mp_stage": 0,
                                  "meta_journal": 0}


def test_boot_recovery_sweep_totals_equal_jax(tmp_path):
    ports = [LocalDrive(str(tmp_path / f"p{i}")) for i in range(4)]
    jaxes = [JaxLocalDrive(str(tmp_path / f"j{i}")) for i in range(4)]
    seeded = [_seed_debris(d.root, 10 + i) for i, d in enumerate(ports)]
    for i, d in enumerate(jaxes):
        _seed_debris(d.root, 10 + i)
    before = recovery.stats()
    wrapped = hw.wrap_drives(ports)
    got = recovery.boot_recovery_sweep(wrapped[:2] + [None] + wrapped[2:])
    want = jax_recovery.boot_recovery_sweep(jaxes)
    assert got == want
    assert got == {"drives": 4,
                   "tmp_entries": sum(t for t, _ in seeded),
                   "mp_stage": sum(s for _, s in seeded),
                   "meta_journal": 0}
    after = recovery.stats()
    assert after["sweeps"] == before["sweeps"] + 4
    assert after["tmp_entries"] - before["tmp_entries"] == \
        got["tmp_entries"]


# -- the standalone boot -------------------------------------------------------

def test_boot_runs_planes_in_the_jax_order(tmp_path, monkeypatch):
    order, seen = [], {}

    def spy(mod, name, tag):
        real = getattr(mod, name)

        def wrapper(*a, **kw):
            order.append(tag)
            out = real(*a, **kw)
            seen[tag] = out
            return out
        monkeypatch.setattr(mod, name, wrapper)

    spy(selftest, "run_startup_self_tests", "self-tests")
    spy(recovery, "boot_recovery_sweep", "sweep")
    spy(hw, "wrap_drives", "wrap")
    spy(mrf, "attach_mrf", "mrf")
    spy(server_mod.S3Server, "start", "serve")
    real_sets = ErasureSets.__init__

    def sets_init(self, drives, *a, **kw):
        order.append("sets")
        seen["set drives"] = list(drives)
        real_sets(self, drives, *a, **kw)
    monkeypatch.setattr(ErasureSets, "__init__", sets_init)
    # The drain starts as soon as the server is up.
    monkeypatch.setattr(boot, "install_signal_handlers",
                        lambda stop: stop.set())
    rc = boot.main(["--device", "cpu", "--port", "0", "--drives",
                    str(tmp_path / "d{1...4}")])
    assert rc == 0
    # The JAX package's order (minio_tpu/server/__main__.py:157-160,
    # :250-295): self-tests, then per pool sweep -> wrap -> sets, then
    # MRF, then the front door.
    assert order == ["self-tests", "sweep", "wrap", "sets", "mrf", "serve"]
    assert all(isinstance(d, LocalDrive) and hasattr(d, "health_state")
               for d in seen["set drives"])
    (q,) = seen["mrf"]
    assert q._stop.is_set() and not q._thread.is_alive()
    assert os.path.exists(os.path.join(tmp_path, "d1", SYS_VOL,
                                       "mrf-journal.jsonl"))


def test_boot_refuses_to_serve_on_failing_self_test(tmp_path, monkeypatch):
    started = []
    monkeypatch.setattr(server_mod.S3Server, "start",
                        lambda self: started.append(self))

    def bad():
        raise selftest.SelfTestError("erasure self-test EC:2+2 mismatch")
    monkeypatch.setattr(selftest, "erasure_self_test", bad)
    with pytest.raises(selftest.SelfTestError):
        boot.main(["--device", "cpu", "--port", "0", "--drives",
                   str(tmp_path / "d{1...4}")])
    assert not started
    assert not os.path.exists(tmp_path / "d1")   # nothing built either


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_boot_sweeps_seeded_debris_and_drains(tmp_path):
    seeded = [_seed_debris(str(tmp_path / f"d{i}"), 20 + i)
              for i in range(1, 5)]
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    proc = subprocess.Popen(
        [sys.executable, "-m", "minio_tpu_torch.server", "--device", "cpu",
         "--drives", str(tmp_path / "d{1...4}"), "--port", str(port)],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 60
        while True:
            assert proc.poll() is None, proc.stderr.read()
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/minio/health/ready",
                        timeout=2) as r:
                    if r.status == 200:
                        break
            except OSError:
                pass
            assert time.monotonic() < deadline, "never ready"
            time.sleep(0.1)
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=20)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err
    lines = out.splitlines()
    assert lines[0].startswith("minio_tpu_torch: self-tests passed in ")
    assert "items gf_matmul=1 mxh256=1" in lines[0]
    assert lines[1] == (
        f"minio_tpu_torch: recovery sweep: {sum(t for t, _ in seeded)} "
        f"stale tmp entries, {sum(s for _, s in seeded)} orphaned "
        "multipart staging files across 4 drives")
    for i in range(1, 5):
        tmp = tmp_path / f"d{i}" / SYS_VOL / TMP_DIR
        assert not [p for p in tmp.iterdir()
                    if p.name[-4:].isdigit()]      # the seeded names
        up = tmp_path / f"d{i}" / SYS_VOL / MULTIPART_DIR / "abc" / "upload-1"
        assert sorted(p.name for p in up.iterdir()) == [
            "part.1", "part.1.meta", "xl.meta"]
