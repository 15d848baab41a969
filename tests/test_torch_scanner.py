"""The port's data scanner and usage (minio_tpu_torch/background/
scanner.py, background/usage.py; device="cpu") held to the JAX package
and to tests/test_background.py's cases.  Tolerance: byte-exact.

- The same objects give the same usage tree in both packages; each
  package reads the other's persisted usage and dirty set.
- A drive's removed xl.meta is healed by a normal cycle, a corrupted
  shard frame by a deep cycle (verified on the device), each back to its
  bytes, with the JAX package's counts.
- The repaired fault: every set of every pool marks the dirty tracker,
  so a PUT into a bucket already scanned is counted by the next cycle
  (the JAX package carries the old numbers forward for up to 16 cycles).
  Marks made in another process reach the scanner through the shared
  table (SharedMarks), across a real fork.
- The perpetual loop runs deep cycles on schedule and stops; MTPU_SCANNER
  =0 starts none; a process without the scanner reads its usage.
"""

import functools
import glob
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest

import minio_tpu_torch.engine.erasure_set as port_es_mod
from minio_tpu.background.scanner import DataScanner as JaxDataScanner
from minio_tpu.background.usage import DataUsage as JaxDataUsage
from minio_tpu.background.usage import DirtyTracker as JaxDirtyTracker
from minio_tpu.engine.pools import ServerPools as JaxServerPools
from minio_tpu.engine.sets import ErasureSets as JaxErasureSets
from minio_tpu.storage.drive import LocalDrive as JaxLocalDrive
from minio_tpu_torch.background import scanner as scanner_mod
from minio_tpu_torch.background.scanner import (DataScanner,
                                                PersistedUsage, load_usage)
from minio_tpu_torch.background.usage import (DataUsage, DirtyTracker,
                                              SharedMarks)
from minio_tpu_torch.engine.pools import ServerPools
from minio_tpu_torch.engine.sets import ErasureSets
from minio_tpu_torch.storage.drive import LocalDrive

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

JAX = SimpleNamespace(
    name="jax", LocalDrive=JaxLocalDrive, ErasureSets=JaxErasureSets,
    ServerPools=JaxServerPools, DataScanner=JaxDataScanner,
    DataUsage=JaxDataUsage, DirtyTracker=JaxDirtyTracker)
PORT = SimpleNamespace(
    name="port", LocalDrive=LocalDrive,
    ErasureSets=functools.partial(ErasureSets, device="cpu"),
    ServerPools=ServerPools, DataScanner=DataScanner, DataUsage=DataUsage,
    DirtyTracker=DirtyTracker)
IMPLS = [JAX, PORT]


def payload(size, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, size, dtype=np.uint8).tobytes()


def close(obj):
    for p in getattr(obj, "pools", [obj]):
        for es in p.sets:
            if isinstance(es, port_es_mod.ErasureSet):
                es.close()
            else:
                es.pool.shutdown(wait=True)
                es._iter_pool.shutdown(wait=True)


@pytest.fixture
def made():
    """Pools of either package over 4 drives under a root; scanners
    made through it are stopped."""
    objs, scanners = [], []

    def build(impl, root):
        drives = [impl.LocalDrive(str(root / f"d{i}")) for i in range(4)]
        pools = impl.ServerPools([impl.ErasureSets(drives,
                                                   set_drive_count=4)])
        objs.append(pools)
        return pools
    build.scanners = scanners
    yield build
    for sc in scanners:
        sc.stop()
    for obj in objs:
        close(obj)
    # The process-wide tracker must not keep saving to closed sets.
    DirtyTracker.shared().bind(None)


def scanner(made, impl, pools, **kw):
    sc = impl.DataScanner(pools, **kw)
    made.scanners.append(sc)
    return sc


def _usage(u):
    return {b: x.to_obj() for b, x in u.buckets.items()}


def test_usage_tree_equals_the_jax_packages(tmp_path, made):
    got = {}
    for impl in IMPLS:
        pools = made(impl, tmp_path / impl.name)
        pools.make_bucket("ua")
        pools.make_bucket("ub")
        pools.put_object("ua", "x/a", payload(1000))
        pools.put_object("ua", "x/b", payload(2000, 1))
        pools.put_object("ua", "top", payload(500, 2))
        pools.put_object("ub", "big", payload(300_000, 3))
        u = scanner(made, impl, pools).scan_cycle()
        got[impl.name] = _usage(u)
    assert got["port"] == got["jax"]
    ua = got["port"]["ua"]
    assert (ua["o"], ua["b"], ua["p"]) == (3, 3500,
                                            {"x/": 3000, "top": 500})


@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax_to_port", "port_to_jax"])
def test_each_package_reads_the_others_usage_and_dirty_set(
        tmp_path, made, writer, reader):
    pools = made(writer, tmp_path)
    pools.make_bucket("up")
    pools.put_object("up", "k", payload(123))
    written = writer.DataScanner(pools).scan_cycle()
    tracker = writer.DirtyTracker()
    tracker.mark("up")
    tracker.mark("other")
    tracker.save(pools.pools[0].sets[0])
    other = made(reader, tmp_path)
    es = other.pools[0].sets[0]
    loaded = reader.DataUsage.load(es)
    assert _usage(loaded) == _usage(written)
    assert loaded.scanned_at == written.scanned_at
    assert loaded.cycle == written.cycle
    back = reader.DirtyTracker()
    back.load(es)
    assert back.snapshot_and_clear() == {"up", "other"}


@pytest.mark.parametrize("impl", IMPLS, ids=lambda i: i.name)
def test_normal_cycle_heals_a_removed_xlmeta(tmp_path, made, impl):
    pools = made(impl, tmp_path)
    pools.make_bucket("hb")
    pools.put_object("hb", "obj", payload(200_000, seed=2))
    meta = tmp_path / "d2" / "hb" / "obj" / "xl.meta"
    want = meta.read_bytes()
    meta.unlink()
    sc = scanner(made, impl, pools)
    sc.scan_cycle()
    assert sc.stats.heals_triggered == 1
    assert meta.read_bytes() == want
    sc.scan_cycle()
    assert sc.stats.heals_triggered == 1          # nothing left


@pytest.mark.parametrize("impl", IMPLS, ids=lambda i: i.name)
def test_deep_cycle_heals_a_corrupted_frame(tmp_path, made, impl):
    pools = made(impl, tmp_path)
    pools.make_bucket("idle")
    data = payload(400_000, seed=4)
    pools.put_object("idle", "quiet/obj", data)
    files = sorted(p for p in glob.glob(
        str(tmp_path / "d1" / "idle" / "quiet" / "obj" / "**"),
        recursive=True) if os.path.isfile(p) and "xl.meta" not in p)
    assert files
    before = open(files[0], "rb").read()
    with open(files[0], "r+b") as f:
        f.seek(100)
        f.write(b"\xff\x00\xff\x00\xff")
    sc = scanner(made, impl, pools, deep_every=1)
    sc.scan_cycle()                     # a normal cycle reads no frame
    assert open(files[0], "rb").read() != before
    sc.scan_cycle(deep=True)
    assert (sc.stats.corruption_found, sc.stats.objects_verified) == (1, 1)
    assert open(files[0], "rb").read() == before
    sc.scan_cycle(deep=True)
    assert sc.stats.corruption_found == 1
    assert bytes(pools.get_object("idle", "quiet/obj")[1]) == data


def test_a_put_after_a_scan_is_counted_by_the_next_cycle(tmp_path, made):
    """The repaired fault.  The JAX boot wires no tracker into its sets:
    a bucket scanned once is carried forward (1 object) until the 16th
    cycle.  Every set of the port's pools marks the shared tracker."""
    got = {}
    for impl in IMPLS:
        pools = made(impl, tmp_path / impl.name)
        pools.make_bucket("sk")
        pools.put_object("sk", "a", payload(100))
        sc = scanner(made, impl, pools)
        assert sc.scan_cycle().buckets["sk"].objects == 1
        pools.put_object("sk", "b", payload(100, 1))
        got[impl.name] = sc.scan_cycle().buckets["sk"].objects
    assert got == {"jax": 1, "port": 2}


def test_clean_buckets_are_carried_forward(tmp_path, made):
    pools = made(PORT, tmp_path)
    pools.make_bucket("sk")
    pools.make_bucket("quiet")
    pools.put_object("sk", "a", payload(100))
    pools.put_object("quiet", "q", payload(100, 2))
    sc = scanner(made, PORT, pools, full_scan_every=1000)
    sc.scan_cycle()
    n = sc.stats.objects_scanned
    sc.scan_cycle()
    assert sc.stats.objects_scanned == n           # nothing rescanned
    pools.put_object("sk", "b", payload(100, 1))
    u = sc.scan_cycle()
    assert sc.stats.objects_scanned == n + 2       # "sk" alone
    assert (u.buckets["sk"].objects, u.buckets["quiet"].objects) == (2, 1)


def test_shared_marks_carry_another_trackers_marks():
    marks = SharedMarks(slots=64)
    scanning, writer = DirtyTracker(), DirtyTracker()
    scanning.attach_shared(marks)
    writer.attach_shared(marks)
    assert scanning.snapshot_and_clear(["a", "b"]) == set()
    writer.mark("a")
    assert scanning.snapshot_and_clear(["a", "b"]) == {"a"}
    assert scanning.snapshot_and_clear(["a", "b"]) == set()
    # A bucket seen for the first time is clean (the first cycle scans
    # everything); from then on its marks count.
    writer.mark("new")
    assert scanning.snapshot_and_clear(["new"]) == set()
    writer.mark("new")
    assert scanning.snapshot_and_clear(["new"]) == {"new"}


def test_shared_marks_cross_a_fork(tmp_path):
    """Never a fork of pytest: a script forks a child that marks."""
    script = (
        "import os, sys\n"
        "from minio_tpu_torch.background.usage import DirtyTracker, "
        "SharedMarks\n"
        "marks = SharedMarks()\n"
        "t = DirtyTracker()\n"
        "t.attach_shared(marks)\n"
        "t.snapshot_and_clear(['b1', 'b2'])\n"
        "pid = os.fork()\n"
        "if pid == 0:\n"
        "    c = DirtyTracker()\n"
        "    c.attach_shared(marks)\n"
        "    c.mark('b2')\n"
        "    os._exit(0)\n"
        "os.waitpid(pid, 0)\n"
        "print(sorted(t.snapshot_and_clear(['b1', 'b2'])))\n")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=60,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "['b2']"


def test_perpetual_loop_runs_deep_on_schedule_and_stops(tmp_path, made):
    pools = made(PORT, tmp_path)
    pools.make_bucket("loopb")
    pools.put_object("loopb", "o", payload(10_000, seed=1))
    sc = scanner(made, PORT, pools, deep_every=2)
    sc.start(interval=0.05)
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline and sc.stats.cycles < 4:
        time.sleep(0.05)
    sc.stop()
    assert not sc._thread.is_alive()
    assert sc.stats.cycles >= 4
    assert 1 <= sc.stats.deep_cycles < sc.stats.cycles
    assert DirtyTracker.shared()._es is None       # unbound at stop


def test_env_switch_and_the_persisted_view(tmp_path, made, monkeypatch):
    pools = made(PORT, tmp_path)
    monkeypatch.setenv("MTPU_SCANNER", "0")
    assert scanner_mod.scanner_from_env(pools) is None
    view = PersistedUsage(pools)
    assert view.latest_usage() is None and load_usage(pools) is None
    pools.make_bucket("pv")
    pools.put_object("pv", "k", payload(77))
    scanner(made, PORT, pools).scan_cycle()
    assert view.latest_usage() is None            # read within the TTL
    view._at = 0.0
    assert view.latest_usage().buckets["pv"].bytes == 77
    monkeypatch.setenv("MTPU_SCANNER", "1")
    monkeypatch.setenv("MTPU_SCANNER_INTERVAL", "3600")
    sc = scanner_mod.scanner_from_env(pools)
    made.scanners.append(sc)
    assert sc._thread.is_alive() and sc.deep_every == 16


def test_dirty_set_file_is_the_jax_packages(tmp_path, made):
    pools = made(PORT, tmp_path)
    t = DirtyTracker()
    t.mark("zz")
    t.mark("aa")
    t.save(pools.pools[0].sets[0])
    doc = json.loads((tmp_path / "d0" / ".mtpu.sys" /
                      "dirty-buckets.json").read_text())
    assert doc["dirty"] == ["aa", "zz"] and set(doc["stamp"]) == {"aa",
                                                                  "zz"}
