"""The port's pre-fork worker pool (minio_tpu_torch/server/workers.py,
ops/ipc_dispatch.py, ops/ipc_ring.py) on the CPU.

Layers, cheapest first:

- the shared-memory ring and the control block, in process;
- the remote dispatch protocol in threads (no fork): a RemoteCoalescer
  talking to serve_owner() over a real plane.  Seeded enc, vt and digest
  items under mxh256 and highwayhash256S go through the owner, through
  the port's in-process coalescer and through the JAX package's fused
  programs, and all three are byte-equal; the protocol's limits (arena
  space returned, an unknown kind, mode 0, a dead owner, a respawned
  worker adopting its predecessor's slots, an answer too large);
- one real pool, `python -m minio_tpu_torch.server --device cpu` with
  MTPU_WORKERS=2 and MTPU_IPC_DISPATCH=all, booted with subprocess.Popen
  (no test forks the pytest process): S3 through the owner, both
  workers serving, the owner's items in the metrics, part files and
  xl.meta equal to the JAX package's ErasureSet, an owner SIGKILL with a
  PUT in the gap, a SIGTERM drain;
- the supervisor stays light (no torch), and a failing self-test in the
  owner ends the boot, or the pool after a respawn.

Every subprocess has its own timeout and is killed in `finally`.
"""

import hashlib
import json
import os
import re
import signal
import socket
import struct
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from minio_tpu.ops import fused as jax_fused
from minio_tpu_torch.engine import erasure_set as es_mod
from minio_tpu_torch.ops import coalesce
from minio_tpu_torch.ops import ipc_dispatch as ipc
from minio_tpu_torch.ops.ipc_ring import REC, ShmRing
from minio_tpu_torch.server.client import S3Client
from minio_tpu_torch.server.workers import (SharedState, WorkerPlane,
                                            nworkers_env)

ROOT = Path(__file__).resolve().parent.parent
MIB = 1 << 20
HH = "highwayhash256S"


# -- descriptor ring ----------------------------------------------------------

def _ring_fifo():
    r = ShmRing(capacity=4)
    assert r.put(b"a") and r.put(b"bb")
    assert r.depth() == 2
    assert r.get() == b"a".ljust(REC, b"\x00")
    assert r.get() == b"bb".ljust(REC, b"\x00")
    assert r.depth() == 0


def _ring_oversize():
    r = ShmRing(capacity=2)
    with pytest.raises(ValueError):
        r.put(b"x" * (REC + 1))


def _ring_timeouts():
    r = ShmRing(capacity=2)
    assert r.put(b"1") and r.put(b"2")
    assert r.put(b"3", timeout=0.1) is False
    assert len(r.drain()) == 2
    assert r.get(timeout=0.1) is None


def _ring_mpmc():
    r = ShmRing(capacity=16)
    nprod, per = 3, 80
    seen, mu = [], threading.Lock()

    def consumer():
        while True:
            rec = r.get(timeout=2.0)
            if rec is None:
                return
            with mu:
                seen.append(struct.unpack_from("<I", rec)[0])

    def producer(base):
        for i in range(per):
            assert r.put(struct.pack("<I", base + i), timeout=10.0)

    ts = ([threading.Thread(target=consumer) for _ in range(2)]
          + [threading.Thread(target=producer, args=(k * 1000,))
             for k in range(nprod)])
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert sorted(seen) == sorted(k * 1000 + i for k in range(nprod)
                                  for i in range(per))


@pytest.mark.parametrize("case", [_ring_fifo, _ring_oversize,
                                  _ring_timeouts, _ring_mpmc],
                         ids=["fifo_padding", "oversize_refused",
                              "full_and_empty_time_out", "threaded_mpmc"])
def test_shm_ring(case):
    case()


# -- control block ------------------------------------------------------------

def test_worker_slab_roundtrip():
    st = SharedState(3)
    st.worker_register(1, 4242)
    st.worker_beat(1, inflight=5, counters={"ipc_fallbacks": 2,
                                            "launches_hh256": 7})
    st.note_request(1)
    st.note_request(1)
    st.set_ready(1)
    st.set_draining(1)
    assert st.bump_respawn(1) == 1
    rows = st.worker_rows()
    assert len(rows) == 3
    r = rows[1]
    assert r["pid"] == 4242 and r["up"] and r["ready"] and r["draining"]
    assert r["respawns"] == 1 and r["requests"] == 2 and r["inflight"] == 5
    assert r["ipc_fallbacks"] == 2 and r["launches_hh256"] == 7
    assert rows[0]["up"] is False              # never registered


def test_owner_generation_staleness_and_down():
    st = SharedState(1)
    assert st.owner_ok(5.0) is False           # never registered
    gen = st.bump_owner_gen()
    st.owner_register(123)
    assert st.owner_ok(5.0) is True
    st._a[2] = 0                               # rewind the heartbeat
    assert st.owner_ok(5.0) is False
    st.owner_beat({"dispatches": 4, "items": 8, "pending_items": 1,
                   "pack_s": 0.5, "h2d_bytes": 3 * MIB},
                  {"launches_gf_matmul": 3, "items_gf_matmul": 8})
    info = st.owner_info()
    assert info["pid"] == 123 and info["generation"] == gen
    assert info["co_occupancy"] == 2.0         # 8 items / 4 dispatches
    assert info["co_pack_s"] == 0.5 and info["co_staged_bytes"] == 3 * MIB
    assert info["launches_gf_matmul"] == 3 and info["items_gf_matmul"] == 8
    assert st.owner_ok(5.0) is True
    st.owner_down()                            # the supervisor reaped it
    assert st.owner_ok(5.0) is False
    info = st.owner_info()
    assert info["generation"] == gen and info["co_items"] == 0
    assert info["launches_gf_matmul"] == 0


def test_plane_renders_the_pool_families():
    from minio_tpu_torch.server import qos
    qos.reset_for_tests()
    plane = WorkerPlane(2, arena_bytes=8 * MIB, ring_capacity=32)
    # The pool-shared hot tier and the admission slab (one row per
    # worker) are built before any fork.
    assert plane.hotcache is not None and plane.qos is qos.get_plane()
    assert plane.qos.nrows == 2
    plane.qos.bind_row(1)
    assert plane.qos.acquire()[0] == "ok"
    plane.state.worker_register(0, os.getpid())
    plane.state.set_ready(0)
    plane.state.note_request(0)
    plane.state.note_hotcache(0, True)
    plane.state.note_hotcache(1, False)
    assert plane.state.worker_rows()[0]["up"] is True
    prom = plane.render_prom()
    for name in ("mtpu_worker_up", "mtpu_worker_respawns_total",
                 "mtpu_worker_requests_total", "mtpu_worker_ready",
                 "mtpu_worker_ipc_fallbacks_total",
                 "mtpu_worker_cuda_context", "mtpu_shm_arena_bytes",
                 "mtpu_shm_arena_in_use", "mtpu_shm_arena_alloc_timeouts",
                 "mtpu_ipc_ring_depth", "mtpu_owner_up",
                 "mtpu_owner_generation", "mtpu_owner_coalesce_items_total",
                 "mtpu_owner_lane_pack_seconds_total"):
        assert name in prom
    assert 'mtpu_worker_up{worker="0"} 1' in prom
    assert 'mtpu_worker_up{worker="1"} 0' in prom
    assert 'mtpu_worker_hotcache_hits_total{worker="0"} 1' in prom
    assert 'mtpu_worker_hotcache_misses_total{worker="1"} 1' in prom
    assert 'mtpu_worker_requests_total{worker="0"} 1' in prom
    assert 'mtpu_owner_kernel_items_total{kernel="hh256"} 0' in prom
    assert 'mtpu_qos_worker_inflight{worker="1"} 1' in prom
    assert 'mtpu_qos_worker_inflight{worker="0"} 0' in prom
    plane.qos.release()
    qos.reset_for_tests()


@pytest.mark.parametrize("value,want", [(None, 0), ("3", 3), ("junk", 0),
                                        ("-2", 0)])
def test_nworkers_env(monkeypatch, value, want):
    if value is None:
        monkeypatch.delenv("MTPU_WORKERS", raising=False)
    else:
        monkeypatch.setenv("MTPU_WORKERS", value)
    assert nworkers_env() == want


# -- remote dispatch protocol (in threads, no fork) ---------------------------

def _serve(plane):
    """serve_owner() and a heartbeat in threads on `plane`'s current
    generation: (the owner's coalescer, a function that stops both)."""
    stop = threading.Event()
    co = coalesce.DispatchCoalescer()
    threads = ipc.serve_owner(plane, stop, co, nthreads=2)
    beat = threading.Thread(target=lambda: [
        plane.state.owner_beat() for _ in iter(lambda: stop.wait(0.1), True)])
    beat.start()

    def close():
        stop.set()
        for t in threads + [beat]:
            t.join(timeout=10)
        co.close()
    return co, close


@pytest.fixture()
def owner_plane(monkeypatch):
    """A WorkerPlane with serve_owner() running in threads: the arena and
    ring protocol of the forked pool, without the processes."""
    monkeypatch.setenv("MTPU_IPC_DISPATCH", "all")
    plane = WorkerPlane(1, arena_bytes=16 * MIB, ring_capacity=64)
    plane.state.bump_owner_gen()
    plane.state.owner_register(os.getpid())
    co, close = _serve(plane)
    yield plane, co
    close()


def _shards(b, k, m, s, seed):
    """(b, k + m, s) real shards: random data and its parity."""
    x = np.random.default_rng(seed).integers(0, 256, (b, k, s),
                                             dtype=np.uint8)
    parity, _ = jax_fused.encode_and_hash(x, k, m, algo="mxh256")
    return np.concatenate([x, np.asarray(parity)], axis=1)


def _items(algo):
    """(name, key, payload, port kernel, JAX result) of each kind."""
    k, m, b = 4, 2, 3
    s = 1024 if algo == "mxh256" else 160     # HighwayHash's plain version
    full = _shards(b, k, m, s, seed=len(algo))
    data = np.ascontiguousarray(full[:, :k])
    out = [("enc", ("enc", k, m, algo, s), data,
            es_mod.enc_kernel(k, m, algo, "cpu"),
            jax_fused.encode_and_hash(data, k, m, algo=algo))]
    for name, sel, targets in (("vt_data", (0, 1, 3, 4), (2,)),
                               ("vt_parity", (0, 1, 2, 3), (5,))):
        x = np.ascontiguousarray(full[:, list(sel)])
        out.append((name, ("vt", k, m, sel, targets, algo, s), x,
                    es_mod.vt_kernel(k, m, sel, targets, algo, "cpu"),
                    jax_fused.verify_and_transform(x, k, m, sel, targets,
                                                   algo=algo)))
    rows = np.ascontiguousarray(full.reshape(b * (k + m), s))
    out.append(("digest", ("digest", algo, s), rows,
                coalesce.make_digest_kernel(algo, "cpu"),
                jax_fused.hash_rows_async(rows, algo)))
    return out


def _arrays(res):
    if isinstance(res, tuple):
        return [None if a is None else np.asarray(a) for a in res]
    return [np.asarray(res)]


@pytest.mark.parametrize("algo", ["mxh256", HH])
def test_remote_equals_local_and_jax(owner_plane, algo):
    plane, owner_co = owner_plane
    local = coalesce.DispatchCoalescer()
    rc = ipc.RemoteCoalescer(plane, 0)
    try:
        for name, key, payload, fn, want in _items(algo):
            h = local.submit(key, payload, fn, device="cpu")
            got_local = _arrays(h.result(timeout=60))
            h.release()
            h = rc.submit(key, payload, fn, device="cpu")
            assert isinstance(h, ipc.RemoteHandle)
            got_remote = _arrays(h.result(timeout=60))
            want = _arrays(want)
            assert len(got_remote) == len(got_local) == len(want), name
            for r, lo, j in zip(got_remote, got_local, want):
                assert (r is None) == (lo is None) == (j is None), name
                if r is not None:
                    assert r.dtype == lo.dtype == j.dtype == np.uint8, name
                    assert np.array_equal(r, lo) and np.array_equal(r, j), name
        st = rc.stats()
        assert st["remote_submits"] == st["remote_results"] == 4
        assert st["remote_fallbacks"] == 0 and st["items"] == 0
        assert owner_co.stats()["items"] == 4
    finally:
        rc.close()
        local.close()


def test_arena_space_returned_after_roundtrips(owner_plane):
    plane, _ = owner_plane
    payload = np.zeros((4, 1024), dtype=np.uint8)
    fn = coalesce.make_digest_kernel("mxh256", "cpu")
    rc = ipc.RemoteCoalescer(plane, 0)
    try:
        for _ in range(5):
            h = rc.submit(("digest", "mxh256", 1024), payload, fn,
                          device="cpu")
            h.result(timeout=60)
        deadline = time.monotonic() + 10
        while (plane.arena.stats()["in_use_bytes"]
               and time.monotonic() < deadline):
            time.sleep(0.05)              # the listener frees after decode
        st = plane.arena.stats()
        assert st["in_use_bytes"] == 0 and st["allocs"] == st["frees"] == 5
    finally:
        rc.close()


def test_unknown_kind_surfaces_as_error(owner_plane, monkeypatch):
    plane, _ = owner_plane
    rc = ipc.RemoteCoalescer(plane, 0)
    # A kind the worker would keep local: force it onto the wire.
    monkeypatch.setattr(ipc, "KINDS", ipc.KINDS + ("bogus",))
    try:
        h = rc.submit(("bogus", 1), np.zeros((2, 8), np.uint8),
                      coalesce.make_digest_kernel("mxh256", "cpu"),
                      device="cpu")
        with pytest.raises(RuntimeError, match="no remote kernel"):
            h.result(timeout=60)
        assert rc.stats()["remote_errors"] == 1
    finally:
        rc.close()


@pytest.mark.parametrize("mode,device,remote", [
    ("0", "cpu", False), ("auto", "cpu", False), ("all", "cpu", True)])
def test_routing_modes(owner_plane, monkeypatch, mode, device, remote):
    plane, _ = owner_plane
    monkeypatch.setenv("MTPU_IPC_DISPATCH", mode)
    rc = ipc.RemoteCoalescer(plane, 0)
    try:
        h = rc.submit(("digest", "mxh256", 64), np.zeros((1, 64), np.uint8),
                      coalesce.make_digest_kernel("mxh256", device),
                      device=device)
        np.asarray(h.result(timeout=60))
        st = rc.stats()
        assert st["remote_submits"] == int(remote)
        assert st["items"] == int(not remote)
        assert st["remote_active"] is (mode != "0")
        # Staying local by mode is routing, not a fallback.
        assert st["remote_fallbacks"] == 0
    finally:
        rc.close()


def test_dead_owner_fails_pending_and_pins_local(monkeypatch):
    monkeypatch.setenv("MTPU_IPC_DISPATCH", "all")
    # No serve_owner: the submit waits until the watchdog declares the
    # silent owner dead.
    plane = WorkerPlane(1, arena_bytes=8 * MIB, ring_capacity=16)
    plane.state.bump_owner_gen()
    plane.state.owner_register(os.getpid())
    rc = ipc.RemoteCoalescer(plane, 0)
    key = ("digest", "mxh256", 64)
    x = np.arange(64, dtype=np.uint8)[None]
    fn = coalesce.make_digest_kernel("mxh256", "cpu")
    try:
        h = rc.submit(key, x, fn, device="cpu")
        assert rc.stats()["remote_submits"] == 1
        plane.state.owner_down()
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="device owner died"):
            h.result(timeout=30.0)
        assert time.monotonic() - t0 < 2.0
        assert rc._remote_active() is False           # pinned local
        # The slot the dead owner may still write is held back.
        assert plane.arena.stats()["in_use_bytes"] > 0
        # Local recompute, on the set's device, counted.
        h = rc.submit(key, x, fn, device="cpu")
        assert not isinstance(h, ipc.RemoteHandle)
        want = jax_fused.hash_rows_async(x, "mxh256")
        assert np.array_equal(np.asarray(h.result(timeout=30)),
                              np.asarray(want))
        st = rc.stats()
        assert st["remote_fallbacks"] == 1 and st["remote_owner_deaths"] == 1
        assert list(rc.lane_stats()) == ["cpu"]
        # A new generation that beats re-enables routing and frees the
        # old generation's slot.
        plane.state.bump_owner_gen()
        plane.state.owner_register(os.getpid())
        assert rc._remote_active() is True
        deadline = time.monotonic() + 10
        while (plane.arena.stats()["in_use_bytes"]
               and time.monotonic() < deadline):
            time.sleep(0.05)
        assert plane.arena.stats()["in_use_bytes"] == 0
    finally:
        rc.close()


def _arena_settles(plane, timeout=10.0) -> dict:
    deadline = time.monotonic() + timeout
    while (plane.arena.stats()["in_use_bytes"]
           and time.monotonic() < deadline):
        time.sleep(0.05)                  # the listener frees after decode
    return plane.arena.stats()


@pytest.mark.parametrize("owner_dies", [False, True],
                         ids=["owner_answers", "owner_dies"])
def test_respawned_worker_adopts_its_predecessors_slots(monkeypatch,
                                                        owner_dies):
    """A worker dies with a request in flight and is respawned into its
    slot, and its first request has the predecessor's sequence number.
    The predecessor's answer resolves nothing of the successor's, the
    successor's result is its own, and every arena slot comes back:
    whether the owner answers the old request late or dies with it."""
    monkeypatch.setenv("MTPU_IPC_DISPATCH", "all")
    plane = WorkerPlane(1, arena_bytes=8 * MIB, ring_capacity=16)
    plane.state.bump_owner_gen()
    plane.state.owner_register(os.getpid())
    key = ("digest", "mxh256", 1024)
    fn = coalesce.make_digest_kernel("mxh256", "cpu")
    rng = np.random.default_rng(5)
    old, new = (rng.integers(0, 256, (4, 1024), dtype=np.uint8)
                for _ in range(2))
    # No owner serves yet: the predecessor sends, then dies unanswered.
    pred = ipc.RemoteCoalescer(plane, 0)
    assert isinstance(pred.submit(key, old, fn, device="cpu"),
                      ipc.RemoteHandle)
    pred._stopped = True
    pred._listener.join(timeout=5)
    pred.local.close()
    (old_req,) = pred._slots
    plane.state.bump_respawn(0)
    if owner_dies:
        plane.state.owner_down()
        plane.state.bump_owner_gen()
        plane.state.owner_register(os.getpid())
    owner_co, close = _serve(plane)
    succ = ipc.RemoteCoalescer(plane, 0)
    try:
        assert list(succ._slots) == [old_req]            # adopted
        h = succ.submit(key, new, fn, device="cpu")
        assert isinstance(h, ipc.RemoteHandle)
        new_req = max(succ._slots)
        assert new_req & 0xFFFFFFFF == old_req & 0xFFFFFFFF
        assert new_req != old_req
        got = np.asarray(h.result(timeout=60))
        assert np.array_equal(got, np.asarray(
            jax_fused.hash_rows_async(new, "mxh256")))
        st = _arena_settles(plane)
        assert st["in_use_bytes"] == 0 and st["allocs"] == st["frees"] == 2
        assert not plane.inflight[..., 0].any()
        assert succ.stats()["remote_results"] == 1
        # Served: both requests when the owner lived, only the new one
        # when the old request's generation died unread.
        assert owner_co.stats()["items"] == (1 if owner_dies else 2)
    finally:
        succ.close()
        close()


def test_answer_too_large_for_its_slot_is_an_error(owner_plane):
    """The owner answers inside the request's slot only: an answer that
    does not fit is an error (the engine recomputes the item) written in
    the same slot, which the worker then frees."""
    plane, _ = owner_plane
    off = plane.arena.alloc(100)
    arrays = [np.zeros(2 * MIB, np.uint8)]
    hdr, _ = ipc._encode_arrays(arrays)
    ipc._respond_ok(plane, 0, 12345, plane.owner_gen(), hdr, arrays,
                    (off, 100))
    rec = plane.resp_rings[0].get(timeout=5)
    (_, _, req, roff, _, hlen, status, _, _) = ipc._DESC.unpack(
        rec[:ipc._DESC.size])
    assert (req, roff, status) == (12345, off, ipc.ST_ERR)
    assert "exceeds its request's slot" in bytes(
        plane.arena.view(roff, hlen)).decode()
    assert plane.arena.stats()["allocs"] == 1


def test_stale_generation_request_is_dropped_unread(owner_plane):
    """A descriptor sent to a dead generation is never served: its
    worker frees the slot, and the new owner must not touch it."""
    plane, owner_co = owner_plane
    rec = ipc._DESC.pack(ipc._MAGIC, 0, 7, 0, 0, 0, ipc.ST_REQ,
                         plane.owner_gen() - 1, ipc._CPU_DEV)
    ipc._serve_one(plane, owner_co, rec)
    assert plane.resp_rings[0].depth() == 0
    assert owner_co.stats()["items"] == 0


# -- one real pool ------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra):
    env = dict(os.environ, MTPU_ROOT_USER="pooladmin",
               MTPU_ROOT_PASSWORD="pooladmin-secret", **extra)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    return env


def _get(port, path, timeout=5):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=timeout) as r:
        return r.status, r.read().decode()


def _metrics(port) -> dict:
    _, text = _get(port, "/minio/v2/metrics/node")
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            name, v = line.rsplit(" ", 1)
            out[name] = float(v)
    return out


def _wait(pred, what, timeout=60, proc=None):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if proc is not None and proc.poll() is not None:
            raise AssertionError(f"pool exited {proc.returncode} waiting "
                                 f"for {what}")
        try:
            if pred():
                return
        except OSError:
            pass
        time.sleep(0.1)
    raise AssertionError(f"timed out waiting for {what}")


def _boot(root, nworkers, extra_env=None, pythonpath=None):
    port = _free_port()
    env = _env(MTPU_WORKERS=str(nworkers), **(extra_env or {}))
    if pythonpath:
        env["PYTHONPATH"] = os.pathsep.join([pythonpath, env["PYTHONPATH"]])
    out = open(os.path.join(root, "pool.log"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "minio_tpu_torch.server", "--device", "cpu",
         "--drives", os.path.join(root, "d{1...4}"), "--port", str(port)],
        cwd=root, env=env, stdout=out, stderr=subprocess.STDOUT)
    out.close()
    return proc, port


def _log(root) -> str:
    with open(os.path.join(root, "pool.log")) as f:
        return f.read()


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    """One pool boot for the module: two workers and the device owner,
    every device kind routed through the shared-memory plane."""
    root = str(tmp_path_factory.mktemp("pool"))
    proc, port = _boot(root, 2, {"MTPU_IPC_DISPATCH": "all",
                                 "MTPU_OWNER_STALE_S": "1",
                                 "MTPU_RESPAWN_DELAY_S": "0.2"})
    try:
        def both_ready():
            m = _metrics(port)
            return all(m.get(f'mtpu_{f}{{worker="{w}"}}') == 1
                       for f in ("worker_up", "worker_ready")
                       for w in (0, 1))
        _wait(both_ready, "both workers", timeout=90, proc=proc)
        yield {"proc": proc, "port": port, "root": root,
               "cli": S3Client(f"http://127.0.0.1:{port}", "pooladmin",
                               "pooladmin-secret", timeout=60)}
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)


def _settled_metrics(port) -> dict:
    """Metrics once the 0.1 s heartbeats have published the last step."""
    time.sleep(0.6)
    return _metrics(port)


def test_pool_serves_put_get_range_through_the_owner(pool):
    cli, port = pool["cli"], pool["port"]
    m0 = _settled_metrics(port)
    cli.make_bucket("bkt")
    body = np.random.default_rng(11).bytes(3 * MIB + 12345)
    h = cli.put_object("bkt", "obj", body)
    assert h["ETag"].strip('"') == hashlib.md5(body).hexdigest()
    assert cli.get_object("bkt", "obj") == body
    st, hdrs, got = cli.request("GET", "/bkt/obj",
                                headers={"Range": "bytes=1000-2100000"})
    assert st == 206 and got == body[1000:2100001]
    m = _settled_metrics(port)
    items = (m["mtpu_owner_coalesce_items_total"]
             - m0["mtpu_owner_coalesce_items_total"])
    # The PUT's full-block batch and tail, the GET's, and the range's.
    assert items >= 4
    for w in (0, 1):
        assert m[f'mtpu_worker_ipc_fallbacks_total{{worker="{w}"}}'] == 0
        assert m[f'mtpu_worker_co_fallbacks_total{{worker="{w}"}}'] == 0
        assert m[f'mtpu_worker_kernel_items_total{{worker="{w}",'
                 f'kernel="gf_matmul"}}'] == 0


def test_requests_reach_both_workers(pool):
    port = pool["port"]
    for _ in range(40):                 # each a fresh connection
        assert _get(port, "/minio/health/ready")[0] == 200
    m = _settled_metrics(port)
    reqs = [m[f'mtpu_worker_requests_total{{worker="{w}"}}']
            for w in (0, 1)]
    assert sum(reqs) >= 40 and min(reqs) > 0
    assert m["mtpu_owner_up"] == 1 and m["mtpu_owner_generation"] == 1


def test_part_files_and_xlmeta_equal_the_jax_set(pool, tmp_path,
                                                 monkeypatch):
    import minio_tpu.engine.erasure_set as jax_es_mod
    from minio_tpu.engine.erasure_set import ErasureSet as JaxErasureSet
    from minio_tpu.storage.drive import LocalDrive as JaxLocalDrive
    from minio_tpu_torch.storage.xlmeta import XLMeta

    cli, root = pool["cli"], pool["root"]
    cli.make_bucket("cmp")
    body = np.random.default_rng(12).bytes(2 * MIB + 777)
    cli.put_object("cmp", "o", body)
    drives = [os.path.join(root, f"d{i}") for i in range(1, 5)]
    metas = [open(os.path.join(d, "cmp", "o", "xl.meta"), "rb").read()
             for d in drives]
    fi = XLMeta.from_bytes(metas[0]).latest("cmp", "o")
    monkeypatch.setattr(jax_es_mod, "new_uuid", lambda: fi.data_dir)
    jes = JaxErasureSet([JaxLocalDrive(str(tmp_path / f"j{i}"))
                         for i in range(4)])
    try:
        jes.make_bucket("cmp")
        jfi = jes.put_object("cmp", "o", body, metadata=dict(fi.metadata),
                             version_id=fi.version_id,
                             mod_time_ns=fi.mod_time_ns)
    finally:
        jes.pool.shutdown(wait=True)
        jes._iter_pool.shutdown(wait=True)
    assert jfi.erasure.distribution == fi.erasure.distribution
    for i, d in enumerate(drives):
        jd = str(tmp_path / f"j{i}")
        with open(os.path.join(jd, "cmp", "o", "xl.meta"), "rb") as f:
            assert f.read() == metas[i], f"xl.meta of drive {i}"
        for name in ("part.1",):
            with open(os.path.join(d, "cmp", "o", fi.data_dir, name),
                      "rb") as a, open(os.path.join(
                          jd, "cmp", "o", fi.data_dir, name), "rb") as b:
                assert a.read() == b.read(), f"{name} of drive {i}"


def test_overwrite_is_read_back_from_every_worker(pool):
    """An acknowledged overwrite is what the next GET returns, whichever
    worker serves either request (fresh connections land on either)."""
    cli, port = pool["cli"], pool["port"]
    cli.make_bucket("ovw")

    def fresh():
        return S3Client(f"http://127.0.0.1:{port}", "pooladmin",
                        "pooladmin-secret", timeout=60)
    for i in range(24):
        body = b"%d" % i * 100
        fresh().put_object("ovw", "k", body)
        for _ in range(2):
            assert fresh().get_object("ovw", "k") == body, i


def test_supervisor_never_loads_torch(pool):
    sup = pool["proc"].pid
    with open(f"/proc/{sup}/maps") as f:
        maps = f.read()
    assert "libtorch" not in maps and "libc10" not in maps
    owner = int(_metrics(pool["port"])["mtpu_owner_pid"])
    with open(f"/proc/{owner}/maps") as f:
        assert "libtorch" in f.read()


def test_owner_sigkill_respawns_and_loses_no_put(pool):
    cli, port, root = pool["cli"], pool["port"], pool["root"]
    cli.make_bucket("kill")
    m0 = _metrics(port)
    gen0, owner = m0["mtpu_owner_generation"], int(m0["mtpu_owner_pid"])
    bodies = [np.random.default_rng(20 + i).bytes(MIB + 3 * i)
              for i in range(3)]
    os.kill(owner, signal.SIGKILL)
    # During the gap: the PUT runs on the worker's own lanes.
    h = cli.put_object("kill", "gap", bodies[0])
    assert h["ETag"].strip('"') == hashlib.md5(bodies[0]).hexdigest()
    _wait(lambda: _metrics(port)["mtpu_owner_generation"] == gen0 + 1
          and _metrics(port)["mtpu_owner_up"] == 1, "the respawned owner",
          timeout=60, proc=pool["proc"])
    m1 = _settled_metrics(port)
    assert int(m1["mtpu_owner_pid"]) != owner
    for i, body in enumerate(bodies[1:], 1):
        cli.put_object("kill", f"after{i}", body)
    m2 = _settled_metrics(port)
    assert (m2["mtpu_owner_coalesce_items_total"]
            - m1["mtpu_owner_coalesce_items_total"]) >= 2
    for i, body in enumerate(bodies):
        name = "gap" if i == 0 else f"after{i}"
        assert cli.get_object("kill", name) == body
    fallbacks = sum(m2[f'mtpu_worker_ipc_fallbacks_total{{worker="{w}"}}']
                    + m2[f'mtpu_worker_co_fallbacks_total{{worker="{w}"}}']
                    for w in (0, 1))
    assert fallbacks > 0
    assert "respawning as generation 2" in _log(root)


def test_sigterm_drains_and_exits_zero(pool):
    proc = pool["proc"]
    proc.send_signal(signal.SIGTERM)
    assert proc.wait(timeout=30) == 0


# -- the supervisor stays light; a failing self-test ends the boot -------------

def test_supervisor_imports_leave_torch_out():
    code = ("import sys\n"
            "import minio_tpu_torch.server.__main__\n"
            "from minio_tpu_torch.server.workers import WorkerPlane\n"
            "WorkerPlane(2, arena_bytes=8 << 20, ring_capacity=16)\n"
            "print(sorted(m for m in ('torch', 'minio_tpu_torch.ops.coalesce',"
            " 'minio_tpu_torch.ops.ipc_dispatch') if m in sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_failing_self_test_ends_the_boot(tmp_path):
    hook = tmp_path / "hook"
    hook.mkdir()
    (hook / "sitecustomize.py").write_text(
        "import minio_tpu_torch.ops.selftest as st\n"
        "def _fail(device=None):\n"
        "    raise st.SelfTestError('forced device lane mismatch')\n"
        "st.run_startup_self_tests = _fail\n")
    proc, port = _boot(str(tmp_path), 2, pythonpath=str(hook))
    try:
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
    log = _log(str(tmp_path))
    assert rc != 0, log
    assert "forced device lane mismatch" in log
    assert re.search(r"device owner died during boot \(rc=1\)", log)
    assert "worker pool serving" not in log
    assert not (tmp_path / "d1" / ".mtpu.sys").exists()  # no worker booted


def test_owner_failing_its_self_test_after_a_respawn_ends_the_pool(tmp_path):
    """The first owner passes its self-tests; after a SIGKILL the
    respawned one fails them, and the pool ends non-zero instead of
    respawning it without end."""
    hook = tmp_path / "hook"
    hook.mkdir()
    passed = tmp_path / "passed-once"
    (hook / "sitecustomize.py").write_text(
        "import os\n"
        "import minio_tpu_torch.ops.selftest as st\n"
        "_run = st.run_startup_self_tests\n"
        "def _second_fails(device=None):\n"
        f"    if os.path.exists({str(passed)!r}):\n"
        "        raise st.SelfTestError('forced failure after a respawn')\n"
        f"    open({str(passed)!r}, 'w').close()\n"
        "    return _run(device)\n"
        "st.run_startup_self_tests = _second_fails\n")
    proc, port = _boot(str(tmp_path), 1, {"MTPU_RESPAWN_DELAY_S": "0.2"},
                       pythonpath=str(hook))
    try:
        _wait(lambda: _metrics(port).get('mtpu_worker_ready{worker="0"}')
              == 1, "worker 0", timeout=90, proc=proc)
        os.kill(int(_metrics(port)["mtpu_owner_pid"]), signal.SIGKILL)
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
    log = _log(str(tmp_path))
    assert rc == 1, log
    assert "forced failure after a respawn" in log
    assert "device owner of generation 2 died before it served" in log
    assert log.count("respawning as generation") == 1
    assert log.count("self-tests passed") == 1


# -- the recovery sweep runs once per pool boot ---------------------------------

def test_worker0_respawn_keeps_a_live_puts_staging(tmp_path):
    """Worker 0 is SIGKILLed while worker 1 holds a PUT stalled between
    its staging and rename_data.  The respawned worker 0 must not sweep
    the drives' tmp dir (worker 1's staging is in it): the PUT completes
    and its object reads back."""
    hook = tmp_path / "hook"
    hook.mkdir()
    gate = tmp_path / "gate"
    gate.mkdir()
    (hook / "sitecustomize.py").write_text(
        "import os, time\n"
        "import minio_tpu_torch.storage.drive as drv\n"
        "_rename = drv.LocalDrive.rename_data\n"
        f"GATE = {str(gate)!r}\n"
        "def _stalled(self, src_vol, src_dir, fi, dst_vol, dst_obj):\n"
        "    if dst_obj.startswith('stall-'):\n"
        "        mark = os.path.join(GATE, dst_obj)\n"
        "        with open(mark + '.who', 'w') as f:\n"
        "            f.write(os.environ.get('MTPU_WORKER_ID', '?'))\n"
        "        end = time.monotonic() + 60\n"
        "        while not os.path.exists(mark + '.go') \\\n"
        "                and time.monotonic() < end:\n"
        "            time.sleep(0.02)\n"
        "    return _rename(self, src_vol, src_dir, fi, dst_vol, dst_obj)\n"
        "drv.LocalDrive.rename_data = _stalled\n")
    root = str(tmp_path)
    proc, port = _boot(root, 2, {"MTPU_RESPAWN_DELAY_S": "0.2"},
                       pythonpath=str(hook))
    cli = S3Client(f"http://127.0.0.1:{port}", "pooladmin",
                   "pooladmin-secret", timeout=120)
    put = None
    try:
        _wait(lambda: all(_metrics(port).get(f'mtpu_worker_ready{{worker='
                                             f'"{w}"}}') == 1
                          for w in (0, 1)), "both workers", timeout=90,
              proc=proc)
        cli.make_bucket("sweep")
        body = np.random.default_rng(41).bytes(300 * 1024 + 7)
        # Connections spread over the workers: retry keys until a PUT
        # stalls in worker 1.
        for i in range(16):
            key = f"stall-{i}"
            res: dict = {}

            def run(key=key, res=res):
                res["st"] = cli.request("PUT", f"/sweep/{key}", body=body)[0]
            put = threading.Thread(target=run)
            put.start()
            who = gate / f"{key}.who"
            _wait(lambda: who.exists() and who.read_text(), f"{key} staged",
                  timeout=30, proc=proc)
            if who.read_text() == "1":
                break
            (gate / f"{key}.go").touch()
            put.join(timeout=60)
            put = None
        assert put is not None, "no PUT reached worker 1"
        m = _metrics(port)
        w0 = int(m['mtpu_worker_pid{worker="0"}'])
        os.kill(w0, signal.SIGKILL)
        _wait(lambda: (lambda m: m.get('mtpu_worker_respawns_total{worker='
                                       '"0"}') == 1
                       and int(m['mtpu_worker_pid{worker="0"}']) != w0
                       and m.get('mtpu_worker_ready{worker="0"}') == 1)(
            _metrics(port)), "worker 0's respawn", timeout=90, proc=proc)
        (gate / f"{key}.go").touch()
        put.join(timeout=60)
        assert res.get("st") == 200, res
        assert cli.get_object("sweep", key) == body
        log = _log(root)
        assert log.count("recovery sweep:") == 1, log
        assert re.search(r"worker 0 retired 0 metadata journal segments of "
                         rf"its predecessor \(pid {w0}\)", log), log
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        for p in gate.glob("*.who"):
            (gate / (p.name[:-4] + ".go")).touch()
        if put is not None:
            put.join(timeout=60)
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)


# -- the pool lifecycle and the scanner across workers ----------------------------

#: A sitecustomize hook for the lifecycle test: worker 0 refuses object
#: PUTs into the bucket "only1" and every decommission POST (503
#: SlowDown), so those reach worker 1 alone; each version the mover moves
#: takes 0.5 s more, so a drain is still running when a worker dies.
_LIFECYCLE_HOOK = """
import importlib.util, os, sys, time
import minio_tpu_torch.background.decom as dc

_moved = dc.Decommissioner._record_moved

def _slow(self, *a, **kw):
    time.sleep(0.5)
    return _moved(self, *a, **kw)
dc.Decommissioner._record_moved = _slow


def _refuse():
    from minio_tpu_torch.server.api_errors import S3Error
    return S3Error("SlowDown", "worker 0 declines this request")


def _patch(name, fix):
    class Hook:
        def find_spec(self, fullname, path, target=None):
            if fullname != name:
                return None
            sys.meta_path.remove(self)
            spec = importlib.util.find_spec(fullname)
            run = spec.loader.exec_module

            def exec_module(module):
                run(module)
                fix(module)
            spec.loader.exec_module = exec_module
            return spec
    sys.meta_path.insert(0, Hook())


def _fix_handlers(m):
    put = m.S3Handlers.put_object

    def guarded(self, bucket, key, *a, **kw):
        if bucket == "only1" and os.environ.get("MTPU_WORKER_ID") == "0":
            raise _refuse()
        return put(self, bucket, key, *a, **kw)
    m.S3Handlers.put_object = guarded


def _fix_server(m):
    dec = m.S3Server._admin_decommission

    def guarded(self, method, query):
        if method == "POST" and self.worker_id == 0:
            raise _refuse()
        return dec(self, method, query)
    m.S3Server._admin_decommission = guarded


_patch("minio_tpu_torch.server.handlers", _fix_handlers)
_patch("minio_tpu_torch.server.server", _fix_server)
"""

_CLOCKS = ("bytes_per_sec", "eta_seconds", "started_at")


def _until_200(fresh, call, what, tries=60):
    """call(client) on fresh connections until one answers 200 (worker 0
    declines some requests with 503)."""
    for _ in range(tries):
        got = call(fresh())
        if got[0] == 200:
            return got
        assert got[0] == 503, got
    raise AssertionError(f"no worker served {what}")


def test_pool_lifecycle_across_workers(tmp_path):
    """pool/add through one worker reaches both; a drain requested
    through worker 1 runs in worker 0 alone, outlives worker 1's and
    worker 0's SIGKILLs, moves every object byte-exact with its version
    id, and reads alike from every worker; a PUT worker 1 served is in
    worker 0's next scan.  The JAX pool runs the mover in whichever
    worker got the POST: its status answers 404 from the others, and the
    drain stalls with that worker."""
    hook = tmp_path / "hook"
    hook.mkdir()
    (hook / "sitecustomize.py").write_text(_LIFECYCLE_HOOK)
    root = str(tmp_path)
    proc, port = _boot(root, 2, {"MTPU_RESPAWN_DELAY_S": "0.2",
                                 "MTPU_SCANNER_INTERVAL": "0.3"},
                       pythonpath=str(hook))

    def fresh():
        return S3Client(f"http://127.0.0.1:{port}", "pooladmin",
                        "pooladmin-secret", timeout=60)

    def folded():
        """Every worker has folded the latest pool topology in (the
        pools and the draining set a pool/add or a drain action wrote):
        fresh connections alone may all reach one worker."""
        m = _metrics(port)
        return m["mtpu_topology_generation"] > 0 and all(
            m[f'mtpu_worker_topology_generation{{worker="{w}"}}']
            == m["mtpu_topology_generation"] for w in (0, 1))

    def respawned(w, pid):
        m = _metrics(port)
        return (int(m[f'mtpu_worker_pid{{worker="{w}"}}']) != pid
                and m.get(f'mtpu_worker_ready{{worker="{w}"}}') == 1)

    def status():
        # A connection queued on a worker as it is killed is reset.
        for _ in range(20):
            try:
                return fresh().admin("GET", "pool/decommission",
                                     {"pool": "0"})
            except OSError:
                time.sleep(0.1)
        raise AssertionError("no worker answered the status")

    def statuses(n=12):
        out = []
        for _ in range(n):
            st, doc = status()
            assert st == 200, doc
            out.append({k: v for k, v in doc.items() if k not in _CLOCKS})
        return out

    try:
        _wait(lambda: all(_metrics(port).get(
            f'mtpu_worker_ready{{worker="{w}"}}') == 1 for w in (0, 1)),
            "both workers", timeout=90, proc=proc)
        cli = fresh()
        cli.make_bucket("life")
        cli.request("PUT", "/life", query={"versioning": ""},
                    body=b"<VersioningConfiguration><Status>Enabled"
                         b"</Status></VersioningConfiguration>")
        bodies = {f"o{i}": np.random.default_rng(60 + i).bytes(
            40_000 + 997 * i) for i in range(8)}
        vids = {k: cli.put_object("life", k, v)["x-amz-version-id"]
                for k, v in bodies.items()}
        st, doc = cli.admin("POST", "pool/add",
                            doc={"drives": os.path.join(root, "e{1...4}")})
        assert (st, doc) == (200, {"pool": 1, "placement": [0, 1]})
        _wait(folded, "both workers' pools", timeout=30, proc=proc)
        assert all(len(fresh().admin("GET", "pools")[1]["pools"]) == 2
                   for _ in range(8))

        st, doc = _until_200(fresh, lambda c: c.admin(
            "POST", "pool/decommission", {"pool": "0", "action": "start"}),
            "the decommission start")
        assert doc["state"] == "draining"
        # Each worker takes pool 0 out of placement at its next look at
        # the topology generation; then new PUTs, through both workers,
        # land on pool 1.
        _wait(folded, "both placements", timeout=30, proc=proc)
        assert all(fresh().admin("GET", "pools")[1]["placement"] == [1]
                   for _ in range(8))
        for i in range(4):
            key = f"n{i}"
            bodies[key] = np.random.default_rng(80 + i).bytes(30_000 + i)
            vids[key] = fresh().put_object("life", key,
                                           bodies[key])["x-amz-version-id"]
            assert os.path.exists(os.path.join(root, "e1", "life", key,
                                               "xl.meta"))
            assert not os.path.exists(os.path.join(root, "d1", "life", key))
        _wait(lambda: statuses(1)[0]["versions_moved"] >= 2,
              "two versions moved", timeout=60, proc=proc)
        m = _metrics(port)
        w0, w1 = (int(m[f'mtpu_worker_pid{{worker="{w}"}}']) for w in (0, 1))
        os.kill(w1, signal.SIGKILL)        # the worker that took the POST
        moved = statuses(1)[0]["versions_moved"]
        _wait(lambda: statuses(1)[0]["versions_moved"] > moved,
              "the drain after worker 1's death", timeout=30, proc=proc)
        assert statuses(1)[0]["state"] == "draining"
        os.kill(w0, signal.SIGKILL)        # the mover's worker, mid-drain
        _wait(lambda: respawned(0, w0) and respawned(1, w1),
              "both respawns", timeout=90, proc=proc)
        _wait(lambda: statuses(1)[0]["state"] == "complete", "the drain",
              timeout=120, proc=proc)
        seen = statuses()
        assert all(st == seen[0] for st in seen), seen
        # Eight objects and the bucket's versioning config (an object of
        # the system volume, which the drain carries).  A version whose
        # source was reaped just before the mover's worker died has no
        # `moved` record (the resume's walk no longer sees it): one kill,
        # at most one version uncounted.
        assert seen[0]["versions_moved"] in (8, 9), seen[0]
        assert seen[0]["objects_remaining"] == 0
        for d in range(1, 5):
            assert not [n for n in os.listdir(os.path.join(root, f"d{d}",
                                                           "life"))], d
        for k, v in bodies.items():
            st, hdrs, got = fresh().request("GET", f"/life/{k}")
            assert st == 200 and got == v, k
            assert hdrs["x-amz-version-id"] == vids[k]
            assert hdrs["ETag"].strip('"') == hashlib.md5(v).hexdigest()
        log = _log(root)
        assert log.count("decommission pool 0: mover started") == 1, log
        assert "topology: 1 pools" in log and "decommissions: pool 0 " \
            "draining [worker 0]" in log, log

        # A bucket only worker 1 writes: its PUT reaches worker 0's
        # scanner through the shared marks.
        cli = fresh()
        cli.make_bucket("only1")

        def usage():
            st, doc = fresh().admin("GET", "datausage")
            assert st == 200, doc
            return (doc["buckets"].get("only1", {}).get("o"),
                    doc["scannedAt"])
        _until_200(fresh, lambda c: c.request(
            "PUT", "/only1/a", body=b"a" * 5000), "a PUT into only1")
        _wait(lambda: usage()[0] == 1, "the first scan of only1",
              timeout=30, proc=proc)
        _until_200(fresh, lambda c: c.request(
            "PUT", "/only1/b", body=b"b" * 7000), "a PUT into only1")
        t_put = time.time()
        # A cycle that ended after another that ended after the PUT began
        # after the PUT: it counts the PUT (a clean bucket is rescanned
        # only on every 16th cycle, a marked one on the next).  Stamps are
        # taken in order: worker 1 answers from usage up to a second old.
        stamps = []

        def two_cycles():
            at = usage()[1]
            if at > t_put and (not stamps or at > stamps[-1]):
                stamps.append(at)
            return len(stamps) >= 2
        _wait(two_cycles, "two scan cycles after the PUT", timeout=30,
              proc=proc)
        seen = {}

        def that_cycle():
            seen["usage"] = usage()
            return seen["usage"][1] >= stamps[-1]
        _wait(that_cycle, "a usage read of that cycle", timeout=30,
              proc=proc)
        assert seen["usage"][0] == 2, seen
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)


_LOCK_XML = (b"<ObjectLockConfiguration><ObjectLockEnabled>Enabled"
             b"</ObjectLockEnabled><Rule><DefaultRetention><Mode>GOVERNANCE"
             b"</Mode><Days>1</Days></DefaultRetention></Rule>"
             b"</ObjectLockConfiguration>")
_REPL_XML = (b"<ReplicationConfiguration><Rule><Status>Enabled</Status>"
             b"<Filter><Prefix></Prefix></Filter><Destination><Bucket>"
             b"arn:aws:s3:::dst</Bucket></Destination></Rule>"
             b"</ReplicationConfiguration>")
_VERSIONED = (b"<VersioningConfiguration><Status>Enabled</Status>"
              b"</VersioningConfiguration>")


def test_a_bucket_config_written_through_one_worker_reaches_the_other(
        tmp_path):
    """Both workers have read the source bucket's replication and
    object-lock configs as absent; then a remote target, a replication
    config and an object-lock config are stored, each through one
    worker.  The config generation makes every worker drop its cached
    configs and rewire: PUTs served by either worker take the default
    retention and reach the target, and a deregistration through one
    worker unwires both.  Without it, the worker that served no config
    PUT keeps its cached absences until it boots again (the JAX pool
    shares that fault)."""
    from minio_tpu_torch.engine.pools import ServerPools
    from minio_tpu_torch.engine.sets import ErasureSets
    from minio_tpu_torch.server.server import S3Server
    from minio_tpu_torch.server.sigv4 import Credentials
    from minio_tpu_torch.storage.drive import LocalDrive

    root = str(tmp_path)
    dst = ServerPools([ErasureSets(
        [LocalDrive(f"{root}/t{i}") for i in range(4)], set_drive_count=4,
        device="cpu")])
    tsrv = S3Server(dst, Credentials("pooladmin", "pooladmin-secret")
                    ).start()
    proc, port = _boot(root, 2, {"MTPU_SCANNER": "0",
                                 "MTPU_REPL_RETRY_INTERVAL": "0.05"})

    def fresh():
        return S3Client(f"http://127.0.0.1:{port}", "pooladmin",
                        "pooladmin-secret", timeout=60)

    def reloaded():
        """Every worker has reloaded the latest config generation."""
        m = _metrics(port)
        return m["mtpu_config_generation"] > 0 and all(
            m[f'mtpu_worker_config_generation{{worker="{w}"}}']
            == m["mtpu_config_generation"] for w in (0, 1))

    def requests():
        m = _settled_metrics(port)
        return [m[f'mtpu_worker_requests_total{{worker="{w}"}}']
                for w in (0, 1)]

    def put_spread(prefix, n, seed):
        """n PUTs on fresh connections, and more until both workers
        served one (the metrics reads are requests too: each of the
        `reads` may have landed on one worker, the first one counted)."""
        before, out, i, reads = requests(), {}, 0, 1
        while True:
            for _ in range(n):
                key = f"{prefix}{i:02d}"
                data = np.random.default_rng(seed + i).bytes(20_000 + i)
                out[key] = (data, fresh().put_object("src", key, data)[
                    "x-amz-version-id"])
                i += 1
            reads += 1
            if min(a - b for a, b in zip(requests(), before)) > reads:
                return out
            assert i < 4 * n, "every PUT reached one worker"

    tcli = S3Client(tsrv.endpoint, "pooladmin", "pooladmin-secret",
                    timeout=60)
    try:
        _wait(lambda: all(_metrics(port).get(
            f'mtpu_worker_ready{{worker="{w}"}}') == 1 for w in (0, 1)),
            "both workers", timeout=90, proc=proc)
        for cli, b in ((fresh(), "src"), (tcli, "dst")):
            cli.make_bucket(b)
            assert cli.request("PUT", f"/{b}", query={"versioning": ""},
                               body=_VERSIONED)[0] == 200
        put_spread("pre/", 8, 100)           # both cache the absences
        st, _, body = fresh().request(
            "POST", "/minio/admin/v3/bucket-remote", query={"bucket": "src"},
            body=json.dumps({"endpoint": tsrv.endpoint,
                             "accessKey": "pooladmin",
                             "secretKey": "pooladmin-secret",
                             "targetBucket": "dst"}).encode())
        assert st == 200, body
        arn = json.loads(body)["arn"]
        for sub, xml in (("replication", _REPL_XML),
                         ("object-lock", _LOCK_XML)):
            st, _, body = fresh().request("PUT", "/src", query={sub: ""},
                                          body=xml)
            assert st == 200, body
        # Each worker's idle loop looks at the generation every 0.25 s.
        _wait(reloaded, "both workers' reload", timeout=30, proc=proc)
        assert all(fresh().request("GET", "/src",
                                   query={"object-lock": ""})[0] == 200
                   for _ in range(12))
        wired = put_spread("post/", 16, 200)
        for key, (data, vid) in wired.items():
            _wait(lambda k=key: tcli.request("HEAD", f"/dst/{k}")[0] == 200,
                  f"{key} on the target", timeout=30, proc=proc)
            h = tcli.head_object("dst", key)
            assert h.get("x-amz-version-id") == vid
            assert h.get("x-amz-replication-status") == "REPLICA"
            assert tcli.get_object("dst", key) == data
            st, _, body = fresh().request(
                "DELETE", f"/src/{key}", query={"versionId": vid})
            assert st == 400 and b"ObjectLocked" in body, (key, st)
        st, _, body = fresh().request(
            "DELETE", "/minio/admin/v3/bucket-remote",
            query={"bucket": "src", "arn": arn})
        assert st == 200, body
        _wait(reloaded, "both workers' reload", timeout=30, proc=proc)
        unwired = put_spread("gone/", 8, 300)
        time.sleep(1.5)
        for key in unwired:
            assert tcli.request("HEAD", f"/dst/{key}")[0] == 404, key
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        tsrv.shutdown()
        for pool in dst.pools:
            for es in pool.sets:
                es.close()


# -- fork-shared locks and slots that survive a killed worker -----------------

#: Run in a subprocess (never a fork of pytest): build one structure, fork
#: a child that takes its lock (and leaves a write half done), SIGKILL it,
#: then lock, read and write it from this process and from a second child,
#: and check its invariants.  `signal.alarm` ends a run that hangs.
_KILLED_HOLDER = r"""
import json, os, signal, sys, time
signal.alarm(40)
import numpy as np
what = sys.argv[1]

if what == "tier":
    from minio_tpu_torch.engine.hotcache import HotObjectCache
    s = HotObjectCache(total_bytes=1 << 20, n_entries=16, max_obj=1 << 16)
    body = b"b" * 5000
    for _ in range(2):                       # two-hit admission
        s.fill("bk", "hot", "", {"v": 1}, body, s.generation("bk"))
    assert s.lookup("bk", "hot", "") is not None
    lock = s._mu

    def half_done():
        # A fill cut off after its arena run, before its entry.
        off = s.arena.alloc(9000, timeout=0)
        s.arena.view(off, 9000)[:] = 7

    def use():
        for _ in range(2):
            s.fill("bk", "k%d" % os.getpid(), "", {"v": 2}, b"x" * 3000,
                   s.generation("bk"))
        got = s.lookup("bk", "k%d" % os.getpid(), "")
        assert got is not None and got[1] == b"x" * 3000, got
        assert s.lookup("bk", "hot", "") is None   # the index was dropped

    def check():
        st = s.stats()
        live = int(np.count_nonzero(s._ent[:, 0]))
        runs = int(np.count_nonzero(s.arena._runs))
        return {"entries": st["entries"], "live": live, "runs": runs,
                "repairs": s.arena.repairs + lock.repairs}
elif what == "arena":
    from minio_tpu_torch.ops.shm_arena import ShmArena
    s = ShmArena(16 << 20, slot_bytes=1 << 20)
    keep = s.alloc(3 << 20)
    lock = s._cv

    def half_done():
        # An alloc cut off between its run record and its bitmap, and a
        # free cut off between its record and its bitmap.
        s._runs[8] = 4
        s._bitmap[8:10] = 1
        s._bitmap[14:16] = 1

    def use():
        off = s.alloc(2 << 20, timeout=1)
        s.view(off, 4)[:] = 1
        s.free(off, 2 << 20)

    def check():
        bm = np.zeros(s.nslots, np.uint8)
        for first in np.nonzero(s._runs)[0].tolist():
            bm[first:first + int(s._runs[first])] = 1
        st = s.stats()
        return {"bitmap_matches_runs": bool((bm == s._bitmap).all()),
                "in_use": st["in_use_bytes"],
                "want_in_use": int(bm.sum()) * s.slot_bytes,
                "keep_held": bool(s._runs[s._first(keep)] == 3),
                "repairs": s.repairs}
else:
    from minio_tpu_torch.server.qos import QoSPlane
    s = QoSPlane(nworkers=3, max_slots=4, deadline_ms=100, queue_max=4)
    s.bind_row(2)
    assert s.acquire("premium")[0] == "ok"     # row 2 holds one slot
    lock = s._cv

    def half_done():
        # An admission cut off between its row and the pool total.
        s.bind_row(1)
        s._a[s._row] += 1

    def use():
        s.bind_row(0)
        assert s.acquire("premium")[0] == "ok"
        s.release()

    def check():
        st = s.stats()
        rows = s.worker_rows()
        return {"inflight": st["inflight"],
                "rows_sum": sum(r[0] for r in rows),
                "waiting": st["waiting"], "repairs": lock.repairs}

r, w = os.pipe()
pid = os.fork()
if pid == 0:
    lock.acquire()
    half_done()
    os.write(w, b"x")
    time.sleep(60)
    os._exit(0)
os.read(r, 1)
os.kill(pid, signal.SIGKILL)
os.waitpid(pid, 0)
t0 = time.monotonic()
use()                                   # this process: lock, read, write
pid = os.fork()
if pid == 0:
    use()                               # a second child
    os._exit(0)
rc = os.waitstatus_to_exitcode(os.waitpid(pid, 0)[1])
out = check()
out.update({"s": time.monotonic() - t0, "child_rc": rc})
print(json.dumps(out))
"""


@pytest.mark.parametrize("what", ["tier", "arena", "slab"])
def test_killed_lock_holder_leaves_the_structure_usable(what):
    """A forked child SIGKILLed while it holds the structure's lock (a
    write half done): this process and a second child then lock, read
    and write it within 2 s, and the next locker has repaired it — the
    tier's index dropped (nothing of the half fill served), the arena's
    bitmap and occupancy equal to its runs, the slab's totals equal to
    its per-worker rows."""
    out = subprocess.run([sys.executable, "-c", _KILLED_HOLDER, what],
                         cwd=ROOT, env=_env(), capture_output=True,
                         text=True, timeout=60)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["s"] < 2.0 and res["child_rc"] == 0, res
    assert res["repairs"] == 1, res
    if what == "tier":
        # The children's two fills; the half fill's run went back.
        assert res["entries"] == res["live"] == 2, res
        assert res["runs"] == 2, res
    elif what == "arena":
        assert res["bitmap_matches_runs"] and res["keep_held"], res
        assert res["in_use"] == res["want_in_use"] == 7 << 20, res
    else:
        assert res["inflight"] == res["rows_sum"] == 2, res
        assert res["waiting"] == 0, res


_KILLED_AFTER_ALLOC = r"""
import json, os, signal, sys
signal.alarm(40)
import numpy as np
from minio_tpu_torch.ops import ipc_dispatch as ipc
from minio_tpu_torch.server.workers import WorkerPlane

plane = WorkerPlane(1, arena_bytes=8 << 20, ring_capacity=16)
plane.state.bump_owner_gen()
plane.state.owner_register(os.getpid())
pid = os.fork()
if pid == 0:
    ipc.after_alloc_hook = lambda: os.kill(os.getpid(), signal.SIGKILL)
    rc = ipc.RemoteCoalescer(plane, 0)
    rc._submit_remote(("digest", "mxh256", 1024),
                      np.zeros((4, 1024), np.uint8), None, "cpu")
    os._exit(3)
st = os.waitpid(pid, 0)[1]
held = plane.arena.stats()["in_use_bytes"]
plane.state.bump_respawn(0)
succ = ipc.RemoteCoalescer(plane, 0)
print(json.dumps({"killed": os.WIFSIGNALED(st), "held_before": held,
                  "held_after": plane.arena.stats()["in_use_bytes"],
                  "ledger": int(plane.inflight[..., 0].any())}))
succ.close()
"""


def test_worker_killed_right_after_alloc_leaves_no_slot():
    """A worker SIGKILLed between its arena alloc and its ledger row:
    the slot carries its owner, and the respawned worker frees it."""
    out = subprocess.run([sys.executable, "-c", _KILLED_AFTER_ALLOC],
                         cwd=ROOT, env=_env(MTPU_IPC_DISPATCH="all"),
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["killed"] and res["held_before"] > 0, res
    assert res["held_after"] == 0 and res["ledger"] == 0, res


def test_undeliverable_answer_frees_its_slot_once(monkeypatch):
    """The owner cannot push an answer (the worker's response ring is
    full): it frees the request's slot, once.  The worker's watchdog
    then fails the handle and drops the ledger row without freeing the
    slot again, though it has been allocated anew meanwhile."""
    monkeypatch.setenv("MTPU_IPC_DISPATCH", "all")
    monkeypatch.setenv("MTPU_OWNER_STALE_S", "60")
    plane = WorkerPlane(1, arena_bytes=8 * MIB, ring_capacity=2)
    plane.state.bump_owner_gen()
    plane.state.owner_register(os.getpid())
    co = coalesce.DispatchCoalescer()
    rc = ipc.RemoteCoalescer(plane, 0)
    # No listener thread: it would make room in the ring; the watchdog
    # runs by hand below.
    monkeypatch.setattr(rc, "_ensure_listener", lambda: None)
    try:
        x = np.random.default_rng(3).integers(0, 256, (4, 1024),
                                              dtype=np.uint8)
        start = plane.arena.stats()
        h = rc._submit_remote(("digest", "mxh256", 1024), x, None, "cpu")
        (req,) = rc._slots
        off = rc._slots[req][1]
        while plane.resp_rings[0].put(b"full", timeout=0):
            pass                                  # the ring is full
        ipc._serve_one(plane, co, plane.req_ring.get(timeout=5))
        st = plane.arena.stats()
        assert st["in_use_bytes"] == start["in_use_bytes"]
        assert st["frees"] == st["allocs"] == 1
        # The freed slot is someone else's now: the worker's retirement
        # of the request must leave it alone.
        other = plane.arena.alloc(100)
        assert other == off
        plane.resp_rings[0].drain()
        rc._check_owner()
        with pytest.raises(RuntimeError, match="could not deliver"):
            h.result(timeout=5)
        rc._release(req)
        st = plane.arena.stats()
        assert st["in_use_bytes"] == plane.arena.slot_bytes
        assert st["frees"] == 1 and req not in rc._slots
        assert not plane.inflight[..., 0].any()
        plane.arena.free(other, 100)
    finally:
        rc.close()
        co.close()


# -- notifications and the server config across workers -----------------------

#: A sitecustomize hook for the notification tests: worker 1 declines the
#: config writes (a `?notification` PUT, an admin config POST) and the
#: PUTs into "only0"; worker 0 declines the PUTs into "only1" and the
#: DELETEs in "only0".  The retry loop runs every 0.1 s; worker 0's
#: starts 1.5 s late, so worker 1's loop is the first to look.
_NOTIFY_HOOK = _LIFECYCLE_HOOK.split("def _fix_handlers")[0].replace(
    """import minio_tpu_torch.background.decom as dc

_moved = dc.Decommissioner._record_moved

def _slow(self, *a, **kw):
    time.sleep(0.5)
    return _moved(self, *a, **kw)
dc.Decommissioner._record_moved = _slow
""", """import minio_tpu_torch.bucket.notify as nt
nt.RETRY_INTERVAL_S = 0.1
_loop = nt._Backlogged._retry_loop


def _late_loop(self):
    if os.environ.get("MTPU_WORKER_ID") == "0":
        time.sleep(1.5)
    return _loop(self)
nt._Backlogged._retry_loop = _late_loop
""") + '''
def _fix_handlers(m):
    put = m.S3Handlers.put_object
    dele = m.S3Handlers.delete_object
    cfg = m.S3Handlers.put_bucket_config

    def guarded(self, bucket, key, *a, **kw):
        me = os.environ.get("MTPU_WORKER_ID")
        if (bucket, me) in (("only1", "0"), ("only0", "1")):
            raise _refuse()
        return put(self, bucket, key, *a, **kw)

    def guarded_del(self, bucket, key, *a, **kw):
        if bucket == "only0" and os.environ.get("MTPU_WORKER_ID") == "0":
            raise _refuse()
        return dele(self, bucket, key, *a, **kw)

    def guarded_cfg(self, bucket, sub, body):
        if os.environ.get("MTPU_WORKER_ID") == "1":
            raise _refuse()
        return cfg(self, bucket, sub, body)
    m.S3Handlers.put_object = guarded
    m.S3Handlers.delete_object = guarded_del
    m.S3Handlers.put_bucket_config = guarded_cfg


def _fix_server(m):
    conf = m.S3Server._admin_config

    def guarded(self, method, query, body):
        if method == "POST" and self.worker_id == 1:
            raise _refuse()
        return conf(self, method, query, body)
    m.S3Server._admin_config = guarded


_patch("minio_tpu_torch.server.handlers", _fix_handlers)
_patch("minio_tpu_torch.server.server", _fix_server)
'''


def test_notifications_and_config_across_workers(tmp_path):
    """A `?notification` rule and a `config set storage_class` stored
    through worker 0 govern PUTs worker 1 serves (the JAX pool sets them
    in the serving worker alone).  Both workers park in the pool's one
    store while the webhook is down, and its one sender delivers every
    event once, none lost across worker 1's respawn (the JAX pool's
    workers share one directory with no sender: each loads, re-sends
    and unlinks the others' events)."""
    from test_torch_notify import Receiver
    from minio_tpu_torch.storage.xlmeta import XLMeta
    recv = Receiver()
    hook = tmp_path / "hook"
    hook.mkdir()
    (hook / "sitecustomize.py").write_text(_NOTIFY_HOOK)
    root = str(tmp_path)
    store = tmp_path / "store"
    proc, port = _boot(root, 2, {
        "MTPU_RESPAWN_DELAY_S": "0.2", "MTPU_SCANNER": "0",
        "MTPU_NOTIFY_WEBHOOK_ENABLE": "on",
        "MTPU_NOTIFY_WEBHOOK_ENDPOINT": recv.url,
        "MTPU_NOTIFY_STORE_DIR": str(store)}, pythonpath=str(hook))

    def fresh():
        return S3Client(f"http://127.0.0.1:{port}", "pooladmin",
                        "pooladmin-secret", timeout=60)

    def reloaded():
        m = _metrics(port)
        return m["mtpu_config_generation"] > 0 and all(
            m[f'mtpu_worker_config_generation{{worker="{w}"}}']
            == m["mtpu_config_generation"] for w in (0, 1))

    def put(bucket, key, body, headers=None):
        return _until_200(fresh, lambda c: c.request(
            "PUT", f"/{bucket}/{key}", body=body, headers=headers),
            f"{bucket}/{key}")

    rules = (b"<NotificationConfiguration><QueueConfiguration><Queue>"
             b"arn:minio:sqs::1:webhook</Queue><Event>s3:ObjectCreated:*"
             b"</Event></QueueConfiguration></NotificationConfiguration>")
    try:
        _wait(lambda: all(_metrics(port).get(
            f'mtpu_worker_ready{{worker="{w}"}}') == 1 for w in (0, 1)),
            "both workers", timeout=90, proc=proc)
        for b in ("only0", "only1"):
            fresh().make_bucket(b)
            put(b, "before", b"no rule yet")        # both cache absences
        for b in ("only0", "only1"):
            _until_200(fresh, lambda c, b=b: c.request(
                "PUT", f"/{b}", query={"notification": ""}, body=rules),
                f"the rules of {b}")
        _wait(reloaded, "both workers' reload", timeout=30, proc=proc)
        put("only1", "routed", b"served by worker 1")
        assert [r["s3"]["object"]["key"] for r in recv.records] == \
            ["routed"]
        _until_200(fresh, lambda c: c.admin("POST", "config", doc={
            "subsys": "storage_class", "key": "standard",
            "value": "EC:1"}), "the config set")
        _wait(reloaded, "both workers' reload", timeout=30, proc=proc)
        put("only1", "sc", b"s" * 200_000,
            {"x-amz-storage-class": "STANDARD"})
        raw = open(os.path.join(root, "d1", "only1", "sc", "xl.meta"),
                   "rb").read()
        assert XLMeta.from_bytes(raw).latest().erasure.parity_blocks == 1

        # The outage: both workers park in the pool's one store.
        recv.up = False
        keys = {w: [f"w{w}-{i}" for i in range(4)] for w in (0, 1)}
        for w in (0, 1):
            for k in keys[w]:
                put(f"only{w}", k, k.encode())
        assert len([n for n in os.listdir(store / "webhook")
                    if n.endswith(".json")]) == 8
        m = _settled_metrics(port)
        for w in (0, 1):
            lab = f'{{worker="{w}"}}'
            assert m[f"mtpu_worker_notify_backlog_events{lab}"] == 8
            assert m[f"mtpu_worker_notify_events_parked_total{lab}"] == 4
        pid1 = int(m['mtpu_worker_pid{worker="1"}'])
        os.kill(pid1, signal.SIGKILL)
        _wait(lambda: int(_metrics(port)['mtpu_worker_pid{worker="1"}'])
              != pid1 and _metrics(port)['mtpu_worker_ready{worker="1"}']
              == 1, "worker 1's respawn", timeout=90, proc=proc)
        recv.up = True
        want = sorted(keys[0] + keys[1])

        def delivered():
            return sorted(r["s3"]["object"]["key"] for r in recv.records
                          if r["s3"]["object"]["key"].startswith("w"))
        _wait(lambda: len(delivered()) >= 8, "the parked events",
              timeout=30, proc=proc)
        time.sleep(1.0)                # a second copy would come now
        assert delivered() == want
        assert os.listdir(store / "webhook") == []
        m = _settled_metrics(port)
        assert m['mtpu_worker_notify_backlog_events{worker="0"}'] == 0
        assert m['mtpu_worker_notify_backlog_events{worker="1"}'] == 0
        assert sum(m[f'mtpu_worker_notify_events_retried_total'
                     f'{{worker="{w}"}}'] for w in (0, 1)) == 8
        assert "notification targets: arn:minio:sqs::1:webhook [worker " \
            "0]" in _log(root)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        recv.close()


def test_a_keys_events_keep_their_order_across_workers(tmp_path):
    """A key's PUT, parked by worker 0 while the webhook is down, reaches
    the webhook before that key's DELETE, which worker 1 serves once the
    webhook is back: the DELETE parks behind the pool's one store and its
    one sender delivers both in arrival order, each once.  With a store
    per worker, worker 1 found its own store empty and posted the DELETE
    at once, ahead of the PUT parked in worker 0's."""
    from test_torch_notify import Receiver
    recv = Receiver()
    hook = tmp_path / "hook"
    hook.mkdir()
    (hook / "sitecustomize.py").write_text(_NOTIFY_HOOK)
    root = str(tmp_path)
    store = tmp_path / "store"
    proc, port = _boot(root, 2, {
        "MTPU_SCANNER": "0", "MTPU_NOTIFY_WEBHOOK_ENABLE": "on",
        "MTPU_NOTIFY_WEBHOOK_ENDPOINT": recv.url,
        "MTPU_NOTIFY_STORE_DIR": str(store)}, pythonpath=str(hook))

    def fresh():
        return S3Client(f"http://127.0.0.1:{port}", "pooladmin",
                        "pooladmin-secret", timeout=60)

    rules = (b"<NotificationConfiguration><QueueConfiguration><Queue>"
             b"arn:minio:sqs::1:webhook</Queue><Event>s3:ObjectCreated:*"
             b"</Event><Event>s3:ObjectRemoved:*</Event>"
             b"</QueueConfiguration></NotificationConfiguration>")
    try:
        _wait(lambda: all(_metrics(port).get(
            f'mtpu_worker_ready{{worker="{w}"}}') == 1 for w in (0, 1)),
            "both workers", timeout=90, proc=proc)
        fresh().make_bucket("only0")
        _until_200(fresh, lambda c: c.request(
            "PUT", "/only0", query={"notification": ""}, body=rules),
            "the rules")
        _wait(lambda: all(
            _metrics(port)[f'mtpu_worker_config_generation{{worker="{w}"}}']
            == _metrics(port)["mtpu_config_generation"] for w in (0, 1)),
            "both workers' reload", timeout=30, proc=proc)
        recv.up = False
        _until_200(fresh, lambda c: c.request("PUT", "/only0/k",
                                              body=b"v"), "the PUT")
        assert _settled_metrics(port)[
            'mtpu_worker_notify_events_parked_total{worker="0"}'] == 1
        recv.up = True
        _until_status(fresh, lambda c: c.request("DELETE", "/only0/k"),
                      "the DELETE", 204)
        _wait(lambda: len(recv.records) >= 2, "both events", timeout=30,
              proc=proc)
        time.sleep(0.5)                # a second copy would come now
        assert [(r["eventName"], r["s3"]["object"]["key"])
                for r in recv.records] == [
            ("s3:ObjectCreated:Put", "k"), ("s3:ObjectRemoved:Delete", "k")]
        assert [n for n in os.listdir(store / "webhook")] == []
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        recv.close()


# -- the tier across workers ---------------------------------------------------

#: A sitecustomize hook for the tier test: worker 1 declines the admin
#: `tier` and `ilm` POSTs and the restores, worker 0 the GETs, HEADs and
#: DELETEs in bucket "tierb"; while the file TIER_DOWN_FLAG exists the
#: directory tier refuses every delete.
_TIER_HOOK = _LIFECYCLE_HOOK.split("def _fix_handlers")[0].replace(
    """import minio_tpu_torch.background.decom as dc

_moved = dc.Decommissioner._record_moved

def _slow(self, *a, **kw):
    time.sleep(0.5)
    return _moved(self, *a, **kw)
dc.Decommissioner._record_moved = _slow
""", "") + '''
def _worker():
    return os.environ.get("MTPU_WORKER_ID")


def _fix_tier(m):
    delete = m.DirTierBackend.delete

    def flaky(self, key):
        if os.path.exists(os.environ["TIER_DOWN_FLAG"]):
            raise m.ErrTierUnavailable("the tier is down (test flag)")
        return delete(self, key)
    m.DirTierBackend.delete = flaky


def _fix_handlers(m):
    get, dele = m.S3Handlers.get_object, m.S3Handlers.delete_object

    def guarded_get(self, bucket, key, *a, **kw):
        if bucket == "tierb" and _worker() == "0":
            raise _refuse()
        return get(self, bucket, key, *a, **kw)

    def guarded_del(self, bucket, key, *a, **kw):
        if bucket == "tierb" and _worker() == "0":
            raise _refuse()
        return dele(self, bucket, key, *a, **kw)
    m.S3Handlers.get_object = guarded_get
    m.S3Handlers.delete_object = guarded_del


def _fix_server(m):
    tier, ilm, restore = (m.S3Server._admin_tier, m.S3Server._admin_ilm,
                          m.S3Server._restore)

    def guarded_tier(self, method, query, body):
        if method == "POST" and self.worker_id == 1:
            raise _refuse()
        return tier(self, method, query, body)

    def guarded_ilm(self, method, body):
        if method == "POST" and self.worker_id == 1:
            raise _refuse()
        return ilm(self, method, body)

    def guarded_restore(self, *a, **kw):
        if self.worker_id == 1:
            raise _refuse()
        return restore(self, *a, **kw)
    m.S3Server._admin_tier = guarded_tier
    m.S3Server._admin_ilm = guarded_ilm
    m.S3Server._restore = guarded_restore


_patch("minio_tpu_torch.bucket.tier", _fix_tier)
_patch("minio_tpu_torch.server.handlers", _fix_handlers)
_patch("minio_tpu_torch.server.server", _fix_server)
'''


def _until_status(fresh, call, what, want, tries=60):
    """call(client) on fresh connections until one answers `want` (the
    other worker declines with 503)."""
    for _ in range(tries):
        got = call(fresh())
        if got[0] == want:
            return got
        assert got[0] == 503, got
    raise AssertionError(f"no worker served {what}")


def test_tier_across_workers(tmp_path):
    """A tier added and an object transitioned through worker 0 serve a
    stub GET (full and ranged) and HEAD through worker 1.  With the tier
    refusing deletes, a permanent restore through worker 0 and a stub
    DELETE through worker 1 each leave a pending free; every append
    compacts the one journal (MTPU_ILM_CKPT_EVERY=1), and both frees
    are still in it (a per-process fold, as in the JAX pool, keeps only
    its own).  Once the tier is back a drain frees both."""
    from minio_tpu_torch.bucket import tier as port_tier
    hook = tmp_path / "hook"
    hook.mkdir()
    (hook / "sitecustomize.py").write_text(_TIER_HOOK)
    root = str(tmp_path)
    warm = str(tmp_path / "warm")
    flag = tmp_path / "tier-down"
    proc, port = _boot(root, 2, {
        "MTPU_RESPAWN_DELAY_S": "0.2", "MTPU_SCANNER": "0",
        "MTPU_ILM_CKPT_EVERY": "1", "TIER_DOWN_FLAG": str(flag)},
        pythonpath=str(hook))

    def fresh():
        return S3Client(f"http://127.0.0.1:{port}", "pooladmin",
                        "pooladmin-secret", timeout=60)

    data = {k: np.random.default_rng(i).bytes(300_000 + i)
            for i, k in enumerate(("a", "b"))}
    try:
        _wait(lambda: all(_metrics(port).get(
            f'mtpu_worker_ready{{worker="{w}"}}') == 1 for w in (0, 1)),
            "both workers", timeout=90, proc=proc)
        fresh().make_bucket("tierb")
        for k, v in data.items():
            fresh().put_object("tierb", k, v)
        _until_status(fresh, lambda c: c.admin("POST", "tier", doc={
            "name": "warm", "type": "fs", "path": warm}), "tier add", 200)
        for k in data:
            st, doc = _until_status(fresh, lambda c, k=k: c.admin(
                "POST", "ilm", doc={"bucket": "tierb", "object": k,
                                    "tier": "WARM"}), f"ilm {k}", 200)
            assert doc == {"transitioned": True}
        tkeys = sorted(os.listdir(warm))
        assert len(tkeys) == 2
        st, h, body = _until_status(fresh, lambda c: c.request(
            "GET", "/tierb/a"), "the stub GET", 200)
        assert body == data["a"]
        st, h, body = _until_status(fresh, lambda c: c.request(
            "GET", "/tierb/a", headers={"Range": "bytes=1000-1999"}),
            "the ranged stub GET", 206)
        assert body == data["a"][1000:2000]
        st, h, _ = _until_status(fresh, lambda c: c.request(
            "HEAD", "/tierb/b"), "the stub HEAD", 200)
        assert h["x-amz-storage-class"] == "WARM"
        assert int(h["Content-Length"]) == len(data["b"])

        flag.write_text("down")
        _until_status(fresh, lambda c: c.request(
            "POST", "/tierb/a", query={"restore": ""}), "the restore", 202)
        _until_status(fresh, lambda c: c.request("DELETE", "/tierb/b"),
                      "the stub DELETE", 204)
        path = os.path.join(root, "d1", ".mtpu.sys", "tier-journal.jsonl")
        with open(path) as f:
            lines = [json.loads(line) for line in f if line.strip()]
        assert [r["op"] for r in lines] == ["ckpt"]   # compacted
        frees = port_tier.TierJournal(path).frees
        assert sorted(k.replace("/", "_") for k in frees) == tkeys
        assert sorted(os.listdir(warm)) == tkeys

        flag.unlink()
        st, doc = _until_status(fresh, lambda c: c.admin(
            "POST", "ilm", doc={"op": "drain"}), "the drain", 200)
        assert doc == {"freed": 2, "pending": 0}
        assert os.listdir(warm) == []
        st, _, body = _until_status(fresh, lambda c: c.request(
            "GET", "/tierb/a"), "the restored GET", 200)
        assert body == data["a"]
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
