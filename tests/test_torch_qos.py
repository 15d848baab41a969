"""The port's admission plane (minio_tpu_torch/server/qos.py) and its call
sites, held to the JAX package's (minio_tpu/server/qos.py; device="cpu").
Tolerance: exact.

Layers, cheapest first:

- QoSPlane units, each run on both packages' planes: acquire/release,
  instant and deadline sheds, the class ladder, token buckets with
  post-paid debt, the pressure EMA and its hook, scale_workers and
  bg_pause, the module facades and knobs; then one seeded sequence of
  acquires, releases, token-bucket calls and clock steps on both planes
  under one pinned clock: the same verdicts, pressures and counters.
- Fork sharing, in a subprocess (never a fork of pytest): a child's slot
  counts in the parent; and the slab leak the port repairs: a child that
  holds 3 of 4 slots is SIGKILLed, its row is cleared as the supervisor
  clears it, and 4 requests are then admitted at once (the JAX plane,
  which has no rows, is played the same sequence and its verdicts are
  printed).
- Over HTTP, each server held to the JAX server on the same requests:
  the shed answer (503 SlowDown, Retry-After: 1, connection closed), the
  exempt planes, tenant and bucket throttles, ?quota's hard limit and
  validation, and MTPU_QOS=0 (byte-identical responses); heal's yield;
  drain, shed and a chaos storm composed; and one real pool
  (MTPU_WORKERS=2) where a stalled reader holds the only slot, every
  worker sheds, and the SIGKILL of the worker that holds it gives the
  slot back through the supervisor.
"""

import hashlib
import json
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time
import types
from pathlib import Path

import numpy as np
import pytest

from minio_tpu.server import qos as jax_qos
from minio_tpu_torch.server import qos
from minio_tpu_torch.server.client import S3Client
from minio_tpu_torch.server.sigv4 import Credentials, sign_request
from test_torch_server import JAX, PORT, TIMEOUT, close_pools

ROOT = Path(__file__).resolve().parent.parent
ACCESS, SECRET = "qosadmin", "qosadmin-secret"
MODS = {"jax": jax_qos, "port": qos}


def payload(size, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, size, dtype=np.uint8).tobytes()


@pytest.fixture(autouse=True)
def fresh_planes():
    """Each test builds its planes from its own knobs; later tests get
    the defaults back."""
    for m in MODS.values():
        m.reset_for_tests()
    yield
    for m in MODS.values():
        m.reset_for_tests()


@pytest.fixture(params=list(MODS), ids=list(MODS))
def mod(request):
    return MODS[request.param]


def settle(plane, timeout=5.0):
    """Wait for inflight to reach zero: a handler releases its slot a
    beat after the response bytes are on the wire."""
    deadline = time.monotonic() + timeout
    while plane.stats()["inflight"] != 0:
        assert time.monotonic() < deadline, "admission slot leaked"
        time.sleep(0.01)


# -- QoSPlane units, on both planes -------------------------------------------

class TestQoSPlane:
    def test_acquire_release_roundtrip(self, mod):
        p = mod.QoSPlane(max_slots=2, deadline_ms=100, queue_max=4)
        v, w = p.acquire("premium")
        assert v == "ok" and w == 0.0
        s = p.stats()
        assert s["inflight"] == 1 and s["admitted"] == 1
        assert s["classes"]["premium"]["admitted"] == 1
        p.release()
        assert p.stats()["inflight"] == 0

    def test_full_slots_zero_queue_sheds_instantly(self, mod):
        p = mod.QoSPlane(max_slots=1, deadline_ms=5000, queue_max=0)
        assert p.acquire()[0] == "ok"
        t0 = time.monotonic()
        v, _ = p.acquire()
        assert v == "shed-queue"
        assert time.monotonic() - t0 < 1.0
        s = p.stats()
        assert s["shed"] == 1 and s["shed_queue"] == 1

    def test_deadline_shed_after_bounded_wait(self, mod):
        p = mod.QoSPlane(max_slots=1, deadline_ms=150, queue_max=4)
        assert p.acquire()[0] == "ok"
        t0 = time.monotonic()
        v, waited = p.acquire()
        dt = time.monotonic() - t0
        assert v == "shed-deadline"
        assert 0.1 <= dt < 5.0 and waited >= 0.1
        s = p.stats()
        assert s["shed_deadline"] == 1 and s["waiting"] == 0

    def test_release_wakes_queued_waiter(self, mod):
        p = mod.QoSPlane(max_slots=1, deadline_ms=10_000, queue_max=4)
        assert p.acquire()[0] == "ok"
        got = {}

        def waiter():
            got["v"], got["w"] = p.acquire()

        t = threading.Thread(target=waiter, daemon=True)
        t.start()
        deadline = time.monotonic() + 5
        while p.stats()["waiting"] < 1:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        p.release()
        t.join(timeout=10)
        assert not t.is_alive()
        assert got["v"] == "ok" and got["w"] > 0
        assert p.stats()["queue_wait_seconds"] > 0
        p.release()

    def test_class_ladder_starves_best_effort_first(self, mod):
        # 4 slots: best-effort rung = ceil(0.5*4) = 2, premium = 4.
        p = mod.QoSPlane(max_slots=4, deadline_ms=50, queue_max=0)
        assert p.acquire("best-effort")[0] == "ok"
        assert p.acquire("best-effort")[0] == "ok"
        assert p.acquire("best-effort")[0] == "shed-queue"
        assert p.acquire("premium")[0] == "ok"
        assert p.acquire("premium")[0] == "ok"
        s = p.stats()
        assert s["classes"]["best-effort"]["shed"] == 1
        assert s["classes"]["premium"]["shed"] == 0

    def test_pressure_rises_then_decays(self, mod):
        p = mod.QoSPlane(max_slots=1, deadline_ms=0, queue_max=1)
        assert p.acquire()[0] == "ok"
        for _ in range(8):                       # instant sheds churn EMA
            p.acquire()
        p1 = p.pressure()
        assert p1 > 0.1
        p.release()
        time.sleep(0.5)
        assert p.pressure() < p1                 # wall-time decay

    def test_force_pressure_hook_and_bg_facade(self, mod, monkeypatch):
        monkeypatch.setenv(mod.BG_SLEEP_ENV, "5")
        p = mod.QoSPlane(max_slots=8)
        p._force_pressure(0.9)
        assert p.pressure() == pytest.approx(0.9)
        assert p.scale_workers(8, "heal") == 1   # floor(8*0.1) -> 1
        t0 = time.monotonic()
        slept = p.bg_pause("heal")
        assert slept > 0 and time.monotonic() - t0 >= slept * 0.5
        s = p.stats()
        assert s["bg_yields"] >= 2
        assert s["bg_yields_by_plane"]["heal"] == 2
        p._force_pressure(None)
        assert p.pressure() < mod.BG_THRESHOLD
        assert p.scale_workers(8, "heal") == 8   # recovered: full width
        assert p.bg_pause("heal") == 0.0

    def test_tenant_rps_bucket_refuses_then_refills(self, mod, monkeypatch):
        monkeypatch.setenv(mod.CLASSES_ENV, "standard=2:0")
        p = mod.QoSPlane(max_slots=8)
        assert p.tenant_admit("ak1", "standard")
        assert p.tenant_admit("ak1", "standard")
        assert not p.tenant_admit("ak1", "standard")   # burst of 2 spent
        assert p.stats()["tenant_throttled"] == 1
        time.sleep(0.6)                                # ~1.2 tokens back
        assert p.tenant_admit("ak1", "standard")
        assert p.tenant_admit("ak1", "premium")        # unlimited class
        assert p.tenant_admit("", "standard")

    def test_tenant_bw_post_paid_debt(self, mod, monkeypatch):
        monkeypatch.setenv(mod.CLASSES_ENV, "standard=0:1000000")
        p = mod.QoSPlane(max_slots=8)
        assert p.tenant_bw_ok("ak2", "standard")       # burst in hand
        p.charge_tenant_bw("ak2", "standard", 1_200_000)
        assert not p.tenant_bw_ok("ak2", "standard")   # repaying debt
        time.sleep(0.4)                                # ~400k refill
        assert p.tenant_bw_ok("ak2", "standard")

    def test_bucket_bw_independent_of_tenants(self, mod):
        p = mod.QoSPlane(max_slots=8)
        assert p.bucket_bw_ok("bkt", 1_000_000.0)
        p.charge_bucket_bw("bkt", 1_000_000.0, 1_500_000)
        assert not p.bucket_bw_ok("bkt", 1_000_000.0)
        assert p.stats()["bucket_throttled"] == 1
        assert p.bucket_bw_ok("other", 1_000_000.0)
        assert p.bucket_bw_ok("bkt", 0.0)

    def test_peek_access_key(self, mod):
        hdr = {"Authorization":
               "AWS4-HMAC-SHA256 Credential=AKIA123/20260807/us-east-1/"
               "s3/aws4_request, SignedHeaders=host, Signature=ab"}
        assert mod.peek_access_key(hdr) == "AKIA123"
        assert mod.peek_access_key({}) == ""
        assert mod.peek_access_key({"Authorization": "Bearer x"}) == ""

    def test_requests_max_env_and_autosize(self, mod, monkeypatch):
        monkeypatch.setenv(mod.MAX_ENV, "7")
        assert mod.default_requests_max() == 7
        monkeypatch.delenv(mod.MAX_ENV)
        cpu = os.cpu_count() or 4
        assert mod.default_requests_max(2) == 32 * cpu * 2

    def test_tenant_class_map(self, mod, monkeypatch):
        monkeypatch.setenv(mod.TENANTS_ENV,
                           "gold=premium,be=best-effort,junk=nope")
        assert mod.tenant_class("gold") == "premium"
        assert mod.tenant_class("be") == "best-effort"
        assert mod.tenant_class("junk") == "standard"
        assert mod.tenant_class("unknown") == "standard"

    def test_classes_and_ladder_knobs(self, mod, monkeypatch):
        monkeypatch.setenv(mod.CLASSES_ENV,
                           "premium=5:100,best-effort=1:,bogus=3:3,standard=x")
        assert mod.classes_config() == {"premium": (5.0, 100.0),
                                        "standard": (0.0, 0.0),
                                        "best-effort": (1.0, 0.0)}
        monkeypatch.setenv(mod.LADDER_ENV, "1,0.5,0.25")
        p = mod.QoSPlane(max_slots=8)
        assert p._limits == [8, 4, 2, 8]
        monkeypatch.setenv(mod.LADDER_ENV, "1,2,0.25")      # invalid
        assert mod.QoSPlane(max_slots=8)._limits == [8, 8, 4, 8]

    def test_disabled_oracle_facades(self, mod, monkeypatch):
        monkeypatch.setenv("MTPU_QOS", "0")
        assert mod.maybe_plane() is None
        assert mod.scale_workers(5, "heal") == 5
        assert mod.bg_pause("heal") == 0.0
        assert mod.pressure() == 0.0

    def test_the_singleton_reads_its_knobs(self, mod, monkeypatch):
        monkeypatch.setenv(mod.MAX_ENV, "3")
        monkeypatch.setenv(mod.QUEUE_ENV, "5")
        monkeypatch.setenv(mod.DEADLINE_ENV, "250")
        p = mod.get_plane()
        assert (p.max_slots, p.queue_max, p.deadline_s) == (3, 5, 0.25)
        assert mod.get_plane() is p and mod.maybe_plane() is p


class _Clock(types.SimpleNamespace):
    """A pinned clock for a module: time(), monotonic() and sleep()
    (which advances it)."""

    def __init__(self):
        super().__init__(now=1_700_000_000.0)

    def time(self):
        return self.now

    def monotonic(self):
        return self.now

    def sleep(self, s):
        self.now += s


def test_plane_sequence_matches_jax(monkeypatch):
    """One seeded sequence of acquires (every class), releases, tenant and
    bucket token-bucket calls, charges, pressure reads, background yields
    and clock steps on both packages' planes under one pinned clock: the
    same verdicts and values at every step and the same counters."""
    monkeypatch.setenv(qos.CLASSES_ENV,
                       "premium=20:2000000,standard=5:500000,"
                       "best-effort=2:100000")
    monkeypatch.setenv(qos.BG_SLEEP_ENV, "20")
    # One clock each, stepped together: a yield's sleep advances only
    # its own plane's.
    clocks = {n: _Clock() for n in MODS}
    for n, m in MODS.items():
        monkeypatch.setattr(m, "time", clocks[n])
    planes = {n: m.QoSPlane(max_slots=6, deadline_ms=100, queue_max=0)
              for n, m in MODS.items()}
    held = {n: 0 for n in MODS}
    rng = np.random.default_rng(20261018)
    classes = list(qos.CLASSES)
    for step in range(3000):
        op = int(rng.integers(9))
        klass = classes[int(rng.integers(3))]
        ak = f"ak{int(rng.integers(4))}"
        bucket = f"b{int(rng.integers(3))}"
        nbytes = int(rng.integers(1, 400_000))
        dt = float(rng.integers(0, 200)) / 1000
        got = {}
        for n, p in planes.items():
            if op == 0:
                v = p.acquire(klass)
                held[n] += v[0] == "ok"
            elif op == 1:
                v = None
                if held[n]:
                    p.release()
                    held[n] -= 1
            elif op == 2:
                v = p.tenant_admit(ak, klass)
            elif op == 3:
                v = p.tenant_bw_ok(ak, klass)
            elif op == 4:
                v = p.charge_tenant_bw(ak, klass, nbytes)
            elif op == 5:
                v = (p.bucket_bw_ok(bucket, 300_000.0),
                     p.charge_bucket_bw(bucket, 300_000.0, nbytes))
            elif op == 6:
                v = (p.pressure(), p.scale_workers(8, "heal"))
            elif op == 7:
                v = p.bg_pause("heal")
            else:
                v = None
            got[n] = v
        if op == 8:
            for c in clocks.values():
                c.sleep(dt)
        assert got["jax"] == got["port"], (step, op, got)
    assert planes["jax"].stats() == planes["port"].stats()
    assert planes["port"].stats()["shed"] > 0
    assert planes["port"].stats()["tenant_throttled"] > 0


# -- fork sharing and the slab leak -------------------------------------------

_FORK_SHARED = r"""
import json, os, signal, sys
signal.alarm(30)
mod = __import__(sys.argv[1], fromlist=["QoSPlane"])
p = mod.QoSPlane(max_slots=1, deadline_ms=50, queue_max=0)
pid = os.fork()
if pid == 0:
    v, _ = p.acquire("premium")
    os._exit(0 if v == "ok" else 1)
rc = os.waitstatus_to_exitcode(os.waitpid(pid, 0)[1])
s = p.stats()
print(json.dumps({"rc": rc, "inflight": s["inflight"],
                  "admitted": s["admitted"],
                  "premium": s["classes"]["premium"]["admitted"],
                  "parent": p.acquire()[0]}))
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    return env


def _script(code, *argv, timeout=60):
    out = subprocess.run([sys.executable, "-c", code, *argv], cwd=ROOT,
                         env=_env(), capture_output=True, text=True,
                         timeout=timeout)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("modname", ["minio_tpu.server.qos",
                                     "minio_tpu_torch.server.qos"],
                         ids=["jax", "port"])
def test_child_slot_visible_and_counted_in_parent(modname):
    """One slab on both sides of a fork: the child's slot and counters
    are the parent's, and it gates the parent (one cap, not one per
    pid)."""
    res = _script(_FORK_SHARED, modname)
    assert res == {"rc": 0, "inflight": 1, "admitted": 1, "premium": 1,
                   "parent": "shed-queue"}


_SLAB_LEAK = r"""
import json, os, signal, sys, threading, time
signal.alarm(30)
port = sys.argv[1] == "port"
mod = __import__("minio_tpu_torch.server.qos" if port
                 else "minio_tpu.server.qos", fromlist=["QoSPlane"])
kw = {"nworkers": 2} if port else {}
p = mod.QoSPlane(max_slots=4, deadline_ms=100, queue_max=0, **kw)
r, w = os.pipe()
pid = os.fork()
if pid == 0:
    if port:
        p.bind_row(1)                 # the child is worker 1
    got = [p.acquire("premium")[0] for _ in range(3)]
    os.write(w, b"x" if got == ["ok"] * 3 else b"-")
    time.sleep(60)
    os._exit(0)
ok = os.read(r, 1) == b"x"
os.kill(pid, signal.SIGKILL)
os.waitpid(pid, 0)
before = p.stats()["inflight"]
cleared = p.clear_row(1) if port else None   # as the supervisor does
go = threading.Barrier(4)
verdicts = []

def one():
    go.wait()
    verdicts.append(p.acquire("premium")[0])

ts = [threading.Thread(target=one) for _ in range(4)]
for t in ts:
    t.start()
for t in ts:
    t.join()
print(json.dumps({"child_ok": ok, "before": before, "cleared": cleared,
                  "verdicts": sorted(verdicts),
                  "inflight": p.stats()["inflight"]}))
"""


def test_dead_workers_slots_come_back(capsys):
    """A forked child (worker 1) takes 3 of 4 slots and is SIGKILLed; its
    row is cleared as the supervisor clears it when it reaps a worker.
    Four requests are then admitted at once.  The JAX plane keeps only
    pool-wide counters: played the same sequence, it still counts the
    dead child's 3 slots and sheds (printed, not asserted)."""
    port = _script(_SLAB_LEAK, "port")
    assert port["child_ok"] and port["before"] == 3, port
    assert port["cleared"] == [3, 0], port
    assert port["verdicts"] == ["ok"] * 4 and port["inflight"] == 4, port
    ref = _script(_SLAB_LEAK, "jax")
    with capsys.disabled():
        print(f"\n[qos] after a worker holding 3 of 4 slots is killed, 4 "
              f"concurrent acquires: port {port['verdicts']}; JAX plane "
              f"{ref['verdicts']} (inflight {ref['inflight']})")


# -- over HTTP, held to the JAX server ----------------------------------------

def _boot(pkg, tmp_path, tag, drives=None):
    pools = pkg.pools(tmp_path, tag)
    srv = pkg.S3Server(pools, pkg.sigv4.Credentials(ACCESS, SECRET)).start()
    return pools, srv, pkg.S3Client(srv.endpoint, ACCESS, SECRET,
                                    **pkg.client_kw)


def _retry_shed(op):
    """Warm-up requests of a 1-slot plane: the previous request's slot is
    released a beat after its response, so a zero-queue plane may shed."""
    for _ in range(100):
        st, h, body = op()
        if st != 503:
            return st, h, body
        time.sleep(0.02)
    pytest.fail("warm-up kept shedding")


def _raw(srv, method, path):
    """One unsigned keep-alive request on its own connection: (status,
    headers, body, whether the server then closed the connection)."""
    import http.client
    conn = http.client.HTTPConnection(srv.host, srv.port, timeout=TIMEOUT)
    try:
        conn.request(method, path)
        resp = conn.getresponse()
        body = resp.read()
        sock = conn.sock
        sock.settimeout(5)
        try:
            closed = sock.recv(1) == b""
        except (socket.timeout, ConnectionResetError):
            closed = False
        return resp.status, dict(resp.getheaders()), body, closed
    finally:
        conn.close()


def _signed_status(srv, path: str) -> int:
    """The status of a signed GET, read off its status line alone."""
    hdrs = {"Host": f"{srv.host}:{srv.port}"}
    hdrs.update(sign_request(Credentials(ACCESS, SECRET), "GET", path, {},
                             hdrs, b""))
    with socket.create_connection((srv.host, srv.port),
                                  timeout=TIMEOUT) as s:
        s.sendall((f"GET {path} HTTP/1.1\r\n" + "".join(
            f"{k}: {v}\r\n" for k, v in hdrs.items()) + "\r\n").encode())
        line = b""
        while not line.endswith(b"\r\n"):
            chunk = s.recv(1)
            if not chunk:
                break
            line += chunk
    return int(line.split()[1])


def _code(body: bytes) -> str:
    m = re.search(rb"<Code>([^<]*)</Code>", body)
    return m.group(1).decode() if m else ""


@pytest.fixture()
def tight(tmp_path, monkeypatch):
    """Both packages' servers behind a 1-slot, zero-queue plane."""
    monkeypatch.setenv(qos.MAX_ENV, "1")
    monkeypatch.setenv(qos.QUEUE_ENV, "0")
    monkeypatch.setenv(qos.DEADLINE_ENV, "100")
    out = {}
    for pkg in (JAX, PORT):
        pools, srv, cli = _boot(pkg, tmp_path, pkg.name)
        _retry_shed(lambda: cli.request("PUT", "/bkt"))
        # The bucket PUT's slot first, so the warm-up sheds nothing the
        # tests' exact shed counts would see.
        settle(srv.qos)
        _retry_shed(lambda: cli.request("PUT", "/bkt/o",
                                        body=payload(4096, seed=1)))
        settle(srv.qos)
        out[pkg.name] = (pools, srv, cli)
    yield out
    for pools, srv, _ in out.values():
        srv.shutdown()
        close_pools(pools)


class TestShedConformance:
    def test_shed_is_503_slowdown_with_retry_after(self, tight):
        """The shed answer of both servers: 503, the SlowDown code and
        message, Retry-After: 1, the connection closed; a signed request
        of a premium tenant is shed the same way when the slot is
        held."""
        got = {}
        for name, (_, srv, cli) in tight.items():
            assert srv.qos.acquire()[0] == "ok"      # hold THE slot
            try:
                st, h, body, closed = _raw(srv, "GET", "/bkt/o")
                st2, h2, body2 = cli.request("GET", "/bkt/o")
            finally:
                srv.qos.release()
            msg = re.search(rb"<Message>([^<]*)</Message>", body).group(1)
            got[name] = (st, _code(body), msg, h.get("Retry-After"),
                         closed, st2, _code(body2), h2.get("Retry-After"))
            assert srv.qos.stats()["shed_queue"] == 2
            assert srv.qos.stats()["classes"]["standard"]["shed"] == 2
        assert got["port"] == got["jax"]
        assert got["port"] == (503, "SlowDown", b"server is at capacity; "
                               b"request shed by admission control", "1",
                               True, 503, "SlowDown", "1")

    def test_health_admin_metrics_exempt_while_saturated(self, tight):
        """Health, admin, metrics and listen take no slot: none of them
        is shed while the only slot is held (what each then answers is
        its own plane's; only the status line is read, since a listen
        answer streams)."""
        for name, (_, srv, _) in tight.items():
            assert srv.qos.acquire()[0] == "ok"
            try:
                assert _signed_status(srv, "/minio/health/ready") == 200
                for path in ("/minio/admin/v3/info", "/minio/v2/metrics/node",
                             "/minio/listen"):
                    st = _signed_status(srv, path)
                    assert st != 503, (name, path)
            finally:
                srv.qos.release()

    def test_qos_families_in_the_metrics(self, tmp_path, monkeypatch):
        """A shed shows in the port's mtpu_qos_* families (named as the
        JAX package names them) wherever /minio/v2/metrics/node is
        served: here, a server with the hot tier attached."""
        from minio_tpu_torch.engine.hotcache import (HotObjectCache,
                                                     attach_pools)
        monkeypatch.setenv(qos.MAX_ENV, "1")
        monkeypatch.setenv(qos.QUEUE_ENV, "0")
        pools, srv, cli = _boot(PORT, tmp_path, "m")
        attach_pools(pools, HotObjectCache(total_bytes=8 << 20))
        try:
            _retry_shed(lambda: cli.request("PUT", "/mb"))
            settle(srv.qos)
            assert srv.qos.acquire()[0] == "ok"
            try:
                assert cli.request("GET", "/mb")[0] == 503
            finally:
                srv.qos.release()
            st, _, text = cli.request("GET", "/minio/v2/metrics/node")
            assert st == 200
            text = text.decode()
            for fam in ("mtpu_qos_requests_inflight", "mtpu_qos_queue_depth",
                        "mtpu_qos_pressure", "mtpu_qos_admitted_total",
                        "mtpu_qos_queue_wait_seconds_total",
                        "mtpu_qos_tenant_throttled_total",
                        "mtpu_qos_bucket_throttled_total",
                        "mtpu_qos_bg_yields_total"):
                assert f"# TYPE {fam} gauge" in text, fam
            assert 'mtpu_qos_shed_reason_total{reason="queue"} 1' in text
            assert 'mtpu_qos_shed_total{tenant_class="standard"} 1' in text
            assert 'mtpu_qos_requests_inflight 0' in text
        finally:
            srv.shutdown()
            close_pools(pools)

    def test_acked_writes_durable_under_contention(self, tmp_path,
                                                   monkeypatch):
        """Admission serializes 4 writers through one slot; every PUT that
        was acknowledged reads back byte-identical."""
        monkeypatch.setenv(qos.MAX_ENV, "1")
        monkeypatch.setenv(qos.QUEUE_ENV, "8")
        monkeypatch.setenv(qos.DEADLINE_ENV, "10000")
        pools, srv, cli = _boot(PORT, tmp_path, "dur")
        try:
            cli.make_bucket("durb")
            bodies = {f"o{i}": payload(200_000, seed=40 + i)
                      for i in range(4)}
            errs = []

            def put(name):
                try:
                    c = S3Client(srv.endpoint, ACCESS, SECRET,
                                 timeout=TIMEOUT)
                    c.put_object("durb", name, bodies[name])
                except Exception as e:  # noqa: BLE001 — the test reads it
                    errs.append(e)

            ts = [threading.Thread(target=put, args=(n,), daemon=True)
                  for n in bodies]
            for t in ts:
                t.start()
            for t in ts:
                t.join(60)
            assert not any(t.is_alive() for t in ts)
            assert not errs
            for name, body in bodies.items():
                assert cli.get_object("durb", name) == body
            settle(srv.qos)
            assert srv.qos.stats()["admitted"] >= 9
        finally:
            srv.shutdown()
            close_pools(pools)


class TestThrottles:
    def test_tenant_rps_throttle_503(self, tmp_path, monkeypatch):
        """A tenant class's req/s bucket refuses with 503 SlowDown and
        Retry-After: 1 on both servers."""
        got = {}
        for pkg in (JAX, PORT):
            pools, srv, cli = _boot(pkg, tmp_path, pkg.name)
            try:
                cli.make_bucket("tnt")
                cli.put_object("tnt", "o", b"x" * 1024)
                monkeypatch.setenv(qos.CLASSES_ENV, "standard=1:0")
                sts = [cli.request("GET", "/tnt/o") for _ in range(4)]
                shed = [(s, _code(b), h.get("Retry-After"))
                        for s, h, b in sts if s == 503]
                assert shed, pkg.name
                assert srv.qos.stats()["tenant_throttled"] >= 1
                got[pkg.name] = shed[0]
            finally:
                monkeypatch.delenv(qos.CLASSES_ENV)
                srv.shutdown()
                close_pools(pools)
        assert got["port"] == got["jax"] == (503, "SlowDown", "1")

    def test_bucket_bandwidth_throttle_503(self, tmp_path):
        """?quota's bandwidth field: refused when negative; once set, the
        first GET spends the burst (post-paid) and the next is throttled,
        on both servers alike."""
        got = {}
        for pkg in (JAX, PORT):
            pools, srv, cli = _boot(pkg, tmp_path, pkg.name)
            try:
                cli.make_bucket("bwb")
                cli.put_object("bwb", "o", payload(100_000, seed=7))
                bad = json.dumps({"quota": 0, "bandwidth": -5}).encode()
                st0, _, b0 = cli.request("PUT", "/bwb", query={"quota": ""},
                                         body=bad)
                cfg = json.dumps({"quota": 0, "quotatype": "hard",
                                  "bandwidth": 1000}).encode()
                cli._check(*cli.request("PUT", "/bwb",
                                        query={"quota": ""}, body=cfg))
                srv._qos_bw_cache.clear()   # drop the pre-config 0-rate
                # Where the rate cache had expired, the config PUT's own
                # bytes were charged (post-paid): 0.2 s repays them.
                time.sleep(0.2)
                st1, _, body1 = cli.request("GET", "/bwb/o")
                st2, h2, body2 = cli.request("GET", "/bwb/o")
                got[pkg.name] = (st0, _code(b0), st1, len(body1), st2,
                                 _code(body2), h2.get("Retry-After"))
                assert srv.qos.stats()["bucket_throttled"] >= 1
            finally:
                srv.shutdown()
                close_pools(pools)
        assert got["port"] == got["jax"] == (400, "InvalidArgument", 200,
                                             100_000, 503, "SlowDown", "1")

    def test_qos_off_oracle_byte_identity(self, tmp_path, monkeypatch):
        """MTPU_QOS=0 and the (unsaturated) QoS build serve byte-identical
        responses — same status, body, header names — and the port's
        answers equal the JAX server's under MTPU_QOS=0."""
        body = payload(65_536, seed=3)

        def exchange(pkg, tag, flag):
            monkeypatch.setenv("MTPU_QOS", flag)
            pkg_qos = MODS[pkg.name]
            pkg_qos.reset_for_tests()
            pools, srv, cli = _boot(pkg, tmp_path, tag)
            try:
                cli.make_bucket("orb")
                stp, hp, _ = cli.request("PUT", "/orb/o", body=body)
                stg, hg, got = cli.request("GET", "/orb/o")
                return (stp, sorted(k.lower() for k in hp), hp.get("ETag"),
                        stg, sorted(k.lower() for k in hg), hg.get("ETag"),
                        hg.get("Content-Length"), got)
            finally:
                srv.shutdown()
                close_pools(pools)

        on = exchange(PORT, "on", "1")
        off = exchange(PORT, "off", "0")
        assert on == off
        ref = exchange(JAX, "ref", "0")
        # The JAX server adds headers of planes the port has no part of
        # (audit and tracing ids); every response header the port sends
        # the JAX server sends too, and the rest is equal.
        assert set(off[1]) <= set(ref[1]) and set(off[4]) <= set(ref[4])
        assert (off[0], off[2], off[3], off[5], off[6], off[7]) == \
            (ref[0], ref[2], ref[3], ref[5], ref[6], ref[7])


def _quota_script(cli):
    """?quota config and its hard limit: the (status, code, body) of each
    request."""
    out = []

    def do(method, path, query=None, body=b""):
        st, _, data = cli.request(method, path, query=query, body=body)
        out.append((method, path, sorted(query or {}), st, _code(data),
                    data if query and "quota" in query and st == 200
                    else b""))
        return st, data

    do("PUT", "/qbk")
    do("GET", "/qbk", {"quota": ""})                       # none yet: 404
    do("PUT", "/qbk", {"quota": ""}, b'{"quota": -1}')     # InvalidArgument
    do("PUT", "/qbk", {"quota": ""}, b"not json")          # MalformedXML
    do("PUT", "/qbk", {"quota": ""},
       b'{"quota": 10000, "quotatype": "hard"}')
    do("GET", "/qbk", {"quota": ""})
    do("PUT", "/qbk/a", body=b"a" * 6000)
    do("PUT", "/qbk/b", body=b"b" * 6000)                  # QuotaExceeded
    do("GET", "/qbk/b")
    # multipart: a complete that stays under the limit, then one over it
    for key, n in (("m1", 3000), ("m2", 3000)):
        st, data = do("POST", f"/qbk/{key}", {"uploads": ""})
        uid = re.search(rb"<UploadId>([^<]*)</UploadId>", data).group(1)
        uid = uid.decode()
        do("PUT", f"/qbk/{key}", {"partNumber": "1", "uploadId": uid},
           b"p" * n)
        xml = ("<CompleteMultipartUpload><Part><PartNumber>1</PartNumber>"
               f"<ETag>{hashlib.md5(b'p' * n).hexdigest()}</ETag></Part>"
               "</CompleteMultipartUpload>").encode()
        do("POST", f"/qbk/{key}", {"uploadId": uid}, xml)
    do("DELETE", "/qbk", {"quota": ""})
    do("GET", "/qbk", {"quota": ""})
    do("PUT", "/qbk/c", body=b"c" * 6000)                  # no quota now
    return out


def test_quota_hard_limit_matches_jax(tmp_path):
    """?quota PUT, GET and DELETE with the JAX package's validation, the
    hard limit enforced at PUT and at multipart complete: the port's
    answers equal the JAX server's request for request."""
    got = {}
    for pkg in (JAX, PORT):
        pools, srv, cli = _boot(pkg, tmp_path, pkg.name)
        try:
            got[pkg.name] = _quota_script(cli)
        finally:
            srv.shutdown()
            close_pools(pools)
    assert got["port"] == got["jax"]
    codes = [r[4] for r in got["port"]]
    assert codes.count("QuotaExceeded") == 2
    assert "InvalidArgument" in codes and "MalformedXML" in codes


# -- heal's yield -------------------------------------------------------------

class TestBackgroundYield:
    def test_heal_workers_shrink_and_recover(self):
        from minio_tpu_torch.engine.heal import _heal_workers
        p = qos.get_plane()
        p._force_pressure(0.95)
        try:
            assert _heal_workers(8) == 1
            assert p.stats()["bg_yields_by_plane"]["heal"] >= 1
        finally:
            p._force_pressure(None)
        assert _heal_workers(8) == 8            # pressure cleared

    def test_bucket_heal_pauses_between_objects(self, tmp_path,
                                                monkeypatch):
        """heal_bucket_objects yields once per object under pressure and
        never on a quiet plane; what it heals is the same."""
        from minio_tpu_torch.engine import heal
        from test_torch_nslock import make_set
        monkeypatch.setenv(qos.BG_SLEEP_ENV, "1")
        es = make_set(tmp_path)
        try:
            es.make_bucket("hb")
            for i in range(3):
                es.put_object("hb", f"o{i}", payload(2048, seed=i))
            p = qos.get_plane()
            p._force_pressure(0.9)
            try:
                res = heal.heal_bucket_objects(es, "hb", workers=4)
                assert p.stats()["bg_yields_by_plane"]["heal"] >= 3 + 1
            finally:
                p._force_pressure(None)
            before = p.stats()["bg_yields"]
            again = heal.heal_bucket_objects(es, "hb", workers=4)
            assert p.stats()["bg_yields"] == before
            assert len(res) == len(again) == 3
        finally:
            es.close()


# -- drain, shed and a chaos storm composed -----------------------------------

def test_drain_shed_and_storm_compose(tmp_path, monkeypatch):
    from minio_tpu_torch.engine.pools import ServerPools
    from minio_tpu_torch.engine.sets import ErasureSets
    from minio_tpu_torch.server.server import S3Server
    from minio_tpu_torch.storage.chaos import ChaosDrive
    monkeypatch.setenv(qos.MAX_ENV, "1")
    monkeypatch.setenv(qos.QUEUE_ENV, "0")
    monkeypatch.setenv(qos.DEADLINE_ENV, "100")
    drives = [ChaosDrive(str(tmp_path / f"cd{i}"), seed=31 + i)
              for i in range(4)]
    pools = ServerPools([ErasureSets(drives, set_drive_count=4,
                                     device="cpu")])
    srv = S3Server(pools, Credentials(ACCESS, SECRET)).start()
    cli = S3Client(srv.endpoint, ACCESS, SECRET, timeout=TIMEOUT)
    try:
        _retry_shed(lambda: cli.request("PUT", "/chb"))
        body = payload(150_000, seed=5)
        _retry_shed(lambda: cli.request("PUT", "/chb/o", body=body))
        settle(srv.qos)
        for d in drives:
            d.error_rate = d.slow_rate = 0.05
            d.torn_rate = 0.04
        # 1) admission shed under the storm: SlowDown, not 500
        assert srv.qos.acquire()[0] == "ok"
        st, _, rb = cli.request("GET", "/chb/o")
        assert st == 503 and b"SlowDown" in rb
        # 2) drain outranks admission: the drain gate answers first
        srv.draining = True
        st, _, rb = cli.request("GET", "/chb/o")
        assert st == 503 and b"ServiceUnavailable" in rb
        srv.draining = False
        srv.qos.release()
        # 3) the gates clear: the acknowledged bytes come back exact
        got = None
        for _ in range(10):
            st, _, rb = cli.request("GET", "/chb/o")
            if st == 200:
                got = rb
                break
            time.sleep(0.05)
        assert got == body
    finally:
        srv.shutdown()
        for d in drives:
            d.chaos_off()
        close_pools(pools)


# -- one pool, one cap --------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _metrics(port) -> dict:
    import urllib.request
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/minio/v2/metrics/node",
            timeout=5) as r:
        text = r.read().decode()
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


def test_stalled_reader_saturates_every_worker_until_its_worker_dies(
        tmp_path):
    """MTPU_WORKERS=2 with MTPU_REQUESTS_MAX=1: a stalled reader holding
    the only slot sheds probes on BOTH workers (the cap is the pool's).
    Then the worker holding it, found from the per-worker rows, is
    SIGKILLed: the supervisor gives its slot back when it reaps it, the
    pool's inflight is 0 again and requests are admitted."""
    root = tmp_path / "pool"
    root.mkdir()
    port = _free_port()
    env = _env()
    env.update(MTPU_ROOT_USER="pooladmin",
               MTPU_ROOT_PASSWORD="pooladmin-secret", MTPU_WORKERS="2",
               MTPU_REQUESTS_MAX="1", MTPU_QOS_QUEUE="0",
               MTPU_REQUESTS_DEADLINE_MS="100", MTPU_RESPAWN_DELAY_S="0.2")
    with open(root / "pool.log", "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "minio_tpu_torch.server", "--device",
             "cpu", "--drives", str(root / "d{1...4}"), "--port",
             str(port)], cwd=str(root), env=env, stdout=log,
            stderr=subprocess.STDOUT)
    stalled = None
    try:
        _wait(lambda: all(_metrics(port).get(
            f'mtpu_worker_ready{{worker="{w}"}}') == 1 for w in (0, 1)),
            "both workers", timeout=90, proc=proc)
        cli = S3Client(f"http://127.0.0.1:{port}", "pooladmin",
                       "pooladmin-secret", timeout=60)
        _retry_shed(lambda: cli.request("PUT", "/qpb"))
        big = payload(32 << 20, seed=9)
        _retry_shed(lambda: cli.request("PUT", "/qpb/big", body=big))

        def stall_get():
            s = socket.socket()
            s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4096)
            s.connect(("127.0.0.1", port))
            hdrs = {"Host": f"127.0.0.1:{port}"}
            hdrs.update(sign_request(
                Credentials("pooladmin", "pooladmin-secret"),
                "GET", "/qpb/big", {}, hdrs, b""))
            s.sendall(("GET /qpb/big HTTP/1.1\r\n" + "".join(
                f"{k}: {v}\r\n" for k, v in hdrs.items())
                + "\r\n").encode())
            line = s.recv(64)
            if line.startswith(b"HTTP/1.1 200"):
                return s
            s.close()
            assert b" 503 " in line, line
            return None

        deadline = time.monotonic() + 30
        while (stalled := stall_get()) is None:
            assert time.monotonic() < deadline, "GET kept shedding"
            time.sleep(0.1)
        time.sleep(0.3)                         # let the send block
        sheds = 0
        for _ in range(6):
            st, _, rb = cli.request("GET", "/qpb/big")
            sheds += st == 503 and b"SlowDown" in rb
        assert sheds == 6, f"only {sheds}/6 probes shed"
        m = _metrics(port)
        assert m["mtpu_qos_requests_inflight"] == 1
        rows = {w: m[f'mtpu_qos_worker_inflight{{worker="{w}"}}']
                for w in (0, 1)}
        (holder,) = [w for w, v in rows.items() if v == 1]
        pid = int(m[f'mtpu_worker_pid{{worker="{holder}"}}'])
        os.kill(pid, signal.SIGKILL)
        _wait(lambda: (_metrics(port).get(
            f'mtpu_worker_respawns_total{{worker="{holder}"}}') == 1
            and _metrics(port).get(
                f'mtpu_worker_ready{{worker="{holder}"}}') == 1),
            "the respawn", timeout=90, proc=proc)
        m = _metrics(port)
        assert m["mtpu_qos_requests_inflight"] == 0
        assert m[f'mtpu_qos_worker_inflight{{worker="{holder}"}}'] == 0
        st, _, rb = _retry_shed(lambda: cli.request("GET", "/qpb/big"))
        assert st == 200 and rb == big
        assert "died holding 1 admission slots" in (root / "pool.log") \
            .read_text()
    finally:
        if stalled is not None:
            stalled.close()
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10)
