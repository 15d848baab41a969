"""The port's zero-copy sends (minio_tpu_torch/ops/zerocopy.py, the
engine's `sendfile_plan` and the server's zero-copy writer), held to the
JAX package (device="cpu").  Tolerance: byte-exact.

- send_gather across IOV_MAX and over mixed buffers (bytes, memoryview,
  numpy), and the disconnect mapping, in both packages;
- send_file over runs and its pread fallback when the kernel refuses;
- sendfile_plan: its gates (ranged, missing, inline, k > 1, degraded,
  hot-cacheable while the tier is on, zero-copy off), a size or frame
  corruption found through the plan's own fd, the verify's device items,
  and the same runs and bytes as the JAX package's plan;
- HTTP responses byte for byte the same on the wire under
  MTPU_ZEROCOPY=1 and =0 (Date and request id masked), for both
  packages' servers over a k=1 set with a hot tier;
- a client that resets its connection mid-body leaves no traceback and
  the server serves on.
"""

import errno
import os
import re
import socket
import struct
import threading
import time

import numpy as np
import pytest

import minio_tpu.engine.hotcache as jax_hc
import minio_tpu.ops.zerocopy as jax_zc
import minio_tpu.server.server as jax_server
import minio_tpu.server.sigv4 as jax_sigv4
import minio_tpu_torch.engine.hotcache as hc
import minio_tpu_torch.ops.zerocopy as zc
import minio_tpu_torch.server.server as port_server
import minio_tpu_torch.server.sigv4 as port_sigv4
from minio_tpu.engine.erasure_set import ErasureSet as JaxErasureSet
from minio_tpu.engine.pools import ServerPools as JaxServerPools
from minio_tpu.engine.sets import ErasureSets as JaxErasureSets
from minio_tpu.storage.drive import LocalDrive as JaxLocalDrive
from minio_tpu_torch.engine.erasure_set import ErasureSet
from minio_tpu_torch.engine.pools import ServerPools
from minio_tpu_torch.engine.sets import ErasureSets
from minio_tpu_torch.ops import coalesce, devcache, fused
from minio_tpu_torch.server.client import S3Client
from minio_tpu_torch.storage.drive import LocalDrive

MIB = 1 << 20
ACCESS, SECRET = "zcopyroot", "zcopyroot-secret-key1"


def payload(size, seed=0):
    return np.random.default_rng(seed).integers(0, 256, size,
                                                dtype=np.uint8).tobytes()


@pytest.fixture(autouse=True)
def quiet_planes(monkeypatch):
    monkeypatch.setenv("MTPU_HEDGE", "0")
    monkeypatch.delenv("MTPU_HOTCACHE", raising=False)
    monkeypatch.delenv("MTPU_ZEROCOPY", raising=False)
    coalesce.reset()
    devcache.reset()
    yield
    coalesce.reset()
    devcache.reset()


@pytest.fixture(params=["jax", "port"])
def zmod(request):
    return jax_zc if request.param == "jax" else zc


def _drain(sock, want: int, got: bytearray) -> threading.Thread:
    def run():
        while len(got) < want:
            chunk = sock.recv(1 << 16)
            if not chunk:
                break
            got.extend(chunk)
    t = threading.Thread(target=run)
    t.start()
    return t


# -- transport ----------------------------------------------------------------

class TestSendGather:
    def test_many_segments_cross_iov_max(self, zmod):
        a, b = socket.socketpair()
        try:
            segs = [bytes([i % 256]) * 17 for i in range(zmod.IOV_MAX + 40)]
            want = b"".join(segs)
            got = bytearray()
            t = _drain(b, len(want), got)
            n = zmod.send_gather(a, segs)
            t.join(10)
            assert n == len(want) and bytes(got) == want
        finally:
            a.close()
            b.close()

    def test_mixed_buffers_and_partial_sends(self, zmod):
        a, b = socket.socketpair()
        a.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 4096)
        try:
            arr = np.frombuffer(payload(300_000, seed=1), dtype=np.uint8)
            segs = [b"bytes-part", memoryview(b"view-part"), arr, b"",
                    arr[7:70_000], bytearray(b"tail")]
            want = b"".join(bytes(s) for s in segs)
            got = bytearray()
            t = _drain(b, len(want), got)
            n = zmod.send_gather(a, segs)
            t.join(10)
            assert n == len(want) and bytes(got) == want
        finally:
            a.close()
            b.close()

    def test_disconnect_maps_to_broken_pipe(self, zmod):
        a, b = socket.socketpair()
        b.close()
        try:
            with pytest.raises((BrokenPipeError, ConnectionResetError)):
                for _ in range(64):
                    zmod.send_gather(a, [b"x" * 65536])
        finally:
            a.close()

    def test_map_disconnect_errnos(self, zmod):
        with pytest.raises(BrokenPipeError):
            zmod._map_disconnect(OSError(errno.EPIPE, "epipe"))
        with pytest.raises(BrokenPipeError):
            zmod._map_disconnect(OSError(errno.ESHUTDOWN, "shutdown"))
        with pytest.raises(ConnectionResetError):
            zmod._map_disconnect(OSError(errno.ECONNRESET, "reset"))
        with pytest.raises(OSError) as ei:
            zmod._map_disconnect(OSError(errno.EIO, "io"))
        assert ei.value.errno == errno.EIO


class TestSendFile:
    def _plan(self, zmod, tmp_path):
        p = tmp_path / "f"
        body = payload(100_000, seed=3)
        p.write_bytes(b"HDR!" + body[:50_000] + b"MID!" + body[50_000:])
        fd = os.open(p, os.O_RDONLY)
        return zmod.FilePlan(fd, [(4, 50_000), (50_008, 50_000)],
                             100_000), body

    @pytest.mark.parametrize("refused", [False, True],
                             ids=["sendfile", "pread"])
    def test_runs(self, zmod, tmp_path, monkeypatch, refused):
        plan, body = self._plan(zmod, tmp_path)
        assert plan.read_all() == body
        if refused:
            def refuse(*a):
                raise OSError(errno.EINVAL, "refused")
            monkeypatch.setattr(os, "sendfile", refuse)
        a, b = socket.socketpair()
        try:
            got = bytearray()
            t = _drain(b, len(body), got)
            n = zmod.send_file(a, plan.fd, plan.runs)
            t.join(10)
            assert n == len(body) and bytes(got) == body
        finally:
            a.close()
            b.close()
            plan.close()
        assert plan.fd == -1
        plan.close()                          # idempotent

    def test_disconnect_mid_file(self, zmod, tmp_path):
        plan, _ = self._plan(zmod, tmp_path)
        a, b = socket.socketpair()
        b.close()
        try:
            with pytest.raises((BrokenPipeError, ConnectionResetError)):
                zmod.send_file(a, plan.fd, plan.runs * 64)
        finally:
            a.close()
            plan.close()


# -- sendfile_plan ------------------------------------------------------------

@pytest.fixture
def make_set(tmp_path):
    made = []

    def make(n=2, parity=1, name="k1", tier=False, pkg="port"):
        if pkg == "port":
            es = ErasureSet([LocalDrive(str(tmp_path / name / f"d{i}"))
                             for i in range(n)], default_parity=parity,
                            device="cpu")
        else:
            es = JaxErasureSet([JaxLocalDrive(str(tmp_path / name / f"d{i}"))
                                for i in range(n)], parity)
        made.append(es)
        if tier:
            (hc if pkg == "port" else jax_hc).attach_sets(
                es, (hc if pkg == "port" else jax_hc).HotObjectCache(
                    total_bytes=16 * MIB))
        return es
    yield make
    for es in made:
        if isinstance(es, ErasureSet):
            es.close()
        else:
            es.pool.shutdown(wait=True)
            es._iter_pool.shutdown(wait=True)


def _plan_bytes(got) -> bytes:
    fi, plans = got
    try:
        assert sum(p.nbytes for p in plans) == fi.size
        return b"".join(p.read_all() for p in plans)
    finally:
        for p in plans:
            p.close()


class TestDriveViews:
    """LocalDrive.read_file_view and open_read_fd, held to the JAX
    drive's: the same bytes, short views past EOF, the same errors."""

    @pytest.mark.parametrize("offset,length", [
        (0, -1), (5, 100), (4096, 8192), (MIB - 3, 100), (MIB + 10, 5),
        (7, 0)])
    def test_view_matches_jax_and_read_file(self, tmp_path, offset, length):
        body = payload(MIB, seed=3)
        d = LocalDrive(str(tmp_path / "d"))
        d.make_volume("b")
        d.write_all("b", "o/part.1", body)
        jd = JaxLocalDrive(d.root)
        view = d.read_file_view("b", "o/part.1", offset, length)
        assert isinstance(view, memoryview)
        want = body[offset:] if length < 0 else body[offset:offset + length]
        assert bytes(view) == want
        assert bytes(view) == d.read_file("b", "o/part.1", offset, length)
        assert bytes(view) == bytes(jd.read_file_view("b", "o/part.1",
                                                       offset, length))

    def test_errors_and_fd_match_jax(self, tmp_path):
        d = LocalDrive(str(tmp_path / "d"))
        d.make_volume("b")
        d.write_all("b", "dir/o", b"abc")
        jd = JaxLocalDrive(d.root)
        for fn in ("read_file_view", "open_read_fd"):
            with pytest.raises(Exception) as port_err:
                getattr(d, fn)("b", "nope")
            with pytest.raises(Exception) as jax_err:
                getattr(jd, fn)("b", "nope")
            assert type(port_err.value).__name__ == \
                type(jax_err.value).__name__ == "ErrFileNotFound"
        # A directory is read_file's ErrIsNotRegular (the JAX drive's
        # view lets mmap's ENODEV out as a bare OSError).
        with pytest.raises(Exception) as port_err:
            d.read_file("b", "dir")
        with pytest.raises(type(port_err.value)):
            d.read_file_view("b", "dir")
        fd = d.open_read_fd("b", "dir/o")
        try:
            assert os.pread(fd, 10, 0) == b"abc"
        finally:
            os.close(fd)


class TestSendfilePlan:
    @pytest.mark.parametrize("algo", ["mxh256", "highwayhash256S"])
    def test_plan_verifies_on_the_device_and_matches_jax(
            self, make_set, monkeypatch, algo):
        monkeypatch.setenv("MTPU_BITROT_ALGO", algo)
        es = make_set()
        es.make_bucket("b")
        size = 2 * MIB + 77 if algo == "mxh256" else 200_000 + 3
        body = payload(size, seed=9)
        es.put_object("b", "big", body)
        item = "mxh256" if algo == "mxh256" else "hh256"
        items0 = dict(fused.ITEMS)
        got = es.sendfile_plan("b", "big")
        assert got is not None
        # One verify per frame batch: the full frames, then the tail.
        full = size // MIB
        want = -(-full // es_mod_batch()) + (1 if size % MIB else 0)
        assert fused.ITEMS[item] - items0[item] == want
        runs = [p.runs for p in got[1]]
        assert _plan_bytes(got) == body
        jes = JaxErasureSet([JaxLocalDrive(d.root) for d in es.drives], 1)
        try:
            jgot = jes.sendfile_plan("b", "big")
            assert [p.runs for p in jgot[1]] == runs
            assert _plan_bytes(jgot) == body
        finally:
            jes.pool.shutdown(wait=True)
            jes._iter_pool.shutdown(wait=True)

    def test_gates(self, make_set, monkeypatch):
        es = make_set(tier=True)
        es.make_bucket("b")
        big = payload(5 * MIB, seed=9)            # over the tier's 4 MiB
        mid = payload(600_000, seed=8)            # hot-cacheable
        es.put_object("b", "big", big)
        es.put_object("b", "mid", mid)
        es.put_object("b", "small", b"tiny")
        assert _plan_bytes(es.sendfile_plan("b", "big")) == big
        assert es.sendfile_plan("b", "big", 5, 100) is None      # ranged
        assert es.sendfile_plan("b", "nope") is None             # missing
        assert es.sendfile_plan("b", "small") is None            # inline
        assert es.sendfile_plan("b", "mid") is None              # the tier's
        monkeypatch.setenv("MTPU_HOTCACHE", "0")
        assert _plan_bytes(es.sendfile_plan("b", "mid")) == mid
        monkeypatch.setenv("MTPU_ZEROCOPY", "0")
        assert es.sendfile_plan("b", "big") is None              # oracle
        monkeypatch.delenv("MTPU_ZEROCOPY")
        es.drives[1] = None
        assert es.sendfile_plan("b", "big") is None              # degraded
        k2 = make_set(n=4, parity=2, name="k2")
        k2.make_bucket("b")
        k2.put_object("b", "o", payload(MIB, seed=1))
        assert k2.sendfile_plan("b", "o") is None                # k > 1

    def test_a_key_the_tier_holds_is_declined_before_the_election(
            self, make_set, monkeypatch):
        es = make_set(tier=True)
        tier = es.hot_tier
        es.make_bucket("b")
        mid = payload(600_000, seed=8)
        es.put_object("b", "mid", mid)
        for _ in range(2):                        # two-hit admission
            assert es.get_object("b", "mid")[1] == mid
        assert tier.stats()["fills"] == 1
        assert tier.holds("b", "mid", "") and not tier.holds("b", "x", "")
        elections = []
        real = es._read_metadata

        def counted(*a, **kw):
            elections.append(a)
            return real(*a, **kw)
        monkeypatch.setattr(es, "_read_metadata", counted)
        es._fi_cache.clear()                      # as after the TTL
        stats0 = tier.stats()
        assert es.sendfile_plan("b", "mid") is None
        assert elections == []
        assert tier.stats() == stats0             # holds counts nothing
        es.put_object("b", "mid", mid[::-1])      # bumps the generation
        assert not tier.holds("b", "mid", "")
        assert es.sendfile_plan("b", "mid") is None     # cacheable
        assert len(elections) == 1

    @pytest.mark.parametrize("fault", ["frame", "size"])
    def test_corruption_found_through_the_fd(self, make_set, fault):
        es = make_set()
        es.make_bucket("b")
        body = payload(MIB + 5, seed=4)
        es.put_object("b", "o", body)
        assert _plan_bytes(es.sendfile_plan("b", "o")) == body
        for d in es.drives:
            for dirpath, _, files in os.walk(os.path.join(d.root, "b")):
                for f in files:
                    if f.startswith("part."):
                        fp = os.path.join(dirpath, f)
                        raw = bytearray(open(fp, "rb").read())
                        if fault == "frame":
                            raw[len(raw) // 2] ^= 0xFF
                        else:
                            raw = raw[:-1]
                        open(fp, "wb").write(bytes(raw))
        assert es.sendfile_plan("b", "o") is None
        # The normal read still answers (rebuilt, or an error).
        try:
            es.get_object("b", "o")
        except Exception as e:  # noqa: BLE001 — both shards corrupt
            assert type(e).__name__ == "ErrErasureReadQuorum"


def es_mod_batch() -> int:
    from minio_tpu_torch.engine.heal import HEAL_BATCH_BLOCKS
    return HEAL_BATCH_BLOCKS


# -- the wire -----------------------------------------------------------------

def _jax_srv(root):
    drives = [JaxLocalDrive(str(root / f"d{i}")) for i in range(2)]
    pools = JaxServerPools([JaxErasureSets(drives, set_drive_count=2)])
    jax_hc.attach_pools(pools, jax_hc.HotObjectCache(total_bytes=16 * MIB))
    srv = jax_server.S3Server(pools, jax_sigv4.Credentials(ACCESS, SECRET))
    return srv, pools, jax_sigv4


def _port_srv(root):
    drives = [LocalDrive(str(root / f"d{i}")) for i in range(2)]
    pools = ServerPools([ErasureSets(drives, set_drive_count=2,
                                     device="cpu")])
    hc.attach_pools(pools, hc.HotObjectCache(total_bytes=16 * MIB))
    srv = port_server.S3Server(pools, port_sigv4.Credentials(ACCESS,
                                                             SECRET))
    return srv, pools, port_sigv4


@pytest.fixture(params=["jax", "port"])
def zsrv(request, tmp_path):
    srv, pools, sigv4 = (_jax_srv if request.param == "jax"
                         else _port_srv)(tmp_path)
    srv.start()
    srv.sigv4 = sigv4
    yield srv
    srv.shutdown()
    for p in pools.pools:
        for es in p.sets:
            if isinstance(es, ErasureSet):
                es.close()
            else:
                es.pool.shutdown(wait=True)
                es._iter_pool.shutdown(wait=True)


_MASK = re.compile(rb"(?im)^(date|x-amz-request-id): [^\r]*\r\n")


def _raw(srv, method, path, headers=()) -> bytes:
    """One presigned request over a fresh socket, the raw response with
    the Date and request id lines masked."""
    url = srv.sigv4.presign_url(srv.sigv4.Credentials(ACCESS, SECRET),
                                method, path, {}, f"{srv.host}:{srv.port}")
    extra = "".join(f"{k}: {v}\r\n" for k, v in headers)
    with socket.create_connection((srv.host, srv.port), timeout=30) as s:
        s.sendall(f"{method} {url} HTTP/1.1\r\nHost: {srv.host}:{srv.port}"
                  f"\r\n{extra}Connection: close\r\n\r\n".encode())
        out = bytearray()
        while True:
            chunk = s.recv(1 << 16)
            if not chunk:
                break
            out += chunk
    return _MASK.sub(b"", bytes(out))


def test_wire_identical_across_modes(zsrv, monkeypatch):
    """Inline, hot-cacheable and sendfile-size objects, whole, ranged,
    suffix and HEAD, cold and warm: the same bytes on the wire with
    zero-copy on and off."""
    cli = S3Client(zsrv.endpoint, ACCESS, SECRET, timeout=30)
    cli.make_bucket("bkt")
    bodies = {"small": payload(900, seed=1), "mid": payload(600_000, 2),
              "big": payload(5 * MIB + 3, seed=3)}
    for name, data in bodies.items():
        cli.put_object("bkt", name, data)
    s0 = zc.stats()
    for name, data in bodies.items():
        for hdrs in ((), (("Range", "bytes=100-4099"),),
                     (("Range", "bytes=-256"),)):
            for rep in range(3):           # cold, ghost, hit
                monkeypatch.setenv("MTPU_ZEROCOPY", "1")
                fast = _raw(zsrv, "GET", f"/bkt/{name}", hdrs)
                monkeypatch.setenv("MTPU_ZEROCOPY", "0")
                oracle = _raw(zsrv, "GET", f"/bkt/{name}", hdrs)
                assert fast == oracle, (name, hdrs, rep)
                body = fast.split(b"\r\n\r\n", 1)[1]
                want = data if not hdrs else (
                    data[100:4100] if "100" in hdrs[0][1] else data[-256:])
                assert body == want
        monkeypatch.setenv("MTPU_ZEROCOPY", "1")
        fast = _raw(zsrv, "HEAD", f"/bkt/{name}")
        monkeypatch.setenv("MTPU_ZEROCOPY", "0")
        assert fast == _raw(zsrv, "HEAD", f"/bkt/{name}")
    if isinstance(zsrv, port_server.S3Server):
        s1 = zc.stats()
        assert s1["sendfile"] - s0["sendfile"] == 3    # big, whole
        assert s1["sendmsg"] > s0["sendmsg"]
        assert s1["hot_views"] > s0["hot_views"]
        # Under =0 the engine plans no sendfile: nothing falls back.
        assert s1["fallbacks"] == s0["fallbacks"]


def test_tls_reads_the_verified_plan_through_userspace(tmp_path):
    """Over TLS the writer cannot sendfile: the verified plan is read
    through userspace, the same bytes."""
    import datetime

    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import rsa
    from cryptography.x509.oid import NameOID

    key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, "127.0.0.1")])
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (x509.CertificateBuilder().subject_name(name).issuer_name(name)
            .public_key(key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now - datetime.timedelta(minutes=1))
            .not_valid_after(now + datetime.timedelta(days=1))
            .sign(key, hashes.SHA256()))
    crt, pem = tmp_path / "public.crt", tmp_path / "private.key"
    crt.write_bytes(cert.public_bytes(serialization.Encoding.PEM))
    pem.write_bytes(key.private_bytes(
        serialization.Encoding.PEM,
        serialization.PrivateFormat.TraditionalOpenSSL,
        serialization.NoEncryption()))
    pools = ServerPools([ErasureSets(
        [LocalDrive(str(tmp_path / f"d{i}")) for i in range(2)],
        set_drive_count=2, device="cpu")])
    srv = port_server.S3Server(pools, port_sigv4.Credentials(ACCESS, SECRET),
                               certs=(str(crt), str(pem))).start()
    try:
        cli = S3Client(srv.endpoint, ACCESS, SECRET, verify_tls=False,
                       timeout=30)
        cli.make_bucket("bkt")
        big = payload(5 * MIB + 1, seed=6)
        cli.put_object("bkt", "big", big)
        s0 = zc.stats()
        assert cli.get_object("bkt", "big") == big
        s1 = zc.stats()
        assert s1["fallbacks"] - s0["fallbacks"] == 1
        assert s1["sendfile"] == s0["sendfile"]
    finally:
        srv.shutdown()
        pools.close()


def test_client_reset_mid_body_is_quiet(zsrv, capfd):
    cli = S3Client(zsrv.endpoint, ACCESS, SECRET, timeout=30)
    cli.make_bucket("bkt")
    big = payload(8 * MIB, seed=8)
    cli.put_object("bkt", "big", big)
    url = zsrv.sigv4.presign_url(zsrv.sigv4.Credentials(ACCESS, SECRET),
                                 "GET", "/bkt/big", {},
                                 f"{zsrv.host}:{zsrv.port}")
    s = socket.create_connection((zsrv.host, zsrv.port), timeout=10)
    try:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4096)
        s.sendall(f"GET {url} HTTP/1.1\r\nHost: {zsrv.host}:{zsrv.port}"
                  "\r\n\r\n".encode())
        first = s.recv(4096)
        assert b"200" in first.split(b"\r\n", 1)[0]
        s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                     struct.pack("ii", 1, 0))   # RST on close
    finally:
        s.close()
    time.sleep(0.3)
    assert cli.get_object("bkt", "big") == big
    err = capfd.readouterr().err
    assert "Traceback" not in err, err


def test_metrics_route_serves_the_tier_and_send_families(tmp_path):
    """With a tier attached, /minio/v2/metrics/node serves the tier's and
    zero-copy's families and, outside a pool, the kernels' items."""
    import http.client
    srv, pools, _ = _port_srv(tmp_path)
    srv.start()
    try:
        cli = S3Client(srv.endpoint, ACCESS, SECRET, timeout=30)
        cli.make_bucket("bkt")
        data = payload(300_000, seed=2)
        cli.put_object("bkt", "o", data)
        for _ in range(3):
            assert cli.get_object("bkt", "o") == data
        conn = http.client.HTTPConnection(srv.host, srv.port, timeout=30)
        conn.request("GET", "/minio/v2/metrics/node")
        resp = conn.getresponse()
        text = resp.read().decode()
        conn.close()
        assert resp.status == 200
        m = {ln.rsplit(" ", 1)[0]: float(ln.rsplit(" ", 1)[1])
             for ln in text.splitlines() if ln and not ln.startswith("#")}
        assert m["mtpu_hotcache_fills_total"] == 1
        assert m["mtpu_hotcache_hits_total"] == 1
        assert m["mtpu_zerocopy_hot_views_total"] >= 1
        assert m['mtpu_kernel_items_total{kernel="mxh256"}'] >= 2
    finally:
        srv.shutdown()
        pools.close()
