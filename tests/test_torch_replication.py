"""Bucket replication in the port (minio_tpu_torch/bucket/replication.py,
the server's ?replication, admin bucket-remote and replication, the proxy
GET; device="cpu") held to the JAX package.  Tolerance: exact (equal
version ids, mod times, ETags and bytes on the target; equal journal
algebra; equal status codes).

- The same seeded traffic (pinned version ids and mod times, a key with
  three versions and a delete marker) through each package's
  ReplicationPool between two ServerPools leaves the same target: every
  version under the source's id and mod time, the marker on top, the
  source COMPLETED and the target REPLICA.
- tests/test_bucket_features.py's TestReplication and
  TestReplicationDepth and tests/test_replication_fault.py's tier-1
  cases, on both packages: the journal's algebra, intent before
  runnable, boot replay, retries, the per-target breaker (FAILED, then
  COMPLETED after its probe), the proxy's 404 and 503, the journaled
  resync, and versioned fidelity between two S3Servers over loopback
  (replica under the source's id, metadata re-replication, delete
  markers, no active-active ping-pong, the proxy's 503 on the wire).
- The port alone: a death at each of the four crash points in a
  subprocess, then a replay that copies exactly once; orphaned journals
  adopted across worker ids and from a drained pool's drive; a resync
  that resumes after a stop; the journal's home off a draining pool.
- The port's repair: a copy (x-amz-copy-source) replicates like a PUT;
  the JAX package's copy is never replicated.
"""

import json
import os
import socket
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

import minio_tpu.bucket.replication as jax_repl
import minio_tpu.engine.erasure_set as jax_es_mod
import minio_tpu.server.client as jax_client
import minio_tpu.server.server as jax_server
import minio_tpu.server.sigv4 as jax_sigv4
import minio_tpu.storage.errors as jax_errors
import minio_tpu_torch.bucket.replication as port_repl
import minio_tpu_torch.engine.erasure_set as port_es_mod
import minio_tpu_torch.server.client as port_client
import minio_tpu_torch.server.server as port_server
import minio_tpu_torch.server.sigv4 as port_sigv4
import minio_tpu_torch.storage.errors as port_errors
from minio_tpu.engine.pools import ServerPools as JaxServerPools
from minio_tpu.engine.sets import ErasureSets as JaxErasureSets
from minio_tpu.storage.drive import LocalDrive as JaxLocalDrive
from minio_tpu_torch.engine.pools import ServerPools
from minio_tpu_torch.engine.sets import ErasureSets
from minio_tpu_torch.storage.drive import SYS_VOL, LocalDrive
from minio_tpu_torch.utils import crashpoints

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ADMIN, SECRET = "repladmin", "repladmin-secret"


def _jax_pools(tmp, tag, n=4):
    return JaxServerPools([JaxErasureSets(
        [JaxLocalDrive(f"{tmp}/{tag}-d{i}") for i in range(n)],
        set_drive_count=n)])


def _port_pools(tmp, tag, n=4):
    return ServerPools([ErasureSets(
        [LocalDrive(f"{tmp}/{tag}-d{i}") for i in range(n)],
        set_drive_count=n, device="cpu")])


JAX = SimpleNamespace(
    name="jax", repl=jax_repl, pools=_jax_pools, es_mod=jax_es_mod,
    errors=jax_errors, S3Server=jax_server.S3Server,
    S3Client=jax_client.S3Client, Credentials=jax_sigv4.Credentials,
    client_kw={})
PORT = SimpleNamespace(
    name="port", repl=port_repl, pools=_port_pools, es_mod=port_es_mod,
    errors=port_errors, S3Server=port_server.S3Server,
    S3Client=port_client.S3Client, Credentials=port_sigv4.Credentials,
    client_kw={"timeout": 30})


def close(pools):
    for p in pools.pools:
        for es in p.sets:
            if isinstance(es, port_es_mod.ErasureSet):
                es.close()
            else:
                es.pool.shutdown(wait=True)
                es._iter_pool.shutdown(wait=True)


@pytest.fixture(params=[JAX, PORT], ids=lambda p: p.name)
def impl(request):
    return request.param


@pytest.fixture
def made():
    """Pools and replication pools to close after the test, in order."""
    things = []
    yield things
    for kind, obj in reversed(things):
        if kind == "rp":
            obj.stop()
        elif kind == "srv":
            obj.shutdown()
        else:
            close(obj)


@pytest.fixture(autouse=True)
def quiet_scanner(monkeypatch):
    monkeypatch.setenv("MTPU_SCANNER", "0")
    monkeypatch.setenv("MTPU_REPL_JOURNAL", "1")
    monkeypatch.delenv("MTPU_WORKER_ID", raising=False)
    monkeypatch.delenv("MTPU_WORKERS_TOTAL", raising=False)


def payload(size, seed):
    return np.random.default_rng(seed).integers(
        0, 256, size, dtype=np.uint8).tobytes()


def wait_for(pred, timeout=20.0, step=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(step)
    return False


def pair(impl, tmp, made, workers=2):
    src, dst = impl.pools(tmp, "src"), impl.pools(tmp, "dst")
    made.append(("pools", src))
    made.append(("pools", dst))
    src.make_bucket("srcb")
    dst.make_bucket("dstb")
    rp = impl.repl.ReplicationPool(src, workers=workers)
    made.append(("rp", rp))
    return src, dst, rp


class FlakyTarget:
    """An in-process target that fails its first `fail_n` calls."""

    def __init__(self, pools, fail_n=0, exc=ConnectionError):
        self.pools, self.fail_n, self.exc = pools, fail_n, exc
        self.calls = 0
        self.mu = threading.Lock()

    def _gate(self):
        with self.mu:
            self.calls += 1
            if self.calls <= self.fail_n:
                raise self.exc("target dark (injected)")

    def put_object(self, bucket, key, data, metadata=None, **kw):
        self._gate()
        return self.pools.put_object(bucket, key, data, metadata=metadata,
                                     **kw)

    def delete_object(self, bucket, key, version_id="", versioned=False):
        self._gate()
        return self.pools.delete_object(bucket, key, version_id=version_id,
                                        versioned=versioned)

    def get_object(self, bucket, key):
        self._gate()
        return self.pools.get_object(bucket, key)


REPL_XML = b"""<ReplicationConfiguration><Role></Role>
 <Rule><Status>Enabled</Status><Prefix>rep/</Prefix>
  <Destination><Bucket>arn:aws:s3:::dst-bucket</Bucket></Destination>
 </Rule></ReplicationConfiguration>"""


# -- the same traffic through both packages ------------------------------------

V = "22222222-2222-4222-8222-{:012d}".format
T0 = 1_760_000_000 * 10**9


def _versions(pools, bucket, key):
    out = []
    for v in pools.list_object_versions(bucket, key):
        if v.deleted:
            out.append(("marker", v.is_latest))
        else:
            out.append((v.version_id, v.mod_time_ns, v.is_latest,
                        v.metadata.get("etag", ""),
                        v.metadata.get("x-amz-replication-status", "")))
    return out


def test_same_traffic_leaves_the_same_target(tmp_path, made, monkeypatch):
    got = {}
    for impl in (JAX, PORT):
        src, dst, rp = pair(impl, tmp_path / impl.name, made)
        rp.configure("srcb", [impl.repl.ReplicationRule("", "dstb")], dst)
        rng = np.random.default_rng(23)
        plan = [(f"obj/{i}", V(i), T0 + i * 10**9,
                 int(rng.integers(1, 300_000))) for i in range(6)]
        plan += [("hist", V(10 + i), T0 + (10 + i) * 10**9, 50_000 + i)
                 for i in range(3)]
        bodies = {}
        for key, vid, mt, size in plan:
            data = payload(size, size)
            src.put_object("srcb", key, data, versioned=True,
                           version_id=vid, mod_time_ns=mt,
                           metadata={"x-amz-meta-seed": str(size)})
            bodies[key, vid] = data
            assert rp.on_put("srcb", key, vid)
            # One key's versions one at a time: a newer intent of the
            # same key replaces a pending one (the latest state wins).
            if key == "hist":
                assert rp.wait_idle(20)
        monkeypatch.setattr(impl.es_mod, "new_uuid", lambda: V(99))
        monkeypatch.setattr(impl.es_mod, "_now_ns",
                            lambda: T0 + 99 * 10**9)
        dm = src.delete_object("srcb", "hist", versioned=True)
        monkeypatch.undo()
        assert rp.on_delete("srcb", "hist", dm.version_id,
                            delete_marker=True)
        assert rp.wait_idle(20)
        keys = sorted({k for k, *_ in plan})
        target = {k: _versions(dst, "dstb", k) for k in keys}
        source = {k: _versions(src, "srcb", k) for k in keys}
        for key, vid in bodies:
            _, data = dst.get_object("dstb", key, version_id=vid)
            assert bytes(data) == bodies[key, vid], (impl.name, key, vid)
        got[impl.name] = (target, source, rp.stats()["completed"])
    assert got["port"] == got["jax"]
    target, source, completed = got["port"]
    assert completed == 6 + 3 + 1
    for key in target:
        # Every data version under the source's id, time and ETag; the
        # source's stamped COMPLETED, the target's REPLICA.
        strip = [(v[0], v[1], v[3]) for v in target[key] if v[0] != "marker"]
        assert strip == [(v[0], v[1], v[3]) for v in source[key]
                         if v[0] != "marker"]
        assert target[key][0][-1] == "REPLICA" or target[key][0][0] == \
            "marker"
    assert target["hist"][0] == ("marker", True)
    assert source["obj/0"][0][-1] == "COMPLETED"


# -- tests/test_bucket_features.py ----------------------------------------------

class GatedTarget(FlakyTarget):
    """An in-process target whose first put waits until `release` is
    set (`entered` says the copy has begun)."""

    def __init__(self, pools):
        super().__init__(pools)
        self.entered, self.release = threading.Event(), threading.Event()

    def put_object(self, bucket, key, data, metadata=None, **kw):
        self.entered.set()
        assert self.release.wait(20)
        return super().put_object(bucket, key, data, metadata=metadata,
                                  **kw)


def test_versions_written_back_to_back_all_reach_the_target(
        impl, tmp_path, made):
    """Three versions of one key acknowledged while the first one's copy
    runs.  The port journals a task per version and copies each by its
    id: all three land under their ids.  The JAX task has no version id,
    so the third's intent replaces the second's, and the copy takes
    whatever is latest when it runs: the middle version never reaches
    the target."""
    src, dst, rp = pair(impl, tmp_path, made, workers=1)
    gated = GatedTarget(dst)
    rp.configure("srcb", [impl.repl.ReplicationRule("", "dstb")], gated)
    bodies = {}
    for i in range(3):
        data = payload(40_000 + i, 70 + i)
        src.put_object("srcb", "hist", data, versioned=True,
                       version_id=V(i), mod_time_ns=T0 + i * 10**9)
        bodies[V(i)] = data
        assert rp.on_put("srcb", "hist", V(i))
        if i == 0:
            assert gated.entered.wait(20)    # the first copy has begun
    gated.release.set()
    assert rp.wait_idle(20)
    got = [v[0] for v in _versions(dst, "dstb", "hist")]
    if impl is JAX:
        assert got == [V(2), V(0)]
        return
    assert got == [V(2), V(1), V(0)]
    for vid, data in bodies.items():
        fi, back = dst.get_object("dstb", "hist", version_id=vid)
        assert bytes(back) == data and fi.mod_time_ns == \
            T0 + int(vid[-1]) * 10**9
    assert [v[4] for v in _versions(src, "srcb", "hist")] == \
        ["COMPLETED"] * 3
    assert rp.stats()["completed"] == 3


def test_parse(impl):
    rules = impl.repl.parse_replication_config(REPL_XML)
    assert [(r.prefix, r.target_bucket, r.delete_marker_replication)
            for r in rules] == [("rep/", "dst-bucket", True)]
    rng = np.random.default_rng(24)
    for _ in range(100):
        xml = "<ReplicationConfiguration>" + "".join(
            f"<Rule><Status>{rng.choice(['Enabled', 'Disabled'])}</Status>"
            f"<Filter><Prefix>{rng.choice(['', 'a/', 'b'])}</Prefix></Filter>"
            "<DeleteMarkerReplication><Status>"
            f"{rng.choice(['Enabled', 'Disabled'])}</Status>"
            "</DeleteMarkerReplication><Destination><Bucket>"
            f"{rng.choice(['arn:aws:s3:::', ''])}t{i}</Bucket></Destination>"
            "</Rule>" for i in range(int(rng.integers(1, 4)))) + \
            "</ReplicationConfiguration>"
        ours = port_repl.parse_replication_config(xml.encode())
        theirs = jax_repl.parse_replication_config(xml.encode())
        assert [vars(r) for r in ours] == [vars(r) for r in theirs]


def test_async_replication_between_pools(impl, tmp_path, made):
    src, dst, rp = pair(impl, tmp_path, made)
    dst.make_bucket("dst-bucket")
    rp.configure("srcb", impl.repl.parse_replication_config(REPL_XML), dst)
    src.put_object("srcb", "rep/a", b"replicate me")
    src.put_object("srcb", "skip/b", b"not me")
    assert rp.on_put("srcb", "rep/a")
    assert not rp.on_put("srcb", "skip/b")
    assert rp.wait_idle()
    fi, data = dst.get_object("dst-bucket", "rep/a")
    assert bytes(data) == b"replicate me"
    assert fi.metadata["x-amz-replication-status"] == "REPLICA"
    src.delete_object("srcb", "rep/a")
    rp.on_delete("srcb", "rep/a")
    assert rp.wait_idle()
    with pytest.raises(impl.errors.StorageError):
        dst.get_object("dst-bucket", "rep/a")


def test_resync_replays_bucket(impl, tmp_path, made):
    src, dst, rp = pair(impl, tmp_path, made)
    dst.make_bucket("dst-bucket")
    for i in range(3):
        src.put_object("srcb", f"rep/{i}", f"v{i}".encode())
    rp.configure("srcb", impl.repl.parse_replication_config(REPL_XML), dst)
    rp.start_resync("srcb")
    assert wait_for(lambda: (rp.resync_status("srcb") or {}).get(
        "status") == "done")
    assert rp.resync_status("srcb")["queued"] == 3
    assert rp.wait_idle()
    for i in range(3):
        assert bytes(dst.get_object("dst-bucket", f"rep/{i}")[1]) == \
            f"v{i}".encode()


def test_source_status_stamped(impl, tmp_path, made):
    src, dst, rp = pair(impl, tmp_path, made)
    dst.make_bucket("dst-bucket")
    rp.configure("srcb", impl.repl.parse_replication_config(REPL_XML), dst)
    src.put_object("srcb", "rep/x", b"stamp me")
    rp.on_put("srcb", "rep/x")
    assert rp.wait_idle()
    fi = src.head_object("srcb", "rep/x")
    assert fi.metadata["x-amz-replication-status"] == "COMPLETED"
    st = rp.stats()
    assert st["completed"] == 1 and st["bytesReplicated"] == 8


def test_a_dead_target_fails_then_completes_after_the_probe(
        impl, tmp_path, made, monkeypatch):
    """FAILED on the first attempt (each retry stamps PENDING again), the
    breaker opens after two, and its probe, once the target answers,
    copies and stamps COMPLETED."""
    monkeypatch.setenv("MTPU_REPL_RETRY_INTERVAL", "1")
    monkeypatch.setenv("MTPU_REPL_MAX_INTERVAL", "2")
    monkeypatch.setenv("MTPU_REPL_BREAKER_FAILS", "2")
    monkeypatch.setenv("MTPU_REPL_BREAKER_MAX", "1")
    src, dst, rp = pair(impl, tmp_path, made, workers=1)
    dead = FlakyTarget(dst, fail_n=10**9)
    rp.configure("srcb", [impl.repl.ReplicationRule("", "dstb")], dead)
    src.put_object("srcb", "rep/y", b"doomed, then not")
    rp.on_put("srcb", "rep/y")

    def status():
        return src.head_object("srcb", "rep/y").metadata.get(
            "x-amz-replication-status")
    # The counter moves before the stamp lands; the retry, 2 s on,
    # stamps PENDING again.
    assert wait_for(lambda: status() == "FAILED")
    assert rp.stats()["failed"] == 1
    assert wait_for(lambda: rp.stats()["breakersOpen"])
    st = rp.stats()
    assert st["failed"] == 1 and st["queued"] == 1
    assert st["lagSeconds"]["dstb"] > 0
    dead.fail_n = 0                              # the target is back
    assert wait_for(lambda: rp.stats()["completed"] == 1)
    assert rp.wait_idle()
    fi = src.head_object("srcb", "rep/y")
    assert fi.metadata["x-amz-replication-status"] == "COMPLETED"
    assert bytes(dst.get_object("dstb", "rep/y")[1]) == b"doomed, then not"
    assert rp.stats()["breakersOpen"] == {}
    if impl is PORT:
        assert rp.stats()["breakerTrips"]["srcb->dstb"]["opened"] >= 1
        assert rp.stats()["breakerTrips"]["srcb->dstb"]["probes"] == 1


def test_a_dark_target_never_hot_loops(impl, tmp_path, made, monkeypatch):
    monkeypatch.setenv("MTPU_REPL_RETRY_INTERVAL", "0.02")
    monkeypatch.setenv("MTPU_REPL_BREAKER_FAILS", "2")
    src, dst, rp = pair(impl, tmp_path, made, workers=1)
    rp.configure("srcb", [impl.repl.ReplicationRule("", "dstb")],
                 FlakyTarget(dst, fail_n=10**9))
    src.put_object("srcb", "k1", payload(512, 6))
    rp.on_put("srcb", "k1")
    assert wait_for(lambda: rp.stats().get("breakersOpen"))
    r0 = rp.stats()["retries"]
    time.sleep(0.5)
    assert rp.stats()["retries"] - r0 <= 4
    assert rp.stats()["queued"] == 1


# -- tests/test_replication_fault.py -------------------------------------------

def test_journal_algebra_matches_jax():
    rng = np.random.default_rng(25)
    ops = []
    for i in range(400):
        k = f"k{int(rng.integers(0, 12))}"
        kind = rng.choice(["enq", "enq", "done", "ckpt", "torn"])
        if kind == "enq":
            ops.append(json.dumps({"op": "enq", "t": "put", "b": "b",
                                   "k": k, "tb": "tb", "seq": i}))
        elif kind == "done":
            ops.append(json.dumps({
                "op": "done", "k": port_repl._task_key("put", "b", "tb", k),
                "seq": int(rng.integers(0, i + 1))}))
        elif kind == "ckpt":
            ops.append(json.dumps({"op": "ckpt", "seq": i, "pending": [
                {"t": "put", "b": "b", "k": k, "tb": "tb", "vid": "",
                 "dm": 0, "ts": 0.0, "seq": i}]}))
        else:
            ops.append('{"op":"enq","t":"put","b":"b","k":"to')
        raw = "\n".join(ops)
        ours, theirs = port_repl._net_pending(raw), jax_repl._net_pending(raw)
        assert list(ours) == list(theirs)
        assert [v["seq"] for v in ours.values()] == \
            [int(v["seq"]) for v in theirs.values()]


def _journal(pools):
    root = pools.pools[0].sets[0].drives[0].root
    return os.path.join(root, SYS_VOL, "repl-journal.jsonl")


def test_intent_journaled_then_replayed_exactly_once(impl, tmp_path, made):
    src, dst, rp = pair(impl, tmp_path, made, workers=1)
    rp.configure("srcb", [impl.repl.ReplicationRule("", "dstb")], dst)
    data = payload(8192, 1)
    src.put_object("srcb", "k1", data)
    assert rp.on_put("srcb", "k1")
    recs = [json.loads(ln) for ln in open(_journal(src)) if ln.strip()]
    assert any(r.get("op") == "enq" and r.get("k") == "k1" for r in recs)
    assert wait_for(lambda: rp.stats()["completed"] == 1)
    rp.stop()
    made.remove(("rp", rp))
    rp2 = impl.repl.ReplicationPool(src, workers=1)
    made.append(("rp", rp2))
    assert rp2.replayed == 0 and rp2.stats()["completed"] == 1


def test_boot_replay_waits_for_wiring(impl, tmp_path, made):
    src, dst = impl.pools(tmp_path, "src"), impl.pools(tmp_path, "dst")
    made += [("pools", src), ("pools", dst)]
    src.make_bucket("srcb")
    dst.make_bucket("dstb")
    data = {f"k{i}": payload(4096 + i, 10 + i) for i in range(3)}
    for k, v in data.items():
        src.put_object("srcb", k, v)
    jp = _journal(src)
    with open(jp, "w") as f:
        for i, k in enumerate(data):
            f.write(json.dumps({"op": "enq", "t": "put", "b": "srcb",
                                "k": k, "tb": "dstb", "seq": i + 1}) + "\n")
        f.write('{"op":"enq","t":"put","b":"srcb","k":"torn-tai')
    rp = impl.repl.ReplicationPool(src, workers=2)
    made.append(("rp", rp))
    assert rp.replayed == 3
    time.sleep(0.3)
    assert rp.stats()["queued"] == 3 and rp.stats()["dropped"] == 0
    rp.configure("srcb", [impl.repl.ReplicationRule("", "dstb")], dst)
    assert rp.wait_idle(20)
    for k, v in data.items():
        assert bytes(dst.get_object("dstb", k)[1]) == v


def test_unconfigure_drops_the_backlog(impl, tmp_path, made, monkeypatch):
    monkeypatch.setenv("MTPU_REPL_RETRY_INTERVAL", "0.02")
    src, dst, rp = pair(impl, tmp_path, made, workers=1)
    src.put_object("srcb", "k1", payload(512, 4))
    rp.configure("srcb", [impl.repl.ReplicationRule("", "dstb")],
                 FlakyTarget(dst, fail_n=10**9))
    rp.on_put("srcb", "k1")
    assert wait_for(lambda: rp.stats()["failed"] >= 1)
    rp.unconfigure("srcb")
    assert wait_for(lambda: rp.stats()["queued"] == 0)
    assert rp.stats()["dropped"] >= 1


def test_proxy_get_classifies(impl, tmp_path, made):
    src, dst, rp = pair(impl, tmp_path, made, workers=1)
    rp.configure("srcb", [impl.repl.ReplicationRule("", "dstb")], dst)
    with pytest.raises(impl.errors.ErrObjectNotFound):
        rp.proxy_get("srcb", "missing")
    data = payload(4096, 7)
    dst.put_object("dstb", "k1", data)
    assert rp.proxy_get("srcb", "k1")[1] == data
    assert rp.stats()["proxiedReads"] == 1
    rp.configure("srcb", [impl.repl.ReplicationRule("", "dstb")],
                 FlakyTarget(dst, fail_n=10**9))
    with pytest.raises(impl.repl.ErrReplicationTargetDown):
        rp.proxy_get("srcb", "anything")


def test_journaled_resync_counts_honestly(impl, tmp_path, made):
    src, dst, rp = pair(impl, tmp_path, made)
    bodies = {f"o{i:03d}": payload(1024, 20 + i) for i in range(40)}
    for k, v in bodies.items():
        src.put_object("srcb", k, v)
    rp.configure("srcb", [impl.repl.ReplicationRule("", "dstb")], dst)
    st = rp.start_resync("srcb")
    assert st["status"] == "running"
    assert wait_for(lambda: (rp.resync_status("srcb") or {}).get(
        "status") == "done" and rp.stats()["queued"] == 0, timeout=30)
    st = rp.resync_status("srcb")
    assert st["queued"] == len(bodies) and st["last_key"] == "o039"
    for k, v in bodies.items():
        assert bytes(dst.get_object("dstb", k)[1]) == v


# -- two S3Servers over loopback -----------------------------------------------

def _boot(impl, tmp, tag, made):
    pools = impl.pools(tmp, tag)
    made.append(("pools", pools))
    rp = impl.repl.ReplicationPool(pools)
    made.append(("rp", rp))
    srv = impl.S3Server(pools, impl.Credentials(ADMIN, SECRET),
                        replication=rp).start()
    made.append(("srv", srv))
    return srv, impl.S3Client(srv.endpoint, ADMIN, SECRET,
                              **impl.client_kw), rp


WIRE_XML = """<ReplicationConfiguration>
<Rule><ID>r1</ID><Status>Enabled</Status><Priority>1</Priority>
<DeleteMarkerReplication><Status>Enabled</Status>
</DeleteMarkerReplication>
<Filter><Prefix></Prefix></Filter>
<Destination><Bucket>arn:aws:s3:::{dst}</Bucket></Destination>
</Rule></ReplicationConfiguration>"""


def _wire(cli, src_bucket, dst_endpoint, dst_bucket):
    st, _, body = cli.request(
        "POST", "/minio/admin/v3/bucket-remote",
        query={"bucket": src_bucket},
        body=json.dumps({"endpoint": dst_endpoint, "accessKey": ADMIN,
                         "secretKey": SECRET,
                         "targetBucket": dst_bucket}).encode())
    assert st == 200, body
    arn = json.loads(body)["arn"]
    st, _, body = cli.request(
        "PUT", f"/{src_bucket}", query={"replication": ""},
        body=WIRE_XML.format(dst=dst_bucket).encode())
    assert st == 200, body
    return arn


def _versioned(cli, bucket):
    cli.make_bucket(bucket)
    st, _, _ = cli.request(
        "PUT", f"/{bucket}", query={"versioning": ""},
        body=b"<VersioningConfiguration><Status>Enabled</Status>"
             b"</VersioningConfiguration>")
    assert st == 200


def _version_count(cli, bucket, key):
    st, _, body = cli.request("GET", f"/{bucket}",
                              query={"versions": "", "prefix": key})
    assert st == 200
    return body.decode().count("<VersionId>")


@pytest.fixture
def vpair(impl, tmp_path, made):
    a = _boot(impl, tmp_path, "a", made)
    b = _boot(impl, tmp_path, "b", made)
    _versioned(a[1], "srcv")
    _versioned(b[1], "dstv")
    _wire(a[1], "srcv", b[0].endpoint, "dstv")
    return a, b


class TestVersionedFidelity:
    def test_replica_lands_under_source_version_id(self, vpair):
        (_, acli, arp), (_, bcli, brp) = vpair
        data = payload(300_000, 30)
        _, h, _ = acli._check(*acli.request("PUT", "/srcv/k1", body=data))
        src_vid = h.get("x-amz-version-id")
        assert src_vid and arp.wait_idle(20)
        th = bcli.head_object("dstv", "k1")
        assert th.get("x-amz-version-id") == src_vid
        assert th.get("x-amz-replication-status") == "REPLICA"
        sh = acli.head_object("srcv", "k1")
        assert sh.get("x-amz-replication-status") == "COMPLETED"
        assert th["Last-Modified"] == sh["Last-Modified"]
        assert th["ETag"] == sh["ETag"]
        assert bcli.get_object("dstv", "k1") == data
        assert _version_count(bcli, "dstv", "k1") == 1
        assert brp.stats()["completed"] == 0       # no echo

    def test_metadata_change_rereplicates_same_version(self, vpair):
        (_, acli, arp), (_, bcli, _) = vpair
        data = payload(4096, 31)
        _, h, _ = acli._check(*acli.request("PUT", "/srcv/k2", body=data))
        assert arp.wait_idle(20)
        done0 = arp.stats()["completed"]
        st, _, _ = acli.request(
            "PUT", "/srcv/k2", query={"tagging": ""},
            body=b"<Tagging><TagSet><Tag><Key>team</Key>"
                 b"<Value>gpu</Value></Tag></TagSet></Tagging>")
        assert st == 200
        assert wait_for(lambda: arp.stats()["completed"] > done0
                        and arp.stats()["queued"] == 0)
        assert _version_count(bcli, "dstv", "k2") == 1
        assert bcli.head_object("dstv", "k2").get("x-amz-version-id") == \
            h.get("x-amz-version-id")

    def test_delete_marker_replicates(self, vpair):
        (_, acli, arp), (_, bcli, _) = vpair
        data = payload(2048, 32)
        acli.put_object("srcv", "k3", data)
        assert arp.wait_idle(20)
        vid = bcli.head_object("dstv", "k3").get("x-amz-version-id")
        acli.delete_object("srcv", "k3")
        assert arp.wait_idle(20)
        assert wait_for(lambda: bcli.request("GET", "/dstv/k3")[0] == 404)
        assert bcli.get_object("dstv", "k3", version_id=vid) == data

    def test_root_may_send_the_replica_headers(self, vpair):
        """A principal allowed s3:ReplicateObject (root) may send the
        marker and the fidelity headers: the PUT lands as a REPLICA under
        the given version id and is replicated no further."""
        (asrv, acli, arp), _ = vpair
        st, h, _ = acli.request(
            "PUT", "/srcv/k4", body=b"replica",
            headers={"x-amz-replication-status": "REPLICA",
                     "x-mtpu-repl-version-id":
                         "33333333-3333-4333-8333-333333333333"})
        assert st == 200
        assert h.get("x-amz-version-id") == \
            "33333333-3333-4333-8333-333333333333"
        assert acli.head_object("srcv", "k4").get(
            "x-amz-replication-status") == "REPLICA"
        assert arp.stats()["completed"] == 0 and arp.wait_idle(5)


def test_active_active_no_ping_pong(impl, tmp_path, made):
    a = _boot(impl, tmp_path, "aa", made)
    b = _boot(impl, tmp_path, "bb", made)
    for cli in (a[1], b[1]):
        _versioned(cli, "ring")
    _wire(a[1], "ring", b[0].endpoint, "ring")
    _wire(b[1], "ring", a[0].endpoint, "ring")
    _, h, _ = a[1]._check(*a[1].request("PUT", "/ring/obj",
                                        body=payload(4096, 33)))
    assert a[2].wait_idle(20) and b[2].wait_idle(20)
    time.sleep(0.3)
    assert a[2].stats()["completed"] == 1
    assert b[2].stats()["completed"] == 0
    assert _version_count(a[1], "ring", "obj") == 1
    assert _version_count(b[1], "ring", "obj") == 1


def test_proxy_get_while_resyncing(impl, tmp_path, made):
    """The proxy serves a local miss only while the bucket resyncs; a
    target that cannot be reached is a 503 on the wire."""
    a = _boot(impl, tmp_path, "pa", made)
    b = _boot(impl, tmp_path, "pb", made)
    a[1].make_bucket("proxb")
    b[1].make_bucket("proxd")
    _wire(a[1], "proxb", b[0].endpoint, "proxd")
    data = payload(200_000, 34)
    b[1].put_object("proxd", "only-remote", data)
    st, _, body = a[1].request("GET", "/proxb/only-remote")
    assert st == 404 and b"NoSuchKey" in body
    a[2]._save_resync("proxb", {"bucket": "proxb", "status": "running",
                                "started": 0, "last_key": "",
                                "queued": 0})
    assert a[1].get_object("proxb", "only-remote") == data
    st, h, body = a[1].request("GET", "/proxb/only-remote",
                               headers={"Range": "bytes=10-19"})
    assert (st, body) == (206, data[10:20])
    assert h.get("x-amz-replication-status") == "REPLICA"
    st, _, _ = a[1].request("GET", "/proxb/absent")
    assert st == 404
    assert a[2].stats()["proxiedReads"] == 2
    # A dead endpoint as the target: 503, not a lying 404.
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    dead = s.getsockname()[1]
    s.close()
    a[1].make_bucket("deadb")
    _wire(a[1], "deadb", f"http://127.0.0.1:{dead}", "deadd")
    a[2]._save_resync("deadb", {"bucket": "deadb", "status": "running",
                                "started": 0, "last_key": "",
                                "queued": 0})
    st, _, body = a[1].request("GET", "/deadb/never-here")
    assert st == 503 and b"ReplicationRemoteConnectionError" in body


def test_admin_replication_and_bucket_remote(impl, tmp_path, made):
    a = _boot(impl, tmp_path, "ad", made)
    b = _boot(impl, tmp_path, "bd", made)
    a[1].make_bucket("mbkt")
    b[1].make_bucket("mbktd")
    st, _, body = a[1].request("GET", "/mbkt", query={"replication": ""})
    assert st == 404 and b"ReplicationConfigurationNotFoundError" in body
    # A rule naming an unregistered target bucket is refused before it
    # is stored, once a target is registered.
    arn = _wire(a[1], "mbkt", b[0].endpoint, "mbktd")
    st, _, body = a[1].request(
        "PUT", "/mbkt", query={"replication": ""},
        body=WIRE_XML.format(dst="elsewhere").encode())
    assert st == 400 and b"unregistered" in body
    a[1].put_object("mbkt", "k", payload(1024, 40))
    assert a[2].wait_idle(20)
    st, _, body = a[1].request("GET", "/minio/admin/v3/replication",
                               query={"bucket": "mbkt"})
    doc = json.loads(body)
    assert st == 200 and doc["completed"] == 1 and doc["resync"] is None
    assert "journalPending" in doc and "lagSeconds" in doc
    st, _, body = a[1].request("GET", "/minio/admin/v3/bucket-remote",
                               query={"bucket": "mbkt"})
    assert st == 200
    assert json.loads(body)["targets"] == [
        {"arn": arn, "endpoint": b[0].endpoint, "accessKey": ADMIN,
         "targetBucket": "mbktd"}]
    st, _, body = a[1].request(
        "POST", "/minio/admin/v3/replication",
        body=json.dumps({"op": "resync", "bucket": "mbkt"}).encode())
    assert st == 200 and json.loads(body)["status"] == "running"
    assert wait_for(lambda: (a[2].resync_status("mbkt") or {}).get(
        "status") == "done")
    st, _, _ = a[1].request("DELETE", "/minio/admin/v3/bucket-remote",
                            query={"bucket": "mbkt", "arn": arn})
    assert st == 200
    a[1].put_object("mbkt", "after", b"not replicated")
    time.sleep(0.3)
    assert b[1].request("HEAD", "/mbktd/after")[0] == 404
    st, _, _ = a[1].request("DELETE", "/minio/admin/v3/bucket-remote",
                            query={"bucket": "mbkt", "arn": arn})
    assert st == 404


def test_a_copy_replicates(impl, tmp_path, made):
    """The port's repair: a server-side copy is a write like a PUT and is
    replicated; the JAX package's copy is not."""
    a = _boot(impl, tmp_path, "ca", made)
    b = _boot(impl, tmp_path, "cb", made)
    a[1].make_bucket("cpy")
    b[1].make_bucket("cpyd")
    _wire(a[1], "cpy", b[0].endpoint, "cpyd")
    a[1].put_object("cpy", "src", b"copied bytes")
    assert a[2].wait_idle(20)
    st, _, _ = a[1].request("PUT", "/cpy/dst",
                            headers={"x-amz-copy-source": "/cpy/src"})
    assert st == 200
    assert a[2].wait_idle(20)
    got = b[1].request("GET", "/cpyd/dst")
    if impl is PORT:
        assert got[0] == 200 and got[2] == b"copied bytes"
        assert a[1].head_object("cpy", "dst").get(
            "x-amz-replication-status") == "COMPLETED"
    else:
        assert got[0] == 404


# -- the port alone: crash points, orphans, resumable resync ---------------------

CRASH_SCRIPT = r"""
import sys
from minio_tpu_torch.bucket.replication import (ReplicationPool,
                                                ReplicationRule)
from minio_tpu_torch.engine.pools import ServerPools
from minio_tpu_torch.engine.sets import ErasureSets
from minio_tpu_torch.storage.drive import LocalDrive
root, n = sys.argv[1], int(sys.argv[2])
def mk(tag):
    return ServerPools([ErasureSets([LocalDrive(f"{root}/{tag}-d{i}")
                                     for i in range(4)], set_drive_count=4,
                                    device="cpu")])
src, dst = mk("src"), mk("dst")
rp = ReplicationPool(src, workers=1)
rp.configure("srcb", [ReplicationRule("", "dstb")], dst)
fi = src.put_object("srcb", "k", bytes(range(256)) * n, versioned=True)
print(fi.version_id, flush=True)
rp.on_put("srcb", "k", fi.version_id)
rp.wait_idle(30)
print("survived", flush=True)
"""


@pytest.mark.parametrize("point", [p for p in crashpoints.POINTS
                                   if p.startswith("repl.")])
def test_death_at_each_crash_point_replays_exactly_once(point, tmp_path,
                                                        made):
    src, dst = _port_pools(tmp_path, "src"), _port_pools(tmp_path, "dst")
    src.make_bucket("srcb")
    dst.make_bucket("dstb")
    for p in (src, dst):
        close(p)
    n = 700                                    # 179,200 bytes: not inline
    env = dict(os.environ, MTPU_CRASH=point, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", CRASH_SCRIPT, str(tmp_path),
                        str(n)], env=env, cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 137, (r.stdout, r.stderr)
    assert f"dying at {point}" in r.stderr and "survived" not in r.stdout
    vid = r.stdout.split()[0]
    src, dst = _port_pools(tmp_path, "src"), _port_pools(tmp_path, "dst")
    made += [("pools", src), ("pools", dst)]
    rp = port_repl.ReplicationPool(src, workers=1)
    made.append(("rp", rp))
    assert rp.replayed == 1
    rp.configure("srcb", [port_repl.ReplicationRule("", "dstb")], dst)
    assert rp.wait_idle(30)
    vers = dst.list_object_versions("dstb", "k")
    assert [v.version_id for v in vers] == [vid]        # once, same id
    assert bytes(dst.get_object("dstb", "k")[1]) == bytes(range(256)) * n
    assert src.head_object("srcb", "k").metadata[
        "x-amz-replication-status"] == "COMPLETED"
    assert rp.stats()["completed"] == 1


def _write_journal(path, keys, seq0=1):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        for i, k in enumerate(keys):
            f.write(json.dumps({"op": "enq", "t": "put", "b": "srcb",
                                "k": k, "tb": "dstb",
                                "seq": seq0 + i}) + "\n")


def test_orphans_adopted_across_worker_ids_and_drained_pools(
        tmp_path, made, monkeypatch):
    """Worker 0 of a 2-worker pool adopts w3 (beyond the width) and the
    one-process journal from its home, and its own predecessor's journal
    from the drained pool's drive, where the home used to be; w1 is a
    live sibling's, left alone.  The home is pool 1's drive (pool 0
    drains); a worker 1 adopts only its own predecessor's."""
    p0 = ErasureSets([LocalDrive(f"{tmp_path}/p0-{i}") for i in range(4)],
                     set_drive_count=4, device="cpu")
    p1 = ErasureSets([LocalDrive(f"{tmp_path}/p1-{i}") for i in range(4)],
                     set_drive_count=4, deployment_id=p0.deployment_id,
                     device="cpu")
    pools = ServerPools([p0, p1])
    made.append(("pools", pools))
    pools.set_draining(0)
    old = os.path.join(f"{tmp_path}/p0-0", SYS_VOL)
    home = os.path.join(f"{tmp_path}/p1-0", SYS_VOL)
    _write_journal(f"{home}/repl-journal.w1.jsonl", ["live1"])
    _write_journal(f"{home}/repl-journal.w3.jsonl", ["gone3a", "gone3b"])
    _write_journal(f"{home}/repl-journal.jsonl", ["lone"])
    _write_journal(f"{old}/repl-journal.w0.jsonl", ["mine0"])
    _write_journal(f"{old}/repl-journal.w1.jsonl", ["old1"])
    monkeypatch.setenv("MTPU_WORKERS_TOTAL", "2")
    monkeypatch.setenv("MTPU_WORKER_ID", "0")
    rp = port_repl.ReplicationPool(pools, workers=1)
    made.append(("rp", rp))
    assert rp._jpath == f"{home}/repl-journal.w0.jsonl"
    assert rp.adopted == 3 and rp.replayed == 4
    def journals(d):
        return sorted(n for n in os.listdir(d)
                      if n.startswith("repl-journal"))
    assert journals(home) == ["repl-journal.w0.jsonl",
                              "repl-journal.w1.jsonl"]
    assert journals(old) == ["repl-journal.w1.jsonl"]
    assert not os.path.exists(f"{old}/repl-journal.w0.jsonl")
    rp.stop()
    made.remove(("rp", rp))
    monkeypatch.setenv("MTPU_WORKER_ID", "1")
    rp1 = port_repl.ReplicationPool(pools, workers=1)
    made.append(("rp", rp1))
    # Its own journal in the home (live1), and its predecessor's from
    # the old home (old1); no orphan adoption in a worker but 0.
    assert rp1.adopted == 1 and rp1.replayed == 2
    assert not os.path.exists(f"{old}/repl-journal.w1.jsonl")


class _PagedSource:
    """The source pools, listed 5 keys a page; `stop_after` pages in,
    the pool under test is told to stop."""

    def __init__(self, pools, stop_after):
        self._pools, self._stop_after, self.rp, self.pages = \
            pools, stop_after, None, 0

    def __getattr__(self, name):
        return getattr(self._pools, name)

    def list_objects(self, bucket, prefix="", marker="", max_keys=1000):
        self.pages += 1
        page = self._pools.list_objects(bucket, prefix, marker=marker,
                                        max_keys=5)
        if self.pages >= self._stop_after and self.rp is not None:
            self.rp._stop.set()
        return page


def test_a_resync_resumes_after_a_stop(tmp_path, made):
    src, dst = _port_pools(tmp_path, "src"), _port_pools(tmp_path, "dst")
    made += [("pools", src), ("pools", dst)]
    src.make_bucket("srcb")
    dst.make_bucket("dstb")
    bodies = {f"o{i:03d}": payload(700, 60 + i) for i in range(23)}
    for k, v in bodies.items():
        src.put_object("srcb", k, v)
    paged = _PagedSource(src, stop_after=2)
    rp = port_repl.ReplicationPool(paged, workers=1)
    paged.rp = rp
    dark = FlakyTarget(dst, fail_n=10**9)
    rp.configure("srcb", [port_repl.ReplicationRule("", "dstb")], dark)
    rp.start_resync("srcb")
    assert wait_for(lambda: not rp._resync_threads["srcb"].is_alive())
    rp.stop()
    st = rp.resync_status("srcb")
    assert st["status"] == "running" and st["last_key"] == "o009"
    assert st["queued"] == 10
    rp2 = port_repl.ReplicationPool(_PagedSource(src, stop_after=10**9),
                                    workers=2)
    made.append(("rp", rp2))
    assert rp2.replayed == 10
    rp2.configure("srcb", [port_repl.ReplicationRule("", "dstb")], dst)
    rp2.start_resync("srcb")
    assert wait_for(lambda: (rp2.resync_status("srcb") or {}).get(
        "status") == "done" and rp2.stats()["queued"] == 0, timeout=30)
    st = rp2.resync_status("srcb")
    assert st["queued"] == 23 and st["last_key"] == "o022"
    for k, v in bodies.items():
        assert [x.version_id for x in dst.list_object_versions(
            "dstb", k)] == [""]
        assert bytes(dst.get_object("dstb", k)[1]) == v


def test_the_journal_stays_off_a_draining_pool(tmp_path, made):
    p0 = ErasureSets([LocalDrive(f"{tmp_path}/p0-{i}") for i in range(4)],
                     set_drive_count=4, device="cpu")
    p1 = ErasureSets([LocalDrive(f"{tmp_path}/p1-{i}") for i in range(4)],
                     set_drive_count=4, deployment_id=p0.deployment_id,
                     device="cpu")
    pools = ServerPools([p0, p1])
    made.append(("pools", pools))
    rp = port_repl.ReplicationPool(pools, workers=1)
    assert rp._jpath.startswith(f"{tmp_path}/p0-0/")
    rp.stop()
    pools.set_draining(0)
    rp2 = port_repl.ReplicationPool(pools, workers=1)
    made.append(("rp", rp2))
    assert rp2._jpath.startswith(f"{tmp_path}/p1-0/")
    assert rp2._first_drives()[0].root == f"{tmp_path}/p1-0"


def test_the_journal_follows_a_live_drain(tmp_path, made):
    """A drain begun while the pool runs moves the journal (an idle
    pool's too) and the resync state off the draining pool: a task held
    back by a dead target is replayed by a reboot on the other pool
    alone.  Without the move, the intent stays on the drained pool's
    drive and is lost with it."""
    p0 = ErasureSets([LocalDrive(f"{tmp_path}/p0-{i}") for i in range(4)],
                     set_drive_count=4, device="cpu")
    p1 = ErasureSets([LocalDrive(f"{tmp_path}/p1-{i}") for i in range(4)],
                     set_drive_count=4, deployment_id=p0.deployment_id,
                     device="cpu")
    pools = ServerPools([p0, p1])
    made.append(("pools", pools))
    pools.make_bucket("srcb")
    pools.put_object("srcb", "k0", payload(900, 1))
    rp = port_repl.ReplicationPool(pools, workers=1)
    made.append(("rp", rp))
    old = f"{tmp_path}/p0-0/{SYS_VOL}/repl-journal.jsonl"
    new = f"{tmp_path}/p1-0/{SYS_VOL}/repl-journal.jsonl"
    assert rp._jpath == old
    dark = FlakyTarget(pools, fail_n=10**9)
    rp.configure("srcb", [port_repl.ReplicationRule("", "dstb")], dark)
    assert rp.on_put("srcb", "k0")
    state = {"bucket": "srcb", "status": "running", "last_key": "k0",
             "queued": 1}
    rp._save_resync("srcb", state)
    pools.set_draining(0)

    def moved():
        return os.path.exists(new) and not os.path.exists(old) and not any(
            os.path.exists(f"{tmp_path}/p0-{i}/{SYS_VOL}/replication/"
                           "resync-srcb.json") for i in range(4))
    assert wait_for(moved)
    assert rp.resync_status("srcb") == state
    pools.put_object("srcb", "k1", payload(900, 2))
    assert rp.on_put("srcb", "k1")
    assert not os.path.exists(old)
    rp.stop()
    made.remove(("rp", rp))
    # The drained pool's drives are gone: boot on pool 1 alone.
    rp2 = port_repl.ReplicationPool(ServerPools([p1]), workers=1)
    made.append(("rp", rp2))
    assert rp2.replayed == 2
    assert rp2.resync_status("srcb") == state
