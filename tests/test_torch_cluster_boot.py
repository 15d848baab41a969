"""Multi-process cluster boot of the port: `python -m minio_tpu_torch.server
--device cpu` subprocesses over URL endpoints (`http://127.0.0.1:PORT/path`),
as the JAX package's tests/test_cluster_boot.py boots its own, so format
bootstrap, peer verify, the storage, lock and peer planes and a heal across
processes run over real sockets between interpreters.  Plus read-after-write
across nodes: a new version PUT through one node is what the other serves at
once.  Every wait here has its own deadline, so a hung peer fails its test,
not the run."""

import contextlib
import glob
import hashlib
import json
import os
import shutil
import socket
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest

from minio_tpu_torch.server.client import S3Client

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOOT_S = 90          # each node's boot, self-tests and format wait included


def _free_ports(n):
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


def _wait_ready(port, procs, timeout=BOOT_S):
    deadline = time.monotonic() + timeout
    url = f"http://127.0.0.1:{port}/minio/health/ready"
    while time.monotonic() < deadline:
        if any(p.poll() is not None for p in procs):
            raise RuntimeError("a node exited during the boot")
        try:
            with urllib.request.urlopen(url, timeout=2) as r:
                if r.status == 200:
                    return
        except Exception:  # noqa: BLE001 — not up yet
            pass
        time.sleep(0.2)
    raise TimeoutError(f"node on :{port} never became ready")


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["MTPU_BOOT_TIMEOUT"] = str(BOOT_S)
    env.update(extra)
    return env


def _node(args, port, env, log):
    return subprocess.Popen(
        [sys.executable, "-m", "minio_tpu_torch.server", "--device", "cpu",
         "--drives", " ".join(args), "--port", str(port)],
        stdout=log, stderr=subprocess.STDOUT, env=env, cwd=ROOT)


def _stop(procs):
    for pr in procs:
        if pr.poll() is None:
            pr.terminate()
    for pr in procs:
        try:
            pr.wait(timeout=15)
        except subprocess.TimeoutExpired:
            pr.kill()
            pr.wait(timeout=5)


@contextlib.contextmanager
def _booted(tmp_path, **env):
    """2 node processes x 4 drives -> one erasure set of 8."""
    ports = _free_ports(2)
    args = [f"http://127.0.0.1:{p}{tmp_path}/n{i}/d{{1...4}}"
            for i, p in enumerate(ports, 1)]
    procs, logs = [], []
    try:
        for i, p in enumerate(ports):
            log = open(tmp_path / f"node{i}.log", "wb")
            logs.append(log)
            procs.append(_node(args, p, _env(**env), log))
        for p in ports:
            _wait_ready(p, procs)
        yield ports, tmp_path
    finally:
        _stop(procs)
        for log in logs:
            log.close()
        for i in range(len(ports)):
            sys.stderr.write(
                (tmp_path / f"node{i}.log").read_text(errors="replace"))


@pytest.fixture()
def cluster(tmp_path):
    with _booted(tmp_path) as booted:
        yield booted


def payload(size, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, size, dtype=np.uint8).tobytes()


def _clients(ports):
    return [S3Client(f"http://127.0.0.1:{p}", "minioadmin", "minioadmin",
                     timeout=30) for p in ports]


def test_boot_put_get_wipe_heal(cluster):
    ports, tmp = cluster
    c1, c2 = _clients(ports)
    c1.make_bucket("clus")
    blobs = {f"o{i}": payload(200_000 + i * 1000, seed=i) for i in range(3)}
    blobs["inline"] = payload(5000, seed=9)
    for name, data in blobs.items():
        c1.put_object("clus", name, data)
    for name, data in blobs.items():
        assert c2.get_object("clus", name) == data
    # Host-aware layout: shards on both nodes.
    for node_dir in ("n1", "n2"):
        assert [p for p in glob.glob(f"{tmp}/{node_dir}/d*/clus/**",
                                     recursive=True) if os.path.isfile(p)]
    st, _, body = c2.request("GET", "/minio/health/cluster")
    assert st == 200 and json.loads(body)["sets"][0]["online"] == 8

    victim = f"{tmp}/n2/d1"
    for entry in os.listdir(victim):
        shutil.rmtree(os.path.join(victim, entry), ignore_errors=True)
    for name, data in blobs.items():
        assert c1.get_object("clus", name) == data
        assert c2.get_object("clus", name) == data

    # A heal sequence started on node 1 restores node 2's drive over the
    # storage plane.
    st, _, body = c1.request("POST", "/minio/admin/v3/heal/", query={})
    assert st == 200, body
    deadline = time.monotonic() + 60
    seqs = []
    while time.monotonic() < deadline:
        _, _, body = c1.request("GET", "/minio/admin/v3/heal/", query={})
        seqs = json.loads(body)["sequences"]
        if seqs and seqs[-1]["state"] in ("done", "failed"):
            break
        time.sleep(0.25)
    assert seqs and seqs[-1]["state"] == "done", seqs
    assert not seqs[-1]["failures"], seqs
    restored = [p for p in glob.glob(f"{victim}/**", recursive=True)
                if os.path.isfile(p)]
    assert any("clus/" in p and p.endswith("xl.meta") for p in restored)
    assert os.path.exists(os.path.join(victim, ".mtpu.sys", "format.json"))
    for name, data in blobs.items():
        assert c1.get_object("clus", name) == data
        assert c2.get_object("clus", name) == data

    # The lists agree from both nodes.
    names = sorted(blobs)
    assert c1.list_objects("clus")[0] == names
    assert c2.list_objects("clus")[0] == names


def _etag(headers) -> str:
    return {k.lower(): v for k, v in headers.items()}["etag"].strip('"')


def test_read_after_write_across_nodes(cluster):
    """A new version PUT through node 1 is what node 2 serves at once,
    GET first or HEAD first, though node 2 read the old one just before
    (its FileInfo cache holds it).  Both packages elect the metadata on
    every S3 GET and HEAD, so neither serves the stale version here."""
    ports, _ = cluster
    c1, c2 = _clients(ports)
    c1.make_bucket("raw")
    for size in (200_000, 3000):                 # streamed and inline
        key = f"k{size}"
        old, new = payload(size, seed=size), payload(size, seed=size + 1)
        c1.put_object("raw", key, old)
        assert c2.get_object("raw", key) == old
        c1.put_object("raw", key, new)
        assert c2.get_object("raw", key) == new
        st, hdrs, _ = c2.request("HEAD", f"/raw/{key}")
        assert st == 200
        assert _etag(hdrs) == hashlib.md5(new).hexdigest()
        newer = payload(size, seed=size + 2)
        c2.put_object("raw", key, newer)
        st, hdrs, _ = c1.request("HEAD", f"/raw/{key}")
        assert _etag(hdrs) == hashlib.md5(newer).hexdigest()
        assert c1.get_object("raw", key) == newer


def test_iam_change_through_one_node_reaches_the_other(cluster):
    """A user added through node 1 signs requests to node 2 at once: IAM
    broadcasts its reload over the peer plane, and the reload lists the
    identities afresh (the JAX cluster boot builds its IAMSys without
    the broadcast)."""
    ports, _ = cluster
    c1, c2 = _clients(ports)
    c1.make_bucket("iamb")
    c1.add_user("alice", "alice-secret-key", ["readwrite"])
    alice2 = S3Client(f"http://127.0.0.1:{ports[1]}", "alice",
                      "alice-secret-key", timeout=30)
    alice2.put_object("iamb", "a", b"from alice")
    assert c1.get_object("iamb", "a") == b"from alice"
    c2.add_user("bob", "bob-secret-key", ["readwrite"])
    bob1 = S3Client(f"http://127.0.0.1:{ports[0]}", "bob",
                    "bob-secret-key", timeout=30)
    assert bob1.get_object("iamb", "a") == b"from alice"


def test_rejects_mixed_root_credentials(tmp_path):
    """A node booted with other root credentials must not join: its
    bearer token differs and bootstrap verify rejects it."""
    ports = _free_ports(2)
    args = [f"http://127.0.0.1:{p}{tmp_path}/m{i}/d{{1...4}}"
            for i, p in enumerate(ports, 1)]
    env = _env(MTPU_BOOT_TIMEOUT="6")
    env2 = dict(env, MTPU_ROOT_USER="otheradmin",
                MTPU_ROOT_PASSWORD="otherpassword")
    p1 = _node(args, ports[0], env, subprocess.DEVNULL)
    p2 = _node(args, ports[1], env2, subprocess.PIPE)
    try:
        rc2 = p2.wait(timeout=60)
        out = p2.stdout.read().decode(errors="replace")
        assert rc2 != 0, out
        assert "cluster boot failed" in out
    finally:
        _stop([p1, p2])


def test_every_node_runs_its_scanner(tmp_path):
    """Each node boots its own data scanner (the JAX cluster boot's
    DataScanner on every node): a PUT through node 1 is in both nodes'
    usage after their next cycles, and a drive's removed xl.meta on node
    2 is healed by a normal cycle."""
    with _booted(tmp_path, MTPU_SCANNER_INTERVAL="0.3") as (ports, tmp):
        c1, c2 = _clients(ports)
        c1.make_bucket("scan")
        data = payload(150_000, seed=3)
        c1.put_object("scan", "obj", data)

        def usage(cli):
            st, doc = cli.admin("GET", "datausage")
            if st != 200:
                return None
            return doc["buckets"].get("scan", {}).get("o")
        deadline = time.monotonic() + 60
        while not (usage(c1) == 1 and usage(c2) == 1):
            assert time.monotonic() < deadline, (usage(c1), usage(c2))
            time.sleep(0.3)
        meta = tmp / "n2" / "d3" / "scan" / "obj" / "xl.meta"
        want = meta.read_bytes()
        meta.unlink()
        deadline = time.monotonic() + 60
        while not meta.exists():
            assert time.monotonic() < deadline, "xl.meta never healed"
            time.sleep(0.2)
        time.sleep(0.5)
        assert meta.read_bytes() == want
        assert c2.get_object("scan", "obj") == data


# -- a config written through one node governs every node ---------------------

@pytest.fixture(scope="module")
def configs_cluster(tmp_path_factory):
    """One two-node cluster for the config tests, with a webhook
    receiver every node's notify_webhook target points at."""
    from test_torch_notify import Receiver
    recv = Receiver()
    tmp = tmp_path_factory.mktemp("cfgclus")
    try:
        with _booted(tmp, MTPU_NOTIFY_WEBHOOK_ENABLE="on",
                     MTPU_NOTIFY_WEBHOOK_ENDPOINT=recv.url,
                     MTPU_NOTIFY_STORE_DIR=str(tmp / "store"),
                     MTPU_SCANNER="0",
                     MTPU_REPL_RETRY_INTERVAL="0.05") as (ports, _):
            yield ports, recv, tmp
    finally:
        recv.close()


_ENABLED = (b"<VersioningConfiguration><Status>Enabled</Status>"
            b"</VersioningConfiguration>")


def test_versioning_enabled_through_one_node_reaches_the_other(
        configs_cluster):
    """Node 2 has read the bucket's versioning as absent; versioning is
    enabled through node 1: node 2's next PUT of the key adds a version
    (both listed).  Without the bucket-metadata broadcast node 2 keeps
    its cached absence and replaces the null version."""
    ports = configs_cluster[0]
    c1, c2 = _clients(ports)
    c1.make_bucket("qcv")
    c2.put_object("qcv", "k", b"null version")
    assert c1.request("PUT", "/qcv", query={"versioning": ""},
                      body=_ENABLED)[0] == 200
    h = c2.put_object("qcv", "k", b"second version")
    assert h.get("x-amz-version-id"), h
    st, _, body = c2.request("GET", "/qcv", query={"versions": ""})
    assert st == 200
    assert body.count(b"<Version>") == 2, body
    assert c2.get_object("qcv", "k") == b"second version"


def test_replication_config_through_one_node_wires_and_unwires_the_other(
        configs_cluster, tmp_path):
    """A remote target and a replication config stored through node 1
    wire node 2: its PUT is replicated; the config deleted through node
    1 unwires node 2 at once."""
    from minio_tpu_torch.engine.pools import ServerPools
    from minio_tpu_torch.engine.sets import ErasureSets
    from minio_tpu_torch.server.server import S3Server
    from minio_tpu_torch.server.sigv4 import Credentials
    from minio_tpu_torch.storage.drive import LocalDrive
    ports = configs_cluster[0]
    c1, c2 = _clients(ports)
    dst = ServerPools([ErasureSets(
        [LocalDrive(str(tmp_path / f"t{i}")) for i in range(4)],
        set_drive_count=4, device="cpu")])
    tsrv = S3Server(dst, Credentials("minioadmin", "minioadmin")).start()
    try:
        tcli = S3Client(tsrv.endpoint, "minioadmin", "minioadmin",
                        timeout=30)
        for cli, b in ((c1, "qcr"), (tcli, "qcdst")):
            cli.make_bucket(b)
            assert cli.request("PUT", f"/{b}", query={"versioning": ""},
                               body=_ENABLED)[0] == 200
        c2.put_object("qcr", "pre", b"before the config")
        st, _, body = c1.request(
            "POST", "/minio/admin/v3/bucket-remote", query={"bucket": "qcr"},
            body=json.dumps({"endpoint": tsrv.endpoint,
                             "accessKey": "minioadmin",
                             "secretKey": "minioadmin",
                             "targetBucket": "qcdst"}).encode())
        assert st == 200, body
        repl_xml = (b"<ReplicationConfiguration><Rule><Status>Enabled"
                    b"</Status><Filter><Prefix></Prefix></Filter>"
                    b"<Destination><Bucket>arn:aws:s3:::qcdst</Bucket>"
                    b"</Destination></Rule></ReplicationConfiguration>")
        st, _, body = c1.request("PUT", "/qcr", query={"replication": ""},
                                 body=repl_xml)
        assert st == 200, body
        c2.put_object("qcr", "wired", b"through node 2")
        deadline = time.monotonic() + 30
        while tcli.request("HEAD", "/qcdst/wired")[0] != 200:
            assert time.monotonic() < deadline, "never replicated"
            time.sleep(0.1)
        assert tcli.get_object("qcdst", "wired") == b"through node 2"
        assert c1.request("DELETE", "/qcr",
                          query={"replication": ""})[0] == 204
        c2.put_object("qcr", "unwired", b"after the delete")
        st, hdrs, _ = c2.request("HEAD", "/qcr/unwired")
        assert st == 200
        assert "x-amz-replication-status" not in {k.lower() for k in hdrs}
        time.sleep(1.0)
        assert tcli.request("HEAD", "/qcdst/unwired")[0] == 404
    finally:
        tsrv.shutdown()
        for pool in dst.pools:
            for es in pool.sets:
                es.close()


def test_object_lock_default_through_one_node_governs_the_other(
        configs_cluster):
    """Node 2 has read the bucket's object-lock config as absent; a
    default retention set through node 1 reaches node 2's next PUT, so
    node 2 refuses to delete the protected object."""
    ports = configs_cluster[0]
    c1, c2 = _clients(ports)
    c1.make_bucket("qcl")
    c2.put_object("qcl", "k", b"unprotected")
    lock = (b"<ObjectLockConfiguration><ObjectLockEnabled>Enabled"
            b"</ObjectLockEnabled><Rule><DefaultRetention><Mode>GOVERNANCE"
            b"</Mode><Days>1</Days></DefaultRetention></Rule>"
            b"</ObjectLockConfiguration>")
    assert c1.request("PUT", "/qcl", query={"object-lock": ""},
                      body=lock)[0] == 200
    c2.put_object("qcl", "k", b"protected")
    st, _, body = c2.request("DELETE", "/qcl/k")
    assert st == 400 and b"ObjectLocked" in body, (st, body)
    assert c1.get_object("qcl", "k") == b"protected"


def test_config_and_notification_rules_through_one_node_reach_the_other(
        configs_cluster):
    """A `?notification` rule stored through node 1 routes node 2's next
    PUT to the webhook, and `config set storage_class` through node 1
    governs node 2's next STANDARD PUT (both broadcast: bucket-metadata
    and config)."""
    ports, recv, tmp = configs_cluster
    c1, c2 = _clients(ports)
    c1.make_bucket("qcn")
    c2.put_object("qcn", "before", b"no rule yet")
    rules = (b"<NotificationConfiguration><QueueConfiguration><Queue>"
             b"arn:minio:sqs::1:webhook</Queue><Event>s3:ObjectCreated:*"
             b"</Event></QueueConfiguration></NotificationConfiguration>")
    assert c1.request("PUT", "/qcn", query={"notification": ""},
                      body=rules)[0] == 200
    c2.put_object("qcn", "after", b"routed")
    keys = [(r["s3"]["bucket"]["name"], r["s3"]["object"]["key"])
            for r in recv.records]
    assert keys == [("qcn", "after")], keys
    st, doc = c1.admin("POST", "config", doc={
        "subsys": "storage_class", "key": "standard", "value": "EC:3"})
    assert (st, doc) == (200, {"ok": True})
    st, _, _ = c2.request("PUT", "/qcn/sc", body=b"s" * 200_000,
                          headers={"x-amz-storage-class": "STANDARD"})
    assert st == 200
    st, doc = c2.admin("GET", "config", {"subsys": "storage_class"})
    assert doc["storage_class"]["standard"] == "EC:3"
    from minio_tpu_torch.storage.xlmeta import XLMeta
    metas = glob.glob(f"{tmp}/n*/d*/qcn/sc/xl.meta")
    assert len(metas) == 8
    parity = {XLMeta.from_bytes(open(p, "rb").read()).latest()
              .erasure.parity_blocks for p in metas}
    assert parity == {3}, parity
