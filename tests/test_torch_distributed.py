"""The port's distributed planes: the cases of the JAX package's
tests/test_distributed.py (RPC core, dsync over real HTTP lock servers,
the namespace lock's dsync form, erasure sets striped over local and
remote drives, the peer plane's fan-out and bootstrap verify) on
minio_tpu_torch, plus the wire between the packages in both directions:
the port's RemoteDrive against the JAX storage plane and the JAX
RemoteDrive against the port's, with equal results, and the port's
RemoteLocker against the JAX lock plane.  Inputs from a numpy seed;
tolerance: exact bytes."""

import os
import threading
import time

import numpy as np
import pytest

from minio_tpu.cluster.local_locker import LocalLocker as JaxLocalLocker
from minio_tpu.rpc import lock_rpc as jax_lock_rpc
from minio_tpu.rpc import rest as jax_rest
from minio_tpu.rpc import storage_rpc as jax_storage_rpc
from minio_tpu.storage.drive import LocalDrive as JaxLocalDrive
from minio_tpu.storage.xlmeta import FileInfo as JaxFileInfo
from minio_tpu_torch.cluster.dsync import DRWMutex
from minio_tpu_torch.cluster.local_locker import LocalLocker
from minio_tpu_torch.cluster.nslock import LockLost, NSLockMap
from minio_tpu_torch.engine import erasure_set as port_es_mod
from minio_tpu_torch.engine.erasure_set import ErasureSet
from minio_tpu_torch.engine.sets import ErasureSets
from minio_tpu_torch.ops import metalanes
from minio_tpu_torch.rpc.lock_rpc import RemoteLocker, register_lock_rpc
from minio_tpu_torch.rpc.peer_rpc import (NotificationSys, PeerRegistry,
                                         register_bootstrap_rpc,
                                         register_peer_rpc,
                                         verify_cluster_config)
from minio_tpu_torch.rpc.rest import (NetworkError, RPCClient, RPCServer,
                                     RPCVersionMismatch)
from minio_tpu_torch.rpc.storage_rpc import (STORAGE_RPC_VERSION,
                                            RemoteDrive,
                                            register_storage_rpc)
from minio_tpu_torch.storage import drive as port_drive
from minio_tpu_torch.storage.drive import LocalDrive
from minio_tpu_torch.storage.errors import (ErrDiskNotFound,
                                            ErrFileNotFound, StorageError)
from minio_tpu_torch.storage.format import init_format_sets
from minio_tpu_torch.storage.health_wrap import HealthWrappedDrive

TOKEN = "test-cluster-token"


def payload(size, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, size, dtype=np.uint8).tobytes()


def tree(root):
    out = {}
    for dirpath, dirs, files in os.walk(root):
        dirs[:] = [d for d in dirs if d != ".mtpu.sys"]
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


# -- RPC core ------------------------------------------------------------------

class TestRPCCore:
    def test_call_roundtrip_and_typed_errors(self):
        srv = RPCServer(TOKEN).start()
        srv.register("t.echo", lambda p: {"got": p.get("x")})

        def boom(p):
            raise ErrFileNotFound("nope")
        srv.register("t.boom", boom)
        try:
            cli = RPCClient(srv.endpoint, TOKEN)
            assert cli.call("t.echo", {"x": [1, "two", b"three"]}) == \
                {"got": [1, "two", b"three"]}
            with pytest.raises(ErrFileNotFound):
                cli.call("t.boom")
            assert cli.is_online()
        finally:
            srv.shutdown()

    def test_plane_version_mismatch_typed_rejection(self):
        srv = RPCServer(TOKEN).start()
        try:
            register_storage_rpc(srv, [])
            cli = RPCClient(srv.endpoint, TOKEN, versions={"storage": "v0"})
            with pytest.raises(RPCVersionMismatch) as ei:
                cli.call("storage.list_volumes", {"drive": 0})
            assert (ei.value.plane, ei.value.want, ei.value.got) == \
                ("storage", STORAGE_RPC_VERSION, "v0")
            assert cli.is_online()
            cli2 = RPCClient(srv.endpoint, TOKEN)
            with pytest.raises(ErrDiskNotFound):
                cli2.call("storage.list_volumes", {"drive": 5})
        finally:
            srv.shutdown()

    def test_unknown_plane_404_and_bad_token_403(self):
        srv = RPCServer(TOKEN).start()
        try:
            with pytest.raises(StorageError, match="no such rpc plane"):
                RPCClient(srv.endpoint, TOKEN).call("nosuchplane.method")
            with pytest.raises(StorageError, match="bad rpc token"):
                RPCClient(srv.endpoint, "wrong").call("health.health")
        finally:
            srv.shutdown()

    def test_offline_detection_and_recovery(self):
        srv = RPCServer(TOKEN).start()
        port = srv.port
        cli = RPCClient(srv.endpoint, TOKEN, check_interval=0.1)
        assert cli.call("health.health")["ok"]
        srv.shutdown()
        with pytest.raises(NetworkError):
            cli.call("health.health")
        assert not cli.is_online()
        with pytest.raises(NetworkError, match="offline"):
            cli.call("health.health")
        srv2 = RPCServer(TOKEN, port=port).start()
        try:
            deadline = time.monotonic() + 5
            while not cli.is_online() and time.monotonic() < deadline:
                time.sleep(0.05)
            assert cli.is_online()
            assert cli.call("health.health")["ok"]
            assert cli.peer_info()["transitions"] == 2
        finally:
            cli.close()
            srv2.shutdown()

    def test_idempotent_reads_retry_writes_do_not(self):
        """A transient fault on an idempotent call is retried before the
        endpoint goes offline; a write fails at once."""
        srv = RPCServer(TOKEN).start()
        try:
            cli = RPCClient(srv.endpoint, TOKEN)
            real, fails = cli._raw_call, [1]

            def flaky(method, payload, timeout=None):
                if fails[0]:
                    fails[0] -= 1
                    raise NetworkError("reset", retryable=True)
                return real(method, payload, timeout)
            cli._raw_call = flaky
            assert cli.call("health.health", idempotent=True)["ok"]
            assert cli.is_online()
            fails[0] = 1
            with pytest.raises(NetworkError):
                cli.call("health.health")
            assert not cli.is_online()
        finally:
            cli.close()
            srv.shutdown()


# -- dsync over real HTTP lock servers ----------------------------------------

@pytest.fixture()
def lock_cluster():
    servers, lockers, clients = [], [], []
    for _ in range(5):
        locker = LocalLocker(stale_after=2.0)
        srv = RPCServer(TOKEN).start()
        register_lock_rpc(srv, locker)
        cli = RPCClient(srv.endpoint, TOKEN, check_interval=0.1)
        servers.append(srv)
        lockers.append(locker)
        clients.append(RemoteLocker(cli))
    yield servers, lockers, clients
    for s in servers:
        s.shutdown()
    for c in clients:
        c._client.close()


class TestDsync:
    def test_exclusive_write_lock(self, lock_cluster):
        _, _, remote = lock_cluster
        a, b = DRWMutex("bkt/obj", remote), DRWMutex("bkt/obj", remote)
        assert a.get_lock(timeout=2)
        assert not b.get_lock(timeout=0.5)
        a.unlock()
        assert b.get_lock(timeout=2)
        b.unlock()

    def test_shared_read_locks_block_writer(self, lock_cluster):
        _, _, remote = lock_cluster
        r1, r2 = DRWMutex("bkt/o2", remote), DRWMutex("bkt/o2", remote)
        w = DRWMutex("bkt/o2", remote)
        assert r1.get_rlock(timeout=2) and r2.get_rlock(timeout=2)
        assert not w.get_lock(timeout=0.5)
        r1.unlock()
        r2.unlock()
        assert w.get_lock(timeout=2)
        w.unlock()

    def test_quorum_survives_minority_servers_down(self, lock_cluster):
        servers, _, remote = lock_cluster
        servers[0].shutdown()
        servers[1].shutdown()
        m = DRWMutex("bkt/o3", remote)
        assert m.get_lock(timeout=3)
        m.unlock()

    def test_no_quorum_majority_down(self, lock_cluster):
        servers, _, remote = lock_cluster
        for s in servers[:3]:
            s.shutdown()
        assert not DRWMutex("bkt/o4", remote).get_lock(timeout=1.0)

    def test_stale_lock_swept_after_owner_dies(self, lock_cluster):
        _, _, remote = lock_cluster
        m = DRWMutex("bkt/o5", remote, refresh_interval=100)
        assert m.get_lock(timeout=2)
        m._stop_refresh.set()             # the owner stops refreshing
        time.sleep(2.2)                   # > stale_after on the lockers
        m2 = DRWMutex("bkt/o5", remote)
        assert m2.get_lock(timeout=2)
        m2.unlock()

    def test_refresh_loss_callback(self, lock_cluster):
        servers, _, remote = lock_cluster
        lost = threading.Event()
        m = DRWMutex("bkt/o6", remote, refresh_interval=0.2,
                     loss_callback=lambda r: lost.set())
        assert m.get_lock(timeout=2)
        for s in servers:
            s.shutdown()
        assert lost.wait(timeout=5), "loss callback not fired"


class TestNSLock:
    def test_local_write_mutual_exclusion(self):
        ns = NSLockMap()
        order, done = [], threading.Event()
        with ns.write_locked("b", "o"):
            def second():
                with ns.write_locked("b", "o"):
                    order.append("second")
                done.set()
            t = threading.Thread(target=second)
            t.start()
            time.sleep(0.1)
            order.append("first")
        assert done.wait(2)
        t.join()
        assert order == ["first", "second"]

    def test_local_readers_shared(self):
        ns = NSLockMap()
        with ns.read_locked("b", "o"):
            with ns.read_locked("b", "o"):
                pass

    def test_distributed_mode(self, lock_cluster):
        _, _, remote = lock_cluster
        ns = NSLockMap(lockers=remote)
        assert ns.stripes is None
        with ns.write_locked("b", "o7"):
            assert not DRWMutex("b/o7", remote).get_lock(timeout=0.3)
        with ns.read_locked("b", "o7"):
            with ns.read_locked("b", "o7", timeout=1):
                pass
        other = DRWMutex("b/o7", remote)
        assert other.get_lock(timeout=1)
        with pytest.raises(LockLost):
            with ns.write_locked("b", "o7", timeout=0.3):
                pass
        other.unlock()

    def test_lock_lost_mid_operation_raises(self, lock_cluster,
                                            monkeypatch):
        """A lease that ran out while the operation held the lock (no
        refresh quorum within it) makes the operation fail after it."""
        _, _, remote = lock_cluster
        ns = NSLockMap(lockers=remote)
        with pytest.raises(LockLost, match="lost during operation"):
            with ns.write_locked("b", "o8"):
                monkeypatch.setattr(DRWMutex, "lease_expired",
                                    lambda self: True)


# -- storage RPC: sets striped over local and remote drives -------------------

@pytest.fixture()
def mixed_set(tmp_path):
    """2 local drives + 2 drives served over real HTTP from this process."""
    local = [LocalDrive(str(tmp_path / f"local{i}")) for i in range(2)]
    served = [LocalDrive(str(tmp_path / f"served{i}")) for i in range(2)]
    srv = RPCServer(TOKEN).start()
    register_storage_rpc(srv, served, device="cpu")
    cli = RPCClient(srv.endpoint, TOKEN, check_interval=0.1)
    remote = [RemoteDrive(cli, i) for i in range(2)]
    es = ErasureSet(local + remote, default_parity=2, device="cpu")
    yield es, srv, served
    es.close()
    cli.close()
    srv.shutdown()


class TestStorageRPC:
    def test_put_get_across_wire(self, mixed_set):
        es, _, served = mixed_set
        es.make_bucket("dist")
        data = payload(300000, seed=4)
        es.put_object("dist", "obj", data)
        assert es.get_object("dist", "obj")[1] == data
        fi = es.head_object("dist", "obj")
        assert served[0].file_size("dist", f"obj/{fi.data_dir}/part.1") > 0

    def test_remote_failure_degrades_not_fails(self, mixed_set):
        es, srv, _ = mixed_set
        es.make_bucket("dist")
        data = payload(200000, seed=5)
        es.put_object("dist", "obj2", data)
        srv.shutdown()
        assert es.get_object("dist", "obj2")[1] == data

    def test_remote_inline_and_metadata(self, mixed_set):
        es, _, served = mixed_set
        es.make_bucket("dist")
        es.put_object("dist", "small", b"tiny inline object")
        assert es.get_object("dist", "small")[1] == b"tiny inline object"
        assert served[1].read_version("dist", "small").inline_data \
            is not None

    def test_versioned_delete_marker_reaches_remote_drives(self, mixed_set):
        """The delete marker's FileInfo rides among the wire args: every
        drive, remote ones included, records it (the JAX client put it in
        kwargs, which msgpack cannot carry)."""
        es, _, served = mixed_set
        es.make_bucket("dist")
        es.put_object("dist", "v", b"v1", versioned=True)
        dm = es.delete_object("dist", "v", versioned=True)
        for d in served:
            assert d.read_version("dist", "v").deleted
            assert d.read_version("dist", "v").version_id == dm.version_id

    def test_remote_verify_file_runs_on_the_serving_node(self, mixed_set):
        es, _, served = mixed_set
        es.make_bucket("dist")
        es.put_object("dist", "vf", payload(150000, seed=6))
        fi = es.head_object("dist", "vf")
        path = f"vf/{fi.data_dir}/part.1"
        ec = fi.erasure
        es.drives[2].verify_file("dist", path, ec.shard_size,
                                 ec.shard_file_size(fi.size), "mxh256")
        p = served[0]._file_path("dist", path)
        raw = bytearray(open(p, "rb").read())
        raw[-1] ^= 1
        open(p, "wb").write(bytes(raw))
        with pytest.raises(StorageError, match="mismatch"):
            es.drives[2].verify_file("dist", path, ec.shard_size,
                                     ec.shard_file_size(fi.size), "mxh256")

    def test_mixed_set_remote_drives_take_the_solo_path(self, tmp_path,
                                                        monkeypatch):
        """With the metadata lanes forced and zero-copy on, the local
        drives journal their publishes and stage by vectored writes,
        while the remote drives (no batched or vectored call on the wire)
        take solo write_metadata and append_file; the trees equal those
        of a run with the lanes and zero-copy off."""
        monkeypatch.setattr(port_es_mod, "new_uuid",
                            lambda: "00000003-aaaa-4bbb-8ccc-000000000003")
        monkeypatch.setattr(port_es_mod, "_now_ns",
                            lambda: 1_700_000_000_555_000_000)
        trees = {}
        for mode in ("lanes", "oracle"):
            monkeypatch.setenv("MTPU_METABATCH", "1" if mode == "lanes"
                               else "0")
            monkeypatch.setenv("MTPU_METABATCH_SOLO", "1")
            monkeypatch.setenv("MTPU_ZEROCOPY", "1" if mode == "lanes"
                               else "0")
            metalanes.reset()
            root = tmp_path / mode
            local = [LocalDrive(str(root / f"l{i}")) for i in range(2)]
            served = [LocalDrive(str(root / f"s{i}")) for i in range(2)]
            srv = RPCServer(TOKEN).start()
            calls: list[str] = []
            register_storage_rpc(srv, served, device="cpu")
            real = srv.router.handle

            def counting(path, auth, body, real=real):
                calls.append(path.rsplit("/", 1)[-1])
                return real(path, auth, body)
            srv.router.handle = counting
            cli = RPCClient(srv.endpoint, TOKEN)
            es = ErasureSet(local + [HealthWrappedDrive(RemoteDrive(cli, i))
                                     for i in range(2)],
                            default_parity=2, device="cpu")
            try:
                es.make_bucket("b")
                c0 = port_drive.stats()["meta_group_commits"]
                es.put_object("b", "small", payload(1000, seed=1))
                es.put_object("b", "big", payload(2_500_000, seed=2))
                commits = port_drive.stats()["meta_group_commits"] - c0
            finally:
                es.close()
                cli.close()
                srv.shutdown()
                metalanes.reset()
            if mode == "lanes":
                assert commits == 2          # the two local drives
            assert "write_metadata" in calls and "append_file" in calls
            assert "write_metadata_many" not in calls
            trees[mode] = [tree(str(root / n))
                           for n in ("l0", "l1", "s0", "s1")]
        assert trees["lanes"] == trees["oracle"]


class TestWireAcrossPackages:
    @pytest.mark.parametrize("direction", ["port-client-jax-server",
                                           "jax-client-port-server"])
    def test_storage_plane_both_ways(self, tmp_path, direction):
        from minio_tpu_torch.storage.xlmeta import FileInfo
        if direction == "port-client-jax-server":
            srv = jax_rest.RPCServer(TOKEN).start()
            jax_storage_rpc.register_storage_rpc(
                srv, [JaxLocalDrive(str(tmp_path / "srv"))])
            cli = RPCClient(srv.endpoint, TOKEN)
            remote = RemoteDrive(cli, 0)
            mk = FileInfo
        else:
            srv = RPCServer(TOKEN).start()
            register_storage_rpc(srv, [LocalDrive(str(tmp_path / "srv"))],
                                 device="cpu")
            cli = jax_rest.RPCClient(srv.endpoint, TOKEN)
            remote = jax_storage_rpc.RemoteDrive(cli, 0)
            mk = JaxFileInfo
        local = LocalDrive(str(tmp_path / "local"))
        try:
            for d, fi_cls in ((remote, mk), (local, FileInfo)):
                d.make_volume("x")
                d.write_all("x", "a/b.txt", b"hello")
                d.append_file("x", "stage/part.1", b"abc")
                d.append_file("x", "stage/part.1", np.frombuffer(
                    b"def", dtype=np.uint8))
                d.write_metadata("x", "obj", fi_cls(
                    volume="x", name="obj", version_id="",
                    mod_time_ns=1_700_000_000_000_000_000, size=3,
                    inline_data=b"xyz"))
            for call in (lambda d: d.list_volumes(),
                         lambda d: d.read_all("x", "a/b.txt"),
                         lambda d: d.read_file("x", "stage/part.1", 1, 4),
                         lambda d: d.file_size("x", "stage/part.1"),
                         lambda d: d.list_raw("x", "stage"),
                         lambda d: d.list_dir("x"),
                         lambda d: [n for n, _ in d.walk_dir("x")],
                         lambda d: d.read_version("x", "obj").to_obj(),
                         lambda d: d.stat_volume("x")["name"]):
                assert call(remote) == call(local)
            # Typed errors cross the wire by class name, into the
            # client's own package.
            for call in (lambda: remote.read_all("x", "nope"),
                         lambda: remote.read_version("x", "nope")):
                with pytest.raises(Exception) as ei:
                    call()
                assert type(ei.value).__name__ == "ErrFileNotFound"
        finally:
            cli.close()
            srv.shutdown()
        assert tree(str(tmp_path / "srv")) == tree(str(tmp_path / "local"))

    def test_port_remote_locker_against_the_jax_lock_plane(self):
        servers, clients = [], []
        for _ in range(3):
            srv = jax_rest.RPCServer(TOKEN).start()
            jax_lock_rpc.register_lock_rpc(srv, JaxLocalLocker())
            servers.append(srv)
            clients.append(RemoteLocker(RPCClient(srv.endpoint, TOKEN)))
        try:
            a, b = DRWMutex("b/o", clients), DRWMutex("b/o", clients)
            assert a.get_lock(timeout=2)
            assert not b.get_lock(timeout=0.3)
            a.unlock()
            assert b.get_rlock(timeout=2)
            assert clients[0].refresh("b/o", b.uid)
            b.unlock()
            servers[0].shutdown()
            m = DRWMutex("b/o", clients)
            assert m.get_lock(timeout=2)      # 2 of 3 lockers
            m.unlock()
        finally:
            for s in servers[1:]:
                s.shutdown()

    def test_jax_remote_locker_against_the_port_lock_plane(self):
        srv = RPCServer(TOKEN).start()
        locker = LocalLocker()
        register_lock_rpc(srv, locker)
        try:
            jr = jax_lock_rpc.RemoteLocker(
                jax_rest.RPCClient(srv.endpoint, TOKEN))
            assert jr.lock("b/o", "u1") and not jr.lock("b/o", "u2")
            assert locker.stats() == {"resources": 1, "write_locked": 1}
            assert jr.unlock("b/o", "u1") and jr.rlock("b/o", "u2")
        finally:
            srv.shutdown()


# -- peer plane ----------------------------------------------------------------

class TestPeerPlane:
    def test_notification_fan_out_reload(self):
        servers, clients, hits = [], [], []
        for i in range(3):
            reg = PeerRegistry()
            reg.on_reload("iam", lambda i=i: hits.append(i))
            srv = RPCServer(TOKEN).start()
            register_peer_rpc(srv, reg)
            servers.append(srv)
            clients.append(RPCClient(srv.endpoint, TOKEN))
        try:
            ns = NotificationSys(clients)
            assert ns.reload_subsystem("iam") == 3
            assert sorted(hits) == [0, 1, 2]
            assert ns.reload_subsystem("unknown") == 0
            assert all(i and "uptime_s" in i for i in ns.server_info())
        finally:
            for s in servers:
                s.shutdown()

    def test_fan_out_tolerates_dead_peer(self):
        reg = PeerRegistry()
        reg.on_reload("cfg", lambda: None)
        s1 = RPCServer(TOKEN).start()
        register_peer_rpc(s1, reg)
        s2 = RPCServer(TOKEN).start()
        register_peer_rpc(s2, PeerRegistry())
        c1, c2 = RPCClient(s1.endpoint, TOKEN), RPCClient(s2.endpoint, TOKEN)
        s2.shutdown()
        try:
            assert NotificationSys([c1, c2]).reload_subsystem("cfg") == 1
        finally:
            c2.close()
            s1.shutdown()

    @pytest.mark.parametrize("server_pkg", ["port", "jax"])
    def test_bootstrap_verify_detects_mismatch(self, server_pkg):
        if server_pkg == "port":
            srv = RPCServer(TOKEN).start()
            register_bootstrap_rpc(srv, {"deployment_id": "abc",
                                         "n_sets": 2})
        else:
            from minio_tpu.rpc.peer_rpc import register_bootstrap_rpc as jr
            srv = jax_rest.RPCServer(TOKEN).start()
            jr(srv, {"deployment_id": "abc", "n_sets": 2})
        cli = RPCClient(srv.endpoint, TOKEN)
        try:
            assert verify_cluster_config(
                [cli], {"deployment_id": "abc", "n_sets": 2}) == []
            bad = verify_cluster_config(
                [cli], {"deployment_id": "zzz", "n_sets": 2})
            assert len(bad) == 1 and not bad[0][1]["ok"]
        finally:
            srv.shutdown()


def test_sets_take_a_shared_nslock_and_a_preloaded_format(tmp_path,
                                                          lock_cluster):
    """ErasureSets with `nslock=` (one dsync map for every set) and
    `preloaded_format=` (the format a cluster boot loaded): the sets
    share the map, adopt the format's id without a second scan, and a
    write holds the dsync lock."""
    _, _, remote = lock_cluster
    drives = [LocalDrive(str(tmp_path / f"d{i}")) for i in range(8)]
    fmt = init_format_sets([drives[:4], drives[4:]])
    ns = NSLockMap(lockers=remote)
    calls = []
    real = LocalDrive.read_all

    def counting(self, vol, path):
        calls.append(path)
        return real(self, vol, path)
    LocalDrive.read_all = counting
    try:
        sets = ErasureSets(drives, 4, nslock=ns, preloaded_format=fmt,
                           device="cpu")
    finally:
        LocalDrive.read_all = real
    try:
        assert not [c for c in calls if c.endswith("format.json")]
        assert sets.deployment_id == fmt["id"]
        assert all(s.nslock is ns for s in sets.sets)
        sets.make_bucket("b")
        held = DRWMutex("b/o", remote)
        assert held.get_lock(timeout=2)
        with pytest.raises(LockLost):
            ns.acquire_timeout.timeout = lambda: 0.3
            sets.put_object("b", "o", b"blocked")
        held.unlock()
        sets.put_object("b", "o", b"now")
        assert sets.get_object("b", "o")[1] == b"now"
    finally:
        sets.close()


def test_mrf_journal_stays_on_a_local_drive(tmp_path):
    """A node whose pool begins with a peer's drive journals its MRF
    queue on its own first drive, not under the peer's URL."""
    from minio_tpu_torch.background import mrf
    served = [LocalDrive(str(tmp_path / f"s{i}")) for i in range(2)]
    local = [LocalDrive(str(tmp_path / f"l{i}")) for i in range(2)]
    srv = RPCServer(TOKEN).start()
    register_storage_rpc(srv, served, device="cpu")
    cli = RPCClient(srv.endpoint, TOKEN)
    sets = ErasureSets([RemoteDrive(cli, 0), RemoteDrive(cli, 1)] + local, 4,
                       device="cpu")
    try:
        path = mrf._pool_journal_path(sets)
        assert path.startswith(local[0].root + os.sep), path
    finally:
        sets.close()
        cli.close()
        srv.shutdown()
