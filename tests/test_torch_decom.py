"""The port's pool lifecycle (minio_tpu_torch: engine/pools.py's draining
and add_pool, background/decom.py, utils/crashpoints.py; device="cpu")
held to the JAX package.  Tolerance: byte-exact.

- The same deployment (seeded numpy bodies, pinned version ids and mod
  times, two pools of 4 drives) drained by each package leaves equal
  versions on the destination: ids, mod times, ETags, sizes, bytes,
  delete markers where they stood; pending multipart uploads complete
  under their old ids.
- Each package reads the other's journal, and resumes a drain the other
  was killed in.
- A simulated death at each of the four crash points resumes with no
  version lost or duplicated; MTPU_CRASH kills a real process (exit
  137) inside the mover, and the port resumes the drain.
- Pause, resume and cancel; draining the last pool is refused; reads of
  the latest version are latest-wins while a drain runs and a hard
  delete removes every copy; add_pool's checks.
- Across processes: an admin request recorded by a worker without the
  mover reaches the owner's mover (`request` / `reconcile`), and status
  reads from the journal alike everywhere.
"""

import functools
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import minio_tpu.background.decom as jax_decom
import minio_tpu.engine.erasure_set as jax_es_mod
import minio_tpu.storage.errors as jax_errors
import minio_tpu_torch.background.decom as decom
import minio_tpu_torch.engine.erasure_set as port_es_mod
import minio_tpu_torch.storage.errors as port_errors
from minio_tpu.engine.pools import ServerPools as JaxServerPools
from minio_tpu.engine.sets import ErasureSets as JaxErasureSets
from minio_tpu.storage.drive import LocalDrive as JaxLocalDrive
from minio_tpu_torch.engine.pools import ServerPools
from minio_tpu_torch.engine.sets import ErasureSets
from minio_tpu_torch.storage.drive import LocalDrive
from minio_tpu_torch.utils import crashpoints

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MIB = 1 << 20

JAX = SimpleNamespace(
    name="jax", LocalDrive=JaxLocalDrive, ErasureSets=JaxErasureSets,
    ServerPools=JaxServerPools, decom=jax_decom, errors=jax_errors,
    es_mod=jax_es_mod)
PORT = SimpleNamespace(
    name="port", LocalDrive=LocalDrive,
    ErasureSets=functools.partial(ErasureSets, device="cpu"),
    ServerPools=ServerPools, decom=decom, errors=port_errors,
    es_mod=port_es_mod)
IMPLS = [JAX, PORT]


def close(obj):
    for p in getattr(obj, "pools", [obj]):
        for es in p.sets:
            if isinstance(es, port_es_mod.ErasureSet):
                es.close()
            else:
                es.pool.shutdown(wait=True)
                es._iter_pool.shutdown(wait=True)


@pytest.fixture
def closing():
    made = []
    yield made.append
    for obj in made:
        close(obj)


def two_pools(impl, root, n=4, closing=None):
    p0 = impl.ErasureSets([impl.LocalDrive(f"{root}/p0-{i}")
                           for i in range(n)], set_drive_count=n)
    p1 = impl.ErasureSets([impl.LocalDrive(f"{root}/p1-{i}")
                           for i in range(n)], set_drive_count=n,
                          deployment_id=p0.deployment_id)
    pools = impl.ServerPools([p0, p1])
    if closing is not None:
        closing(pools)
    return pools


def force_free(pools, frees):
    for p, free in zip(pools.pools, frees):
        p.disk_usage = (lambda f: lambda: {"total": 1 << 40, "free": f})(
            free)


def pool_names(pool, bucket):
    names = set()
    for es in pool.sets:
        try:
            names.update(es.list_object_names(bucket))
        except Exception:  # noqa: BLE001 — either package's StorageError
            pass
    return names


def blob(seed, n):
    return np.random.default_rng(seed).bytes(n)


#: (key, version id, mod time, size, seed): three versions of one key,
#: a null-version object, a versioned one
VERSIONS = [("ver", "11111111-1111-4111-8111-111111111111", 1_700_000_001,
             20_000, 1),
            ("ver", "22222222-2222-4222-8222-222222222222", 1_700_000_002,
             20_001, 2),
            ("ver", "33333333-3333-4333-8333-333333333333", 1_700_000_003,
             300_000, 3),
            ("plain", "", 1_700_000_004, 150_000, 4),
            ("dir/deep", "44444444-4444-4444-8444-444444444444",
             1_700_000_005, 70_000, 5),
            ("gone", "55555555-5555-4555-8555-555555555555", 1_700_000_006,
             1_000, 6)]


def load(impl, pools, monkeypatch):
    """The seeded deployment on pool 0: pinned ids and times, a delete
    marker on `gone` (its id and time pinned through the engine's
    generators), a pending upload with one part."""
    pools.make_bucket("b")
    force_free(pools, [1000, 10])
    for key, vid, mt, size, seed in VERSIONS:
        pools.put_object("b", key, blob(seed, size),
                         versioned=bool(vid), version_id=vid or None,
                         mod_time_ns=mt * 10**9)
    monkeypatch.setattr(impl.es_mod, "new_uuid",
                        lambda: "66666666-6666-4666-8666-666666666666")
    monkeypatch.setattr(impl.es_mod, "_now_ns",
                        lambda: 1_700_000_007 * 10**9)
    pools.delete_object("b", "gone", versioned=True)
    monkeypatch.undo()
    uid = pools.new_multipart_upload("b", "mp")
    pools.put_object_part("b", "mp", uid, 1, blob(7, 5 * MIB))
    return uid


def versions(pools, key):
    return [(v.version_id, v.mod_time_ns, v.deleted, v.is_latest,
             v.size, v.metadata.get("etag", ""))
            for v in pools.list_object_versions("b", key)]


def test_same_drain_leaves_equal_versions_in_both_packages(
        tmp_path, closing, monkeypatch):
    got = {}
    for impl in IMPLS:
        pools = two_pools(impl, tmp_path / impl.name, closing=closing)
        uid = load(impl, pools, monkeypatch)
        before = {k: versions(pools, k) for k in ("ver", "plain",
                                                 "dir/deep", "gone")}
        force_free(pools, [1000, 10 ** 9])
        d = impl.decom.Decommissioner(pools, 0)
        d.run_sync()
        st = d.status()
        assert st["state"] == "complete", st
        assert pool_names(pools.pools[0], "b") == set()
        after = {k: versions(pools, k) for k in before}
        # Data versions keep id, time, size and ETag; the marker tip
        # stays a marker tip (a new one, minted on the destination).
        for k in ("ver", "plain", "dir/deep"):
            assert after[k] == before[k], (impl.name, k)
        assert [(v[2], v[3]) for v in after["gone"]] == \
            [(v[2], v[3]) for v in before["gone"]]
        bodies = {}
        for key, vid, _, size, seed in VERSIONS:
            _, data = pools.pools[1].get_object("b", key, version_id=vid)
            assert bytes(data) == blob(seed, size)
            bodies[(key, vid)] = bytes(data)
        # The client's old upload id follows its relocation.
        pools.put_object_part("b", "mp", uid, 2, b"tail" * 100)
        parts = pools.list_parts("b", "mp", uid)
        pools.complete_multipart_upload(
            "b", "mp", uid, [(p.number, p.etag) for p in parts])
        fi, data = pools.get_object("b", "mp")
        assert bytes(data) == blob(7, 5 * MIB) + b"tail" * 100
        got[impl.name] = ({k: after[k] for k in ("ver", "plain",
                                                 "dir/deep")},
                          bodies, fi.metadata.get("etag"),
                          {k: st[k] for k in ("versions_moved",
                                              "uploads_relocated",
                                              "objects_moved",
                                              "objects_total")})
    assert got["port"][:3] == got["jax"][:3]
    assert got["port"][3]["versions_moved"] == \
        got["jax"][3]["versions_moved"]
    assert got["port"][3]["uploads_relocated"] == 1


@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax_to_port", "port_to_jax"])
def test_each_package_reads_the_others_journal(tmp_path, closing,
                                               monkeypatch, writer, reader):
    pools = two_pools(writer, tmp_path, closing=closing)
    uid = load(writer, pools, monkeypatch)
    force_free(pools, [1000, 10 ** 9])
    writer.decom.Decommissioner(pools, 0).run_sync()
    close(pools)
    other = two_pools(reader, tmp_path, closing=closing)
    journals = reader.decom.find_journals(other)
    assert set(journals) == {0}
    assert str(tmp_path / "p1-0") in journals[0]
    folded = reader.decom.replay_journal(journals[0])
    mine = writer.decom.replay_journal(journals[0])
    assert folded == mine
    assert folded["state"] == "complete" and folded["moved"] == 7
    # The reader keeps the drained pool out and resolves the old id.
    force_free(other, [10 ** 9, 10])
    resumed = reader.decom.resume_decommissions(other, autostart=False)
    assert [d.state for d in resumed] == ["complete"]
    assert 0 in other.draining and other.get_pool_idx("b", "new") == 1
    assert other._split_upload_id(uid)[0] == 1


@pytest.mark.parametrize("killer,resumer", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax_killed_port_resumes",
                              "port_killed_jax_resumes"])
def test_a_drain_killed_in_one_package_resumes_in_the_other(
        tmp_path, closing, monkeypatch, killer, resumer):
    class FakeKill(BaseException):
        pass

    pools = two_pools(killer, tmp_path, closing=closing)
    load(killer, pools, monkeypatch)
    force_free(pools, [1000, 10 ** 9])
    hits = {"n": 0}

    def dying(point):
        if point == "decom.post_copy":
            hits["n"] += 1
            if hits["n"] == 3:
                raise FakeKill(point)
    monkeypatch.setattr(killer.decom, "crash_point", dying)
    with pytest.raises(FakeKill):
        killer.decom.Decommissioner(pools, 0).run_sync()
    monkeypatch.undo()
    close(pools)
    other = two_pools(resumer, tmp_path, closing=closing)
    force_free(other, [1000, 10 ** 9])
    (d,) = resumer.decom.resume_decommissions(other, autostart=False)
    assert d.state == "draining"
    d.run_sync()
    assert d.status()["state"] == "complete"
    assert pool_names(other.pools[0], "b") == set()
    for key, vid, _, size, seed in VERSIONS:
        _, data = other.get_object("b", key, version_id=vid)
        assert bytes(data) == blob(seed, size)
    assert len(other.list_object_versions("b", "ver")) == 3


@pytest.mark.parametrize("point", [p for p in crashpoints.POINTS
                                   if p.startswith("decom.")])
def test_death_at_each_crash_point_resumes_exactly_once(
        tmp_path, closing, monkeypatch, point):
    class FakeKill(BaseException):
        pass

    pools = two_pools(PORT, tmp_path, closing=closing)
    load(PORT, pools, monkeypatch)
    force_free(pools, [1000, 10 ** 9])
    hits = {"n": 0}

    def dying(name):
        if name == point:
            hits["n"] += 1
            if hits["n"] == 4:               # mid-drain, once
                raise FakeKill(name)
    monkeypatch.setattr(decom, "crash_point", dying)
    with pytest.raises(FakeKill):
        decom.Decommissioner(pools, 0).run_sync()
    monkeypatch.undo()
    close(pools)
    again = two_pools(PORT, tmp_path, closing=closing)
    force_free(again, [1000, 10 ** 9])
    (d,) = decom.resume_decommissions(again, autostart=False)
    assert d.state == "draining" and 0 in again.draining
    d.run_sync()
    assert d.status()["state"] == "complete", d.status()
    assert pool_names(again.pools[0], "b") == set()
    for key in ("ver", "plain", "dir/deep"):
        want = sorted(v for k, v, *_ in VERSIONS if k == key)
        assert sorted(v.version_id for v in
                      again.list_object_versions("b", key)) == want
    for key, vid, _, size, seed in VERSIONS:
        _, data = again.get_object("b", key, version_id=vid)
        assert bytes(data) == blob(seed, size)
    assert [v.deleted for v in again.list_object_versions("b", "gone")] \
        == [True, False]


def test_crashpoints_parse_arm_and_count():
    with pytest.raises(ValueError):
        crashpoints.arm("decom.pre_verify,meta.fsync")
    crashpoints.arm("decom.pre_delete:3")
    try:
        crashpoints.crash_point("decom.pre_delete")
        crashpoints.crash_point("decom.pre_delete")
        crashpoints.crash_point("decom.post_copy")
        assert crashpoints.hits == {"decom.pre_delete": 2}
    finally:
        crashpoints.reset()
    crashpoints.crash_point("decom.pre_delete")     # unarmed: nothing


def test_mtpu_crash_kills_the_mover_and_the_drain_resumes(tmp_path,
                                                          closing):
    """A real process drains with MTPU_CRASH=decom.pre_delete:3 and dies
    there with 137; the port resumes from the journal in this one."""
    script = (
        "import sys\n"
        "import numpy as np\n"
        "from minio_tpu_torch.background.decom import Decommissioner\n"
        "from minio_tpu_torch.engine.pools import ServerPools\n"
        "from minio_tpu_torch.engine.sets import ErasureSets\n"
        "from minio_tpu_torch.storage.drive import LocalDrive\n"
        "root = sys.argv[1]\n"
        "p0 = ErasureSets([LocalDrive(f'{root}/p0-{i}') for i in range(4)],"
        " set_drive_count=4, device='cpu')\n"
        "p1 = ErasureSets([LocalDrive(f'{root}/p1-{i}') for i in range(4)],"
        " set_drive_count=4, deployment_id=p0.deployment_id, device='cpu')\n"
        "pools = ServerPools([p1, p0])\n"     # pool 1 first: it holds all
        "pools.make_bucket('b')\n"
        "for i in range(6):\n"
        "    pools.put_object('b', f'o{i}', np.random.default_rng(i)"
        ".bytes(30000 + i))\n"
        "pools = ServerPools([p0, p1])\n"
        "Decommissioner(pools, 1).run_sync()\n"
        "print('survived')\n")
    env = dict(os.environ, MTPU_CRASH="decom.pre_delete:3",
               PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", script, str(tmp_path)],
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 137, res.stderr
    assert "MTPU_CRASH: dying at decom.pre_delete" in res.stderr
    pools = two_pools(PORT, tmp_path, closing=closing)
    (d,) = decom.resume_decommissions(pools, autostart=False)
    assert d.pool_idx == 1 and d.state == "draining"
    assert d.status()["versions_moved"] == 2
    d.run_sync()
    assert d.status()["state"] == "complete"
    assert pool_names(pools.pools[1], "b") == set()
    for i in range(6):
        assert len(pools.list_object_versions("b", f"o{i}")) == 1
        _, data = pools.get_object("b", f"o{i}")
        assert bytes(data) == blob(i, 30000 + i)


def test_pause_resume_cancel_and_the_last_pool(tmp_path, closing):
    pools = two_pools(PORT, tmp_path, closing=closing)
    pools.make_bucket("b")
    force_free(pools, [1000, 10])
    pools.put_object("b", "stay", b"data-stays")
    d = decom.Decommissioner(pools, 0)
    d.pause()
    d.start()                              # parked at its gate
    assert d.status()["state"] == "paused" and 0 in pools.draining
    with pytest.raises(ValueError):
        pools.set_draining(1, True)        # the last placement pool
    d.cancel()
    assert d.status()["state"] == "cancelled"
    assert 0 not in pools.draining
    pools.pools[0].head_object("b", "stay")     # nothing moved
    assert pools.get_pool_idx("b", "stay") == 0
    force_free(pools, [1000, 10 ** 9])
    d2 = decom.Decommissioner(pools, 0)    # the journal says cancelled
    assert d2.state == "cancelled"
    d2.start()                             # a new drain
    d2.pause()
    assert d2.state in ("paused", "complete")
    d2.resume()
    d2.join(timeout=60)
    assert d2.status()["state"] == "complete"
    assert pool_names(pools.pools[0], "b") == set()
    _, data = pools.get_object("b", "stay")
    assert bytes(data) == b"data-stays"


@pytest.mark.parametrize("impl", IMPLS, ids=lambda i: i.name)
def test_reads_are_latest_wins_while_a_drain_runs(tmp_path, closing, impl):
    pools = two_pools(impl, tmp_path, closing=closing)
    pools.make_bucket("b")
    force_free(pools, [10 ** 9, 10])
    pools.put_object("b", "k", b"old" * 1000)
    d = impl.decom.Decommissioner(pools, 0)
    d.pause()
    d.start()
    try:
        # The overwrite lands on pool 1; the stale copy on pool 0 comes
        # first in probe order and must not win.
        fi = pools.put_object("b", "k", b"new" * 1000)
        assert fi.pool_idx == 1
        assert bytes(pools.get_object("b", "k")[1]) == b"new" * 1000
        assert pools.head_object("b", "k").size == 3000
        _, it = pools.get_object_iter("b", "k")
        assert b"".join(bytes(c) for c in it) == b"new" * 1000
        # A hard delete removes every copy.
        pools.delete_object("b", "k")
        with pytest.raises(impl.errors.ErrObjectNotFound):
            pools.head_object("b", "k")
        for p in pools.pools:
            with pytest.raises(impl.errors.ErrObjectNotFound):
                p.head_object("b", "k")
    finally:
        d.cancel()


def test_add_pool_checks_and_joins(tmp_path, closing):
    pools = two_pools(PORT, tmp_path, closing=closing)
    pools.make_bucket("b")
    stranger = PORT.ErasureSets([LocalDrive(f"{tmp_path}/x-{i}")
                                 for i in range(4)], set_drive_count=4)
    closing(stranger)
    with pytest.raises(ValueError, match="deployment id"):
        pools.add_pool(stranger)
    p2 = PORT.ErasureSets([LocalDrive(f"{tmp_path}/p2-{i}")
                           for i in range(4)], set_drive_count=4,
                          deployment_id=pools.deployment_id)
    real = p2.sets[0].device
    p2.sets[0].device = torch.device("meta")
    with pytest.raises(ValueError, match="runs on meta"):
        pools.add_pool(p2)
    p2.sets[0].device = real
    assert pools.add_pool(p2) == 2
    assert p2.bucket_exists("b")
    assert p2.sets[0]._dirty_tracker is pools.dirty_tracker
    force_free(pools, [10, 10, 10 ** 9])
    assert pools.put_object("b", "n", b"expansion").pool_idx == 2
    pools.close()
    with pytest.raises(RuntimeError):
        p2.sets[0].pool.submit(lambda: None)


def test_a_workers_request_reaches_the_owners_mover(tmp_path, closing):
    """Two object layers over the same drives play two workers: the one
    without the mover records start, pause, resume in the journal; the
    owner's reconcile follows; both read the same status."""
    owner = two_pools(PORT, tmp_path, closing=closing)
    other = two_pools(PORT, tmp_path, closing=closing)
    owner.make_bucket("b")
    force_free(owner, [1000, 10])
    for i in range(5):
        owner.put_object("b", f"o{i}", blob(i, 20_000))
    for p in (owner, other):
        force_free(p, [1000, 10 ** 9])
    assert decom.request(other, 0, "pause") is None    # no drain yet
    st = decom.request(other, 0, "start")
    assert st["state"] == "draining" and 0 in other.draining
    decom.request(other, 0, "pause")
    assert decom.reconcile(owner) == ["pool 0: mover started (paused)"]
    d = owner.decommissions[0]
    assert d.alive() and d.state == "paused"
    assert decom.reconcile(owner) == []               # nothing new
    decom.request(other, 0, "resume")
    assert decom.reconcile(owner) == ["pool 0: resumed"]
    d.join(timeout=60)
    a = decom.pool_status(owner, 0)
    b = decom.pool_status(other, 0)
    assert a == b and a["state"] == "complete"
    assert a["versions_moved"] == 5 and a["objects_moved"] == 5
    assert pool_names(owner.pools[0], "b") == set()
    # Pool 0 stays out of placement: pool 1 is the last one.
    with pytest.raises(ValueError, match="last placement"):
        decom.request(other, 1, "start")


@pytest.mark.parametrize("impl", IMPLS, ids=lambda i: i.name)
def test_a_moved_version_keeps_its_parity(tmp_path, closing, impl):
    """The repaired fault: the port's mover writes each version at its
    own parity (MinIO keeps an object's storage class); the JAX mover
    writes the destination set's default (EC:2+2 on 4 drives)."""
    pools = two_pools(impl, tmp_path, closing=closing)
    pools.make_bucket("b")
    force_free(pools, [1000, 10])
    pools.put_object("b", "p1", blob(9, 300_000), parity=1)
    pools.put_object("b", "inl", blob(10, 9_000), parity=1)
    force_free(pools, [1000, 10 ** 9])
    impl.decom.Decommissioner(pools, 0).run_sync()
    want = 1 if impl is PORT else 2
    for key, size, seed in (("p1", 300_000, 9), ("inl", 9_000, 10)):
        fi = pools.pools[1].head_object("b", key)
        assert fi.erasure.parity_blocks == want, (impl.name, key)
        assert bytes(pools.get_object("b", key)[1]) == blob(seed, size)


POLICY = (b'{"Version": "2012-10-17", "Statement": [{"Effect": "Allow", '
          b'"Principal": "*", "Action": "s3:GetObject", '
          b'"Resource": "arn:aws:s3:::bkt/*"}]}')


def test_a_drain_carries_the_system_volume(tmp_path, closing):
    """The repaired fault: bucket configs and IAM are objects of the
    system volume, which the JAX mover does not walk; the port's moves
    them, so a reboot on the other pool alone keeps them.  Per-drive
    files of the volume (the drain's journal, the metacache) stay."""
    from minio_tpu_torch.iam.iam import IAMSys
    from minio_tpu_torch.server.handlers import S3Handlers

    p0 = PORT.ErasureSets([LocalDrive(f"{tmp_path}/p0-{i}")
                           for i in range(4)], set_drive_count=4)
    pools = ServerPools([p0])
    closing(pools)
    h = S3Handlers(pools)
    h.make_bucket("bkt")
    h.put_bucket_versioning(
        "bkt", b"<VersioningConfiguration><Status>Enabled</Status>"
             b"</VersioningConfiguration>")
    h.put_bucket_config("bkt", "policy", POLICY)
    IAMSys(pools).add_user("drainuser", "drainuser-secret")
    pools.put_object("bkt", "obj", blob(11, 40_000), versioned=True)
    p1 = PORT.ErasureSets([LocalDrive(f"{tmp_path}/p1-{i}")
                           for i in range(4)], set_drive_count=4,
                          deployment_id=pools.deployment_id)
    pools.add_pool(p1)
    d = decom.Decommissioner(pools, 0)
    d.run_sync()
    assert d.status()["state"] == "complete"
    assert pool_names(p0, ".mtpu.sys") == set()
    moved = pool_names(p1, ".mtpu.sys")
    assert {"buckets/bkt/versioning.xml", "buckets/bkt/policy.json",
            "config/iam/users/drainuser.json"} <= moved, moved
    journal = decom.default_journal_path(pools, 0)
    assert os.path.dirname(journal).startswith(f"{tmp_path}/p1-0")
    pools.close()

    # Reboot on pool 1 alone.
    again = ServerPools([PORT.ErasureSets(
        [LocalDrive(f"{tmp_path}/p1-{i}") for i in range(4)],
        set_drive_count=4)])
    closing(again)
    h2 = S3Handlers(again)
    assert h2.bucket_versioning_enabled("bkt")
    assert h2.get_bucket_config("bkt", "policy").body == POLICY
    ident = IAMSys(again).lookup("drainuser")
    assert ident is not None and ident.secret_key == "drainuser-secret"
    assert bytes(again.get_object("bkt", "obj")[1]) == blob(11, 40_000)


def test_retention_does_not_hold_a_version_in_a_drain_or_a_heal(
        tmp_path, closing):
    """A version under COMPLIANCE retention is moved by the mover and
    rewritten by heal: only a client's DELETE is refused (the handler's
    check), never the engine's own moves."""
    from minio_tpu_torch.engine import heal as H
    from minio_tpu_torch.server.api_errors import S3Error
    from minio_tpu_torch.server.handlers import S3Handlers

    pools = two_pools(PORT, tmp_path, closing=closing)
    h = S3Handlers(pools)
    force_free(pools, [1000, 10])
    h.make_bucket("worm")
    h.put_bucket_config("worm", "object-lock", (
        b"<ObjectLockConfiguration><ObjectLockEnabled>Enabled"
        b"</ObjectLockEnabled><Rule><DefaultRetention><Mode>COMPLIANCE"
        b"</Mode><Days>30</Days></DefaultRetention></Rule>"
        b"</ObjectLockConfiguration>"))
    h.put_object("worm", "doc", blob(12, 200_000), {})
    fi = pools.head_object("worm", "doc")
    assert fi.metadata["x-amz-object-lock-mode"] == "COMPLIANCE"
    with pytest.raises(S3Error, match="compliance"):
        h.delete_object("worm", "doc", {})
    force_free(pools, [1000, 10 ** 9])
    decom.Decommissioner(pools, 0).run_sync()
    assert pool_names(pools.pools[0], "worm") == set()
    moved = pools.pools[1].head_object("worm", "doc")
    assert moved.metadata["x-amz-object-lock-mode"] == "COMPLIANCE"
    # Heal rewrites the locked version's xl.meta and shards on a drive
    # that lost them.
    es = pools.pools[1].sets[0]
    import shutil
    shutil.rmtree(os.path.join(es.drives[0].root, "worm", "doc"))
    res = H.heal_object(es, "worm", "doc")
    assert any(r.healed_drives for r in res)
    assert os.path.exists(os.path.join(es.drives[0].root, "worm", "doc",
                                       "xl.meta"))
    assert bytes(pools.get_object("worm", "doc")[1]) == blob(12, 200_000)


def test_a_reap_cut_short_between_drives_resumes(tmp_path, closing,
                                                 monkeypatch):
    """The mover killed between the drives of a source version's reap
    (after the destination's copy was verified) leaves that version on
    1 of 4 drives, below read quorum: the resumed drain removes the
    remnant, whose copy is on pool 1, and completes.  Before, the
    resume's version listing failed the drain on ErrErasureReadQuorum
    (the worker-pool lifecycle test met it under load)."""
    class FakeKill(BaseException):
        pass

    pools = two_pools(PORT, tmp_path, closing=closing)
    load(PORT, pools, monkeypatch)
    force_free(pools, [1000, 10 ** 9])
    real = decom.Decommissioner._reap_source

    def cut_reap(self, bucket, obj, vid):
        if obj != "dir/deep":
            return real(self, bucket, obj, vid)
        for d in self._src().set_for(obj).drives[:3]:
            d.delete_version(bucket, obj, vid)
        raise FakeKill(obj)
    monkeypatch.setattr(decom.Decommissioner, "_reap_source", cut_reap)
    with pytest.raises(FakeKill):
        decom.Decommissioner(pools, 0).run_sync()
    monkeypatch.undo()
    close(pools)
    again = two_pools(PORT, tmp_path, closing=closing)
    force_free(again, [1000, 10 ** 9])
    src = again.pools[0].set_for("dir/deep")
    left = [d for d in src.drives if os.path.exists(os.path.join(
        d.root, "b", "dir", "deep", "xl.meta"))]
    assert len(left) == 1
    (d,) = decom.resume_decommissions(again, autostart=False)
    d.run_sync()
    assert d.status()["state"] == "complete", d.status()
    assert pool_names(again.pools[0], "b") == set()
    assert not os.path.exists(os.path.join(left[0].root, "b", "dir", "deep",
                                           "xl.meta"))
    vid = "44444444-4444-4444-8444-444444444444"
    fi, data = again.get_object("b", "dir/deep", version_id=vid)
    assert bytes(data) == blob(5, 70_000)
    assert fi.mod_time_ns == 1_700_000_005 * 10**9
