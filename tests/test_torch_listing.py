"""The port's listings and version histories (minio_tpu_torch: the
metacache, ErasureSet's listings, versioned DELETE with delete markers,
delete_bucket and update_object_metadata; device="cpu") held to the JAX
package on the same drives.  Tolerance: byte-exact.  Listing pages,
markers and delete-marker hiding, version histories with a stale drive,
the persisted metacache segments and every xl.meta after a versioned
DELETE or a metadata update equal the JAX package's; the metacache cases
of tests/test_config_metacache.py run against both packages."""

import functools
import os
import shutil
import threading
from types import SimpleNamespace

import numpy as np
import pytest

import minio_tpu.engine.erasure_set as jax_es_mod
import minio_tpu.engine.metacache as jax_mc
import minio_tpu.storage.errors as jax_errors
import minio_tpu_torch.engine.erasure_set as port_es_mod
import minio_tpu_torch.engine.metacache as port_mc
import minio_tpu_torch.storage.errors as port_errors
from minio_tpu.engine.pools import ServerPools as JaxServerPools
from minio_tpu.engine.sets import ErasureSets as JaxErasureSets
from minio_tpu.storage.drive import LocalDrive as JaxLocalDrive
from minio_tpu.storage.xlmeta import ErasureInfo as JaxErasureInfo
from minio_tpu.storage.xlmeta import FileInfo as JaxFileInfo
from minio_tpu_torch.engine.pools import ServerPools
from minio_tpu_torch.engine.sets import ErasureSets
from minio_tpu_torch.storage.drive import SYS_VOL, LocalDrive
from minio_tpu_torch.storage.xlmeta import FileInfo

JAX = SimpleNamespace(
    name="jax", LocalDrive=JaxLocalDrive, ErasureSet=jax_es_mod.ErasureSet,
    ErasureSets=JaxErasureSets, ServerPools=JaxServerPools, mc=jax_mc,
    errors=jax_errors, FileInfo=JaxFileInfo, es_mod=jax_es_mod)
PORT = SimpleNamespace(
    name="port", LocalDrive=LocalDrive,
    ErasureSet=functools.partial(port_es_mod.ErasureSet, device="cpu"),
    ErasureSets=functools.partial(ErasureSets, device="cpu"),
    ServerPools=ServerPools, mc=port_mc,
    errors=port_errors, FileInfo=FileInfo, es_mod=port_es_mod)
IMPLS = [JAX, PORT]
MIB = 1 << 20


def close(obj):
    """Stop the executors of a ServerPools, ErasureSets or ErasureSet of
    either package (the JAX package's sets have no close())."""
    pools = getattr(obj, "pools", [obj])
    for p in pools:
        for es in getattr(p, "sets", [p]):
            if isinstance(es, port_es_mod.ErasureSet):
                es.close()
            else:
                es.pool.shutdown(wait=True)
                es._iter_pool.shutdown(wait=True)


@pytest.fixture(autouse=True)
def no_executor_threads_left():
    """No executor thread a test starts outlives it."""
    def executors():
        return {t for t in threading.enumerate()
                if t.name.startswith("ThreadPoolExecutor")}
    before = executors()
    yield
    assert not executors() - before


@pytest.fixture
def closing():
    """Register objects to close at teardown."""
    made = []
    yield made.append
    for obj in made:
        close(obj)


def body_of(size, seed=0):
    return np.random.default_rng(seed).integers(0, 256, size,
                                                dtype=np.uint8).tobytes()


def pools_on(impl, root, n_drives=8, set_drive_count=4, parity=None):
    drives = [impl.LocalDrive(str(root / f"d{i}")) for i in range(n_drives)]
    return impl.ServerPools([impl.ErasureSets(
        drives, set_drive_count=set_drive_count, default_parity=parity)])


def tree(root, skip_metacache=True):
    """(relpath -> bytes) of every file under a deployment, without the
    staging area (and the metacache)."""
    out = {}
    for dirpath, _, files in os.walk(root):
        rel_dir = os.path.relpath(dirpath, root)
        parts = rel_dir.split(os.sep)
        if SYS_VOL in parts and (
                parts[parts.index(SYS_VOL) + 1:][:1] == ["tmp"]
                or (skip_metacache and parts[parts.index(SYS_VOL) + 1:][:1]
                    == ["metacache"])):
            continue
        for f in files:
            with open(os.path.join(dirpath, f), "rb") as fh:
                out[os.path.normpath(os.path.join(rel_dir, f))] = fh.read()
    return out


def row(fi):
    return (fi.name, fi.version_id, fi.size, fi.mod_time_ns, fi.deleted,
            fi.metadata.get("etag", ""), fi.is_latest)


def all_pages(pools, bucket, page, prefix=""):
    """Every page of a marker-paged listing, as rows."""
    pages, marker = [], ""
    while True:
        got = pools.list_objects(bucket, prefix, marker=marker,
                                 max_keys=page)
        if not got:
            return pages
        pages.append([row(fi)[:4] for fi in got])
        marker = got[-1].name


# -- the drive's bounded walk ----------------------------------------------------

TRICKY = ["x/y", "x!a", "x.txt", "x/z/deep", "w", "x0", "x/z!", "a b/c",
          "x/y0"]


@pytest.mark.parametrize("limit", [1, 2, 3, 100])
def test_walk_page_equal_on_tricky_names(tmp_path, limit):
    """Both packages' walk_page give the same pages, in lexical order,
    for names that sort around '/', from every resume marker."""
    d = LocalDrive(str(tmp_path / "ord"))
    jd = JaxLocalDrive(str(tmp_path / "ord"))
    d.make_volume("ob")
    for n in TRICKY:
        d.write_metadata("ob", n, FileInfo(volume="ob", name=n, size=1,
                                           mod_time_ns=1, metadata={},
                                           inline_data=b"i"))
    for after in [""] + sorted(TRICKY):
        assert d.walk_page("ob", after=after, limit=limit) == \
            jd.walk_page("ob", after=after, limit=limit)
    collected, after = [], ""
    while True:
        page, eof = d.walk_page("ob", after=after, limit=limit)
        collected += [n for n, _ in page]
        if eof:
            break
        after = page[-1][0]
    assert collected == sorted(TRICKY)
    for prefix in ("x", "x/", "x/z", "a b/", "nope"):
        assert d.walk_page("ob", prefix=prefix, limit=limit) == \
            jd.walk_page("ob", prefix=prefix, limit=limit)


# -- the metacache cases of tests/test_config_metacache.py, both packages --------

@pytest.fixture(params=IMPLS, ids=lambda i: i.name)
def impl(request):
    return request.param


class TestMetacacheBothPackages:
    def test_cache_avoids_rewalk(self, impl, tmp_path, closing):
        pools = pools_on(impl, tmp_path, 4)
        closing(pools)
        pools.make_bucket("mcb")
        es = pools.pools[0].sets[0]
        for i in range(5):
            pools.put_object("mcb", f"k{i}", b"x")
        es.metacache.walks = 0
        a = es.list_objects("mcb")
        assert len(a) == 5
        walks = es.metacache.walks
        assert [fi.name for fi in es.list_objects("mcb")] == \
            [fi.name for fi in a]
        assert es.metacache.walks == walks        # served cached

    def test_write_invalidates(self, impl, tmp_path, closing):
        """PUT, DELETE, a delete marker, a metadata update, multipart
        completion and heal each invalidate the cached listing."""
        pools = pools_on(impl, tmp_path, 4)
        closing(pools)
        pools.make_bucket("mib")
        es = pools.pools[0].sets[0]

        def names():
            return [fi.name for fi in es.list_objects("mib")]

        pools.put_object("mib", "a", b"1")
        assert names() == ["a"]
        pools.put_object("mib", "b", b"2")
        assert names() == ["a", "b"]
        pools.delete_object("mib", "a")
        assert names() == ["b"]
        pools.put_object("mib", "v", b"3", versioned=True)
        assert names() == ["b", "v"]
        pools.delete_object("mib", "v", versioned=True)
        assert names() == ["b"]
        fi = pools.head_object("mib", "b")
        fi.metadata["x-amz-meta-k"] = "1"
        pools.update_object_metadata("mib", "b", fi)
        assert es.list_objects("mib")[0].metadata["x-amz-meta-k"] == "1"
        uid = pools.new_multipart_upload("mib", "mp")
        part = pools.put_object_part("mib", "mp", uid, 1, b"p" * 100)
        pools.complete_multipart_upload("mib", "mp", uid, [(1, part.etag)])
        assert names() == ["b", "mp"]
        gen = es.metacache._generation("mib")
        shutil.rmtree(os.path.join(es.drives[1].root, "mib", "b"))
        pools.heal_object("mib", "b")
        assert es.metacache._generation("mib") == gen + 1

    def test_marker_pagination(self, impl, tmp_path, closing):
        pools = pools_on(impl, tmp_path, 4)
        closing(pools)
        pools.make_bucket("mpb")
        for i in range(6):
            pools.put_object("mpb", f"k{i}", b"x")
        es = pools.pools[0].sets[0]
        page1 = es.list_objects("mpb", max_keys=3)
        assert [fi.name for fi in page1] == ["k0", "k1", "k2"]
        page2 = es.list_objects("mpb", marker="k2", max_keys=3)
        assert [fi.name for fi in page2] == ["k3", "k4", "k5"]

    def test_persisted_cache_survives_new_metacache(self, impl, tmp_path,
                                                    closing):
        pools = pools_on(impl, tmp_path, 4)
        closing(pools)
        pools.make_bucket("pb")
        pools.put_object("pb", "x", b"1")
        es = pools.pools[0].sets[0]
        es.list_objects("pb")                     # walk + persist
        fresh = impl.mc.Metacache(es)             # a restart
        assert [fi.name for fi in fresh.list("pb")] == ["x"]
        assert fresh.walks == 0                   # from the drives' cache

    def test_streamed_paging_bounded(self, impl, tmp_path, monkeypatch,
                                     closing):
        """Small pages of a bucket extend the walk one persisted segment
        at a time; later pages and a restart reuse the segments."""
        monkeypatch.setattr(impl.mc, "SEG_ENTRIES", 50)
        monkeypatch.setattr(impl.mc, "WALK_PAGE", 20)
        drives = [impl.LocalDrive(str(tmp_path / f"bm{i}"))
                  for i in range(2)]
        es = impl.ErasureSet(drives)
        closing(es)
        es.make_bucket("big")
        for i in range(300):
            fi = impl.FileInfo(volume="big", name=f"o{i:05d}", size=1,
                               mod_time_ns=1, metadata={"etag": "e"},
                               inline_data=b"x")
            for d in drives:
                d.write_metadata("big", fi.name, fi)
        cache = es.metacache
        cache.streamed_entries = 0
        page1 = cache.list("big", max_keys=100)
        assert len(page1) == 100 and page1[0].name == "o00000"
        assert cache.streamed_entries <= 160, cache.streamed_entries
        page2 = cache.list("big", marker=page1[-1].name, max_keys=100)
        page3 = cache.list("big", marker=page2[-1].name, max_keys=100)
        assert [fi.name for fi in page1 + page2 + page3] == \
            [f"o{i:05d}" for i in range(300)]
        assert cache.streamed_entries <= 310
        fresh = impl.mc.Metacache(es)
        mid = fresh.list("big", marker="o00100", max_keys=50)
        assert [fi.name for fi in mid] == \
            [f"o{i:05d}" for i in range(101, 151)]
        assert fresh.walks == 0 and fresh.streamed_entries == 0

    def test_listing_quorum_knob(self, impl, tmp_path, monkeypatch,
                                 closing):
        drives = [impl.LocalDrive(str(tmp_path / f"lq{i}"))
                  for i in range(4)]
        es = impl.ErasureSet(drives)
        closing(es)
        es.make_bucket("qb")
        es.put_object("qb", "obj", b"d" * 1000)
        monkeypatch.setenv("MTPU_LIST_ASK", "strict")
        assert impl.mc._ask_count(4) == 4
        monkeypatch.setenv("MTPU_LIST_ASK", "2")
        assert impl.mc._ask_count(4) == 2
        assert [fi.name for fi in es.list_objects("qb")] == ["obj"]
        monkeypatch.delenv("MTPU_LIST_ASK")
        assert impl.mc._ask_count(4) == 3

    def test_degraded_walk_not_cached_as_complete(self, impl, tmp_path,
                                                  closing):
        drives = [impl.LocalDrive(str(tmp_path / f"dg{i}"))
                  for i in range(4)]
        es = impl.ErasureSet(drives)
        closing(es)
        es.make_bucket("db")
        for i in range(5):
            es.put_object("db", f"k{i}", b"x" * 300)

        class FlakyDrive:
            def __init__(self, inner):
                self._inner = inner

            def __getattr__(self, name):
                return getattr(self._inner, name)

            def walk_page(self, *a, **k):
                raise impl.errors.StorageError("flaky")

        es.drives[0] = FlakyDrive(es.drives[0])
        es.metacache.bump("db")
        assert [fi.name for fi in es.list_objects("db")] == \
            [f"k{i}" for i in range(5)]
        state = es.metacache._state_for("db", "",
                                        es.metacache._generation("db"))
        assert not state["done"] and not state["segs"]
        es.drives = [FlakyDrive(d) for d in drives]
        es.metacache.bump("db")
        with pytest.raises(impl.errors.StorageError):
            es.metacache.list("db")

    def test_lost_segment_replaced_and_served(self, impl, tmp_path,
                                              monkeypatch, closing):
        monkeypatch.setattr(impl.mc, "SEG_ENTRIES", 10)
        drives = [impl.LocalDrive(str(tmp_path / f"ls{i}"))
                  for i in range(2)]
        es = impl.ErasureSet(drives)
        closing(es)
        es.make_bucket("lb")
        for i in range(35):
            fi = impl.FileInfo(volume="lb", name=f"o{i:03d}", size=1,
                               mod_time_ns=1, metadata={},
                               inline_data=b"x")
            for d in drives:
                d.write_metadata("lb", fi.name, fi)
        cache = es.metacache
        assert len(cache.list("lb", max_keys=100)) == 35
        state = cache._state_for("lb", "", cache._generation("lb"))
        assert len(state["segs"]) >= 3
        base = cache._base_path("lb", "")
        for d in drives:
            d.delete(SYS_VOL, f"{base}/1.seg")
        cache._seg_cache = None
        assert [fi.name for fi in cache.list("lb", max_keys=100)] == \
            [f"o{i:03d}" for i in range(35)]


# -- one deployment, listed by both packages -------------------------------------

NAMES = ([f"k{i:03d}" for i in range(40)]
         + ["dir/a", "dir/b/c", "dir!x", "dir.txt", "z z", "dir/b0"])


def write_deployment(pools):
    """A versioned bucket: inline and multi-block objects, second
    versions, delete markers, a version deleted by id; and an
    unversioned bucket.  Returns {name: latest body} of live objects."""
    pools.make_bucket("v")
    pools.make_bucket("u")
    live = {}
    for i, name in enumerate(NAMES):
        size = 2 * MIB + 5 if i % 17 == 3 else 1000 + 37 * i
        body = body_of(size, seed=i)
        pools.put_object("v", name, body, versioned=True)
        live[name] = body
    for i, name in enumerate(NAMES):
        if i % 5 == 1:                          # a second version
            body = body_of(500 + i, seed=1000 + i)
            pools.put_object("v", name, body, versioned=True)
            live[name] = body
        elif i % 5 == 2:                        # a delete marker
            pools.delete_object("v", name, versioned=True)
            del live[name]
    first = pools.list_object_versions("v", NAMES[6])[-1]
    pools.delete_object("v", NAMES[6], version_id=first.version_id)
    for i in range(5):
        pools.put_object("u", f"u{i}", body_of(100 + i, seed=i))
    pools.delete_object("u", "u2")
    return live


@pytest.mark.parametrize("writer", IMPLS, ids=["jax-writes", "port-writes"])
def test_listings_equal_across_packages(writer, tmp_path, closing):
    """A deployment one package wrote, copied twice and listed by each:
    equal pages under every page size and prefix, equal version
    histories, delete-marked names hidden, equal persisted segments, and
    every live object read back byte-exact by the port."""
    pools = pools_on(writer, tmp_path / "w")
    closing(pools)
    live = write_deployment(pools)
    close(pools)
    shutil.copytree(tmp_path / "w", tmp_path / "jax")
    shutil.copytree(tmp_path / "w", tmp_path / "port")
    jp = pools_on(JAX, tmp_path / "jax")
    closing(jp)
    pp = pools_on(PORT, tmp_path / "port")
    closing(pp)
    for page in (3, 7, 1000):
        for prefix in ("", "dir", "dir/", "k01"):
            assert all_pages(pp, "v", page, prefix) == \
                all_pages(jp, "v", page, prefix), (page, prefix)
    listed = [fi.name for fi in pp.list_objects("v")]
    assert listed == sorted(live)
    assert [row(fi) for fi in pp.list_objects("u")] == \
        [row(fi) for fi in jp.list_objects("u")]
    assert [fi.name for fi in pp.list_objects("u")] == \
        ["u0", "u1", "u3", "u4"]
    assert pp.list_object_names("v") == jp.list_object_names("v") == \
        sorted(NAMES)
    for name in NAMES:
        assert [row(fi) for fi in pp.list_object_versions("v", name)] == \
            [row(fi) for fi in jp.list_object_versions("v", name)], name
    for name, body in live.items():
        assert bytes(pp.get_object("v", name)[1]) == body
    # The persisted segments are the same bytes (the index carries a
    # timestamp and is not compared).
    segs = {k: v for k, v in tree(tmp_path / "port", False).items()
            if k.endswith(".seg")}
    assert segs and segs == {k: v for k, v in tree(
        tmp_path / "jax", False).items() if k.endswith(".seg")}


def test_port_serves_the_jax_persisted_listing(tmp_path, closing):
    """A listing the JAX package walked and persisted is served from the
    drives by a port that starts after it, without a walk."""
    jp = pools_on(JAX, tmp_path, 4)
    closing(jp)
    jp.make_bucket("pb")
    for i in range(12):
        jp.put_object("pb", f"n{i:02d}", b"x" * i)
    want = [row(fi)[:4] for fi in jp.list_objects("pb")]
    pp = pools_on(PORT, tmp_path, 4)
    closing(pp)
    es = pp.pools[0].sets[0]
    got = es.metacache.list("pb")
    assert [row(fi)[:4] for fi in got] == want
    assert es.metacache.walks == 0


# -- version histories with a stale drive ----------------------------------------

@pytest.mark.parametrize("n,parity", [(4, 2), (6, 2)], ids=["ec2+2", "ec4+2"])
def test_versions_equal_with_stale_drive(tmp_path, n, parity, closing):
    """One drive missed the newest version and the delete marker, and
    holds a version no other drive has: both packages elect the same
    history, without the stray version."""
    drives = [JaxLocalDrive(str(tmp_path / f"d{i}")) for i in range(n)]
    es = jax_es_mod.ErasureSet(drives, default_parity=parity)
    closing(es)
    es.make_bucket("b")
    es.put_object("b", "o", body_of(300, 1), versioned=True)
    es.put_object("b", "o", body_of(2 * MIB + 1, 2), versioned=True)
    es.drives[0] = None
    es.put_object("b", "o", body_of(900, 3), versioned=True)
    es.delete_object("b", "o", versioned=True)
    es.drives[0] = drives[0]
    # The stray version claims a geometry of one data block: were it
    # trusted to set the read quorum, it would elect itself.
    stray = JaxFileInfo(volume="b", name="o", version_id="0" * 8 + "-1111"
                        "-2222-3333-" + "4" * 12, mod_time_ns=1 << 62,
                        size=5, metadata={"etag": "e"}, inline_data=b"x",
                        erasure=JaxErasureInfo(
                            data_blocks=1, parity_blocks=n - 1,
                            block_size=MIB, index=1,
                            distribution=list(range(1, n + 1))))
    drives[0].write_metadata("b", "o", stray)
    want = [row(fi) for fi in es.list_object_versions("b", "o")]
    assert len(want) == 4 and stray.version_id not in [w[1] for w in want]
    port = port_es_mod.ErasureSet(
        [LocalDrive(str(tmp_path / f"d{i}")) for i in range(n)],
        default_parity=parity, device="cpu")
    closing(port)
    assert [row(fi) for fi in port.list_object_versions("b", "o")] == want
    # Below quorum: both refuse.
    for i in range(n // 2 + 1):
        port.drives[i] = None
        es.drives[i] = None
    with pytest.raises(port_errors.ErrErasureReadQuorum):
        port.list_object_versions("b", "o")
    with pytest.raises(jax_errors.ErrErasureReadQuorum):
        es.list_object_versions("b", "o")


# -- xl.meta after versioned DELETE and metadata update --------------------------

def pin_identity(monkeypatch):
    """The same delete-marker id and time in both packages."""
    for mod in (jax_es_mod, port_es_mod):
        monkeypatch.setattr(mod, "new_uuid",
                            lambda: "00000001-aaaa-4bbb-8ccc-000000000001")
        monkeypatch.setattr(mod, "_now_ns", lambda: 1_700_000_000_123_456_789)


OPS = ["marker", "marker-on-absent", "delete-version", "delete-null",
       "metadata-inline", "metadata-blocks"]


@pytest.mark.parametrize("op", OPS)
def test_xlmeta_bytes_equal_after_mutation(op, tmp_path, monkeypatch,
                                           closing):
    """The same mutation of a JAX-written set, made by each package on
    its own copy, leaves every file of every drive byte-equal."""
    n, parity = 6, 2
    drives = [JaxLocalDrive(str(tmp_path / "w" / f"d{i}"))
              for i in range(n)]
    es = jax_es_mod.ErasureSet(drives, default_parity=parity)
    closing(es)
    es.make_bucket("b")
    small = es.put_object("b", "small", body_of(3000, 1), versioned=True)
    es.put_object("b", "big", body_of(2 * MIB + 3, 2), versioned=True)
    es.put_object("b", "big", body_of(5000, 3), versioned=True)
    es.put_object("b", "plain", body_of(70, 4))
    close(es)
    for side in ("jax", "port"):
        shutil.copytree(tmp_path / "w", tmp_path / side)
    pin_identity(monkeypatch)
    sets = {
        "jax": jax_es_mod.ErasureSet(
            [JaxLocalDrive(str(tmp_path / "jax" / f"d{i}"))
             for i in range(n)], default_parity=parity),
        "port": port_es_mod.ErasureSet(
            [LocalDrive(str(tmp_path / "port" / f"d{i}"))
             for i in range(n)], default_parity=parity, device="cpu")}
    results = {}
    for side, s in sets.items():
        closing(s)
        if op == "marker":
            dm = s.delete_object("b", "big", versioned=True)
            results[side] = (dm.deleted, dm.version_id, dm.mod_time_ns)
        elif op == "marker-on-absent":
            dm = s.delete_object("b", "never", versioned=True)
            results[side] = (dm.deleted, dm.version_id)
        elif op == "delete-version":
            results[side] = s.delete_object("b", "small",
                                            version_id=small.version_id)
        elif op == "delete-null":
            results[side] = s.delete_object("b", "plain")
        else:
            name = "small" if op == "metadata-inline" else "big"
            fi = s.head_object("b", name)
            fi.metadata["x-amz-meta-color"] = "blue"
            fi.metadata["content-type"] = "text/plain"
            s.update_object_metadata("b", name, fi)
            results[side] = s.head_object("b", name).metadata
    assert results["port"] == results["jax"]
    assert tree(tmp_path / "port") == tree(tmp_path / "jax")
    if op.startswith("metadata"):
        name = "small" if op == "metadata-inline" else "big"
        assert bytes(sets["port"].get_object("b", name)[1]) == \
            bytes(sets["jax"].get_object("b", name)[1])


def test_marker_hides_object_and_errors_match(tmp_path, closing):
    """After a delete marker GET and HEAD say not found, a read by
    version id still works, and deleting an absent version names the
    same error in both packages."""
    pp = pools_on(PORT, tmp_path, 4)
    closing(pp)
    pp.make_bucket("b")
    fi = pp.put_object("b", "o", b"payload", versioned=True)
    dm = pp.delete_object("b", "o", versioned=True)
    assert dm.deleted and dm.version_id != fi.version_id
    with pytest.raises(port_errors.ErrObjectNotFound):
        pp.get_object("b", "o")
    with pytest.raises(port_errors.ErrObjectNotFound):
        pp.head_object("b", "o")
    assert bytes(pp.get_object("b", "o", version_id=fi.version_id)[1]) == \
        b"payload"
    assert pp.head_object("b", "o", version_id=dm.version_id).deleted
    jp = pools_on(JAX, tmp_path, 4)
    closing(jp)
    names = {}
    for side, pools in (("port", pp), ("jax", jp)):
        for call in (lambda: pools.delete_object(
                         "b", "o", version_id="00000000-0000-4000-8000-"
                         "000000000000"),
                     lambda: pools.delete_object("b", "absent"),
                     lambda: pools.get_object("b", "o", version_id="00000000"
                                              "-0000-4000-8000-000000000000")):
            with pytest.raises(Exception) as err:
                call()
            names.setdefault(side, []).append(type(err.value).__name__)
    assert names["port"] == names["jax"]
    assert names["port"][1] == "ErrObjectNotFound"


# -- bucket delete ---------------------------------------------------------------

def test_delete_bucket_like_jax(tmp_path, closing):
    """Empty, non-empty, forced and absent bucket deletes end in the
    same error names and the same drives in both packages."""
    outcome = {}
    for impl in IMPLS:
        pools = pools_on(impl, tmp_path / impl.name)
        closing(pools)
        seen = []
        pools.make_bucket("empty")
        pools.make_bucket("full")
        pools.put_object("full", "o", b"x" * 10)
        pools.delete_bucket("empty")
        for call in (lambda: pools.delete_bucket("full"),
                     lambda: pools.delete_bucket("empty")):
            try:
                call()
                seen.append(None)
            except impl.errors.StorageError as e:
                seen.append(type(e).__name__)
        assert pools.bucket_exists("full")
        pools.delete_bucket("full", force=True)
        seen.append(pools.list_buckets())
        seen.append(sorted(k for k in tree(tmp_path / impl.name)
                           if SYS_VOL not in k))
        outcome[impl.name] = seen
    assert outcome["port"] == outcome["jax"]
    assert outcome["port"][1] == "ErrBucketNotFound"
    assert outcome["port"][2] == []
