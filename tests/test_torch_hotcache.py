"""The port's hot-object tier (minio_tpu_torch/engine/hotcache.py) and the
engine's GET side over it, held to the JAX package (device="cpu").
Tolerance: byte-exact, and equal tier counts.

- the cache alone, in both packages: two-hit ghost admission, the
  generation bump, a stale stamp, the size gate, the CLOCK eviction
  bound, version keys, metadata hits outside the body ratio; the same
  sequence gives the same stats in both;
- SingleFlight: leader and followers, a failed leader;
- a seeded sequence of PUT, GET, ranged GET, HEAD, DELETE, overwrite
  and multipart through a JAX ErasureSet with its tier and the port's
  with its own: the same bytes, errors and hit, miss, fill and bypass
  counts;
- the hazards of the GET side:
  a. a FileInfo cache older than the tier's shared generation (two sets
     over one tier in threads, and two forked workers over one tier);
  b. every mutation bumps the generation after it lands (a spy orders
     the drive writes and the bumps) and is visible through a warm tier;
  c. every forked child runs under a timeout, in a supervisor process
     that loads no torch and has no thread when it forks;
  d. zero-copy views pin their arena run until they die, and the pin is
     released by the next cache operation, not by the GC callback;
  e. only fully verified reads fill: degraded, corrupted, hedged-spare,
     breaker-rerouted, inline, oversize and zero-byte reads bypass.
"""

import gc
import hashlib
import json
import os
import shutil
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest

import minio_tpu.engine.erasure_set as jax_es_mod
import minio_tpu.engine.heal as jax_heal
import minio_tpu.engine.hotcache as jax_hc
import minio_tpu.engine.multipart as jax_mp
import minio_tpu_torch.engine.erasure_set as es_mod
import minio_tpu_torch.engine.heal as port_heal
import minio_tpu_torch.engine.hotcache as hc
import minio_tpu_torch.engine.multipart as port_mp
from minio_tpu.storage.drive import LocalDrive as JaxLocalDrive
from minio_tpu.storage.errors import StorageError as JaxStorageError
from minio_tpu_torch.engine import quorum as Q
from minio_tpu_torch.engine.erasure_set import ErasureSet
from minio_tpu_torch.ops import coalesce, devcache
from minio_tpu_torch.storage.drive import LocalDrive
from minio_tpu_torch.storage.errors import ErrObjectNotFound, StorageError

MIB = 1 << 20
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def payload(size, seed=0):
    return np.random.default_rng(seed).integers(0, 256, size,
                                                dtype=np.uint8).tobytes()


@pytest.fixture(autouse=True)
def no_executor_threads_left():
    """No executor thread a test starts outlives it."""
    def executors():
        return {t for t in threading.enumerate()
                if t.name.startswith("ThreadPoolExecutor")}
    before = executors()
    yield
    assert not executors() - before


@pytest.fixture(autouse=True)
def quiet_planes(monkeypatch):
    """Cold lanes and device cache around each test; no hedge unless a
    test asks for one (a fired hedge turns a healthy read into a
    rebuild, which may not fill)."""
    monkeypatch.setenv("MTPU_HEDGE", "0")
    monkeypatch.delenv("MTPU_HOTCACHE", raising=False)
    monkeypatch.delenv("MTPU_ZEROCOPY", raising=False)
    coalesce.reset()
    devcache.reset()
    yield
    coalesce.reset()
    devcache.reset()


def _close(es):
    if isinstance(es, ErasureSet):
        es.close()
    else:
        es.pool.shutdown(wait=True)
        es._iter_pool.shutdown(wait=True)


@pytest.fixture
def sets(tmp_path):
    """make(pkg, name, n, parity, tier_bytes, max_obj) -> (es, tier);
    every set made is closed after the test."""
    made = []

    def make(pkg="port", name="s", n=4, parity=2, tier_bytes=32 * MIB,
             max_obj=None, tier=None):
        if pkg == "port":
            es = ErasureSet([LocalDrive(str(tmp_path / name / f"d{i}"))
                             for i in range(n)], default_parity=parity,
                            device="cpu")
            mod = hc
        else:
            es = jax_es_mod.ErasureSet(
                [JaxLocalDrive(str(tmp_path / name / f"d{i}"))
                 for i in range(n)], parity)
            mod = jax_hc
        made.append(es)
        if tier is None:
            tier = mod.HotObjectCache(total_bytes=tier_bytes,
                                      max_obj=max_obj)
        mod.attach_sets(es, tier)
        return es, tier
    yield make
    for es in made:
        _close(es)


def warm(es, bucket, obj, version_id=""):
    """Read until cached: miss and ghost, miss and fill, hit."""
    for _ in range(3):
        fi, got = es.get_object(bucket, obj, version_id=version_id)
    return fi, bytes(got)


COUNTS = ("hits", "misses", "fills", "bypassed", "meta_hits",
          "ghost_defers", "stale_gen", "evictions")


def counts(tier) -> dict:
    st = tier.stats()
    return {k: st[k] for k in COUNTS}


# -- the cache alone, both packages -------------------------------------------

@pytest.fixture(params=["jax", "port"])
def cache_mod(request):
    return jax_hc if request.param == "jax" else hc


class TestCacheUnit:
    def test_env_knobs(self, cache_mod, monkeypatch):
        assert cache_mod.hot_enabled()
        assert cache_mod.hot_bytes() == 64 * MIB
        assert cache_mod.hot_max_obj() == 4 * MIB
        monkeypatch.setenv("MTPU_HOTCACHE", "0")
        assert not cache_mod.hot_enabled()
        assert cache_mod.maybe_tier() is None
        monkeypatch.setenv("MTPU_HOTCACHE_MB", "128")
        assert cache_mod.hot_bytes() == 128 * MIB
        monkeypatch.setenv("MTPU_HOTCACHE_MAX_OBJ", "1024")
        assert cache_mod.hot_max_obj() == 1024

    def test_two_hit_ghost_then_hit(self, cache_mod):
        c = cache_mod.HotObjectCache(total_bytes=8 * MIB)
        fi = {"etag": "e1", "size": 5}
        g = c.generation("b")
        assert c.fill("b", "o", "", fi, b"hello", g) is False   # ghost
        assert c.lookup("b", "o", "") is None
        assert c.fill("b", "o", "", fi, b"hello", g) is True
        gfi, body = c.lookup("b", "o", "")
        assert gfi == fi and body == b"hello"
        st = c.stats()
        assert (st["fills"], st["ghost_defers"], st["hits"],
                st["misses"], st["entries"], st["cached_bytes"]) == \
            (1, 1, 1, 1, 1, 5)

    def test_generation_bump_invalidates(self, cache_mod):
        c = cache_mod.HotObjectCache(total_bytes=8 * MIB)
        g = c.generation("b")
        c.fill("b", "o", "", {}, b"v1", g)
        c.fill("b", "o", "", {}, b"v1", g)
        assert c.lookup("b", "o", "") is not None
        c.note_mutation("b")
        assert c.lookup("b", "o", "") is None
        st = c.stats()
        assert st["stale_gen"] >= 1 and st["invalidations"] == 1
        g2 = c.generation("b")
        assert g2 == g + 1
        assert c.fill("b", "o", "", {}, b"v2", g2) is True
        assert c.lookup("b", "o", "")[1] == b"v2"

    def test_stale_stamp_dropped(self, cache_mod):
        c = cache_mod.HotObjectCache(total_bytes=8 * MIB)
        g = c.generation("b")
        c.fill("b", "o", "", {}, b"old", g)        # ghost
        c.note_mutation("b")
        assert c.fill("b", "o", "", {}, b"old", g) is False
        assert c.lookup("b", "o", "") is None

    def test_size_gate(self, cache_mod):
        c = cache_mod.HotObjectCache(total_bytes=8 * MIB, max_obj=100)
        g = c.generation("b")
        assert c.fill("b", "big", "", {}, b"x" * 101, g) is False
        assert c.fill("b", "empty", "", {}, b"", g) is False
        st = c.stats()
        assert st["bypassed"] == 2 and st["fills"] == 0

    def test_clock_eviction_bounded(self, cache_mod):
        c = cache_mod.HotObjectCache(total_bytes=2 * MIB, n_entries=16)
        body = b"z" * (256 << 10)
        for i in range(40):
            g = c.generation("b")
            c.fill("b", f"o{i}", "", {}, body, g)    # ghost
            c.fill("b", f"o{i}", "", {}, body, g)    # admit
        st = c.stats()
        assert st["evictions"] > 0 and st["entries"] <= 16
        assert st["in_use_bytes"] <= st["segment_bytes"]
        assert any(c.lookup("b", f"o{i}", "") is not None
                   for i in range(40))

    def test_version_keys_distinct(self, cache_mod):
        c = cache_mod.HotObjectCache(total_bytes=8 * MIB)
        g = c.generation("b")
        for vid, body in (("v1", b"one"), ("v2", b"two")):
            c.fill("b", "o", vid, {"v": vid}, body, g)
            c.fill("b", "o", vid, {"v": vid}, body, g)
        assert c.lookup("b", "o", "v1")[1] == b"one"
        assert c.lookup("b", "o", "v2")[1] == b"two"
        assert c.lookup("b", "o", "") is None

    def test_lookup_meta_does_not_skew_body_ratio(self, cache_mod):
        c = cache_mod.HotObjectCache(total_bytes=8 * MIB)
        g = c.generation("b")
        c.fill("b", "o", "", {"etag": "m"}, b"body", g)
        c.fill("b", "o", "", {"etag": "m"}, b"body", g)
        h0 = c.stats()["hits"]
        assert c.lookup_meta("b", "o", "") == {"etag": "m"}
        assert c.lookup_meta("b", "missing", "") is None
        st = c.stats()
        assert st["meta_hits"] == 1 and st["hits"] == h0


def test_generation_reads_without_the_lock():
    """Every election reads the shared generation: it takes no lock, so
    a worker that holds the tier's lock blocks no read of it."""
    c = hc.HotObjectCache(total_bytes=8 * MIB)
    c.note_mutation("b")
    held, done = threading.Event(), threading.Event()

    def hold():
        with c._mu:
            held.set()
            done.wait(10)
    t = threading.Thread(target=hold)
    t.start()
    try:
        assert held.wait(10)
        got = []
        reader = threading.Thread(
            target=lambda: got.append(c.generation("b")), daemon=True)
        reader.start()
        reader.join(5)
        assert got == [1]
    finally:
        done.set()
        t.join(10)
        reader.join(10)


def test_cache_sequence_matches_jax():
    """One seeded sequence of fills, lookups, views, metadata lookups and
    mutations over both packages' caches: the same answers and stats."""
    rng = np.random.default_rng(91)
    caches = [m.HotObjectCache(total_bytes=2 * MIB, n_entries=24,
                               max_obj=300_000) for m in (jax_hc, hc)]
    bodies = {f"o{i}": payload(int(rng.integers(1, 300_000)), seed=i)
              for i in range(30)}
    for _ in range(600):
        op = int(rng.integers(5))
        name = f"o{int(rng.integers(30))}"
        bucket = "b" if rng.integers(4) else "c"
        got = []
        for c in caches:
            if op == 0:
                got.append(c.fill(bucket, name, "", {"n": name},
                                  bodies[name], c.generation(bucket)))
            elif op == 1:
                r = c.lookup(bucket, name, "")
                got.append(None if r is None else (r[0], bytes(r[1])))
            elif op == 2:
                r = c.lookup_view(bucket, name, "")
                got.append(None if r is None else (r[0], bytes(r[1])))
            elif op == 3:
                got.append(c.lookup_meta(bucket, name, ""))
            else:
                c.note_mutation(bucket)
                got.append(None)
        assert got[0] == got[1], (op, name)
    gc.collect()
    for c in caches:
        c.drain_released_views()
    assert caches[0].stats() == caches[1].stats()


def test_keys_sharing_a_ghost_slot_are_both_admitted():
    """Two keys whose hashes share a ghost slot (as two of phase 5l's hot
    keys do): the reference's direct-mapped table lets each miss replace
    the other's ghost, so alternating misses never admit either.  The
    port's two-way table admits both on their second miss."""
    keys = ("hot0-5", "hot0-29")
    slots = {hc._key_hash(hc._key_bytes("spine", k, "")) % hc._GHOST_SLOTS
             for k in keys}
    assert len(slots) == 1
    c = hc.HotObjectCache(total_bytes=8 * MIB)
    g = c.generation("spine")
    for _ in range(2):
        for k in keys:
            c.fill("spine", k, "", {"k": k}, k.encode(), g)
    assert [c.lookup("spine", k, "")[1] for k in keys] == \
        [k.encode() for k in keys]
    assert c.stats()["fills"] == 2 and c.stats()["ghost_defers"] == 2


class TestSingleFlight:
    def test_leader_and_followers(self, cache_mod):
        sf = cache_mod.SingleFlight()
        fl, leader = sf.begin("k")
        assert leader
        f2, l2 = sf.begin("k")
        assert not l2 and f2 is fl
        out = []
        t = threading.Thread(target=lambda: out.append(f2.wait()))
        t.start()
        fl.resolve("payload")
        t.join(5)
        assert out == ["payload"]
        sf.end("k")
        _, l3 = sf.begin("k")
        assert l3
        sf.end("k")

    def test_failed_leader_resolves_none(self, cache_mod):
        sf = cache_mod.SingleFlight()
        sf.begin("k")
        f2, _ = sf.begin("k")
        sf.end("k")
        assert f2.wait(timeout=1) is None


# -- the engine over the tier, both packages ----------------------------------

class TestEngineDifferential:
    SIZES = (777, 200_000, MIB + 123, 3 * MIB)

    def _ops(self, es, tier, pkg, rng_seed):
        """The seeded sequence; returns what each step answered."""
        mp = jax_mp if pkg == "jax" else port_mp
        rng = np.random.default_rng(rng_seed)
        truth = {}
        out = []
        es.make_bucket("b")
        for i, size in enumerate(self.SIZES):
            truth[f"o{i}"] = payload(size, seed=40 + i)
            es.put_object("b", f"o{i}", truth[f"o{i}"])
        names = sorted(truth) + ["gone"]
        for step in range(120):
            name = names[int(rng.integers(len(names)))]
            # Reads mostly: each mutation invalidates the bucket.
            kind = int(rng.choice(9, p=(.25, .1, .1, .15, .1, .04, .06,
                                        .04, .16)))
            try:
                if kind <= 2:
                    _, got = es.get_object("b", name)
                    res = hashlib.sha256(bytes(got)).hexdigest()
                elif kind == 3:
                    n = len(truth.get(name, b"x" * 10))
                    off = int(rng.integers(n + 2))
                    ln = int(rng.integers(-1, n + 1))
                    _, got = es.get_object("b", name, offset=off,
                                           length=ln)
                    res = hashlib.sha256(bytes(got)).hexdigest()
                elif kind == 4:
                    fi = es.head_object("b", name)
                    res = (fi.size, fi.metadata.get("etag"))
                elif kind == 5:
                    es.delete_object("b", name)
                    truth.pop(name, None)
                    res = "deleted"
                elif kind == 6:
                    data = payload(int(rng.choice(self.SIZES)),
                                   seed=1000 + step)
                    es.put_object("b", name, data)
                    truth[name] = data
                    res = "put"
                elif kind == 7:
                    data = payload(int(rng.integers(150_000, 600_000)),
                                   seed=2000 + step)
                    uid = mp.new_multipart_upload(es, "b", name)
                    info = mp.put_object_part(es, "b", name, uid, 1, data)
                    mp.complete_multipart_upload(es, "b", name, uid,
                                                 [(1, info.etag)])
                    truth[name] = data
                    res = "multipart"
                else:
                    _, it = es.get_object_iter("b", name)
                    res = hashlib.sha256(b"".join(
                        bytes(c) for c in it)).hexdigest()
            except (StorageError, JaxStorageError) as e:
                res = type(e).__name__
            if name in truth and kind in (0, 1, 2, 8):
                assert res == hashlib.sha256(truth[name]).hexdigest()
            out.append((step, kind, name, res))
        return out, counts(tier)

    def test_seeded_sequence_matches_jax(self, sets):
        got = {}
        for pkg in ("jax", "port"):
            es, tier = sets(pkg, name=pkg)
            got[pkg] = self._ops(es, tier, pkg, 7)
        jax_ops, jax_counts = got["jax"]
        port_ops, port_counts = got["port"]
        for a, b in zip(jax_ops, port_ops):
            assert a == b
        assert jax_counts == port_counts
        assert port_counts["fills"] >= 2 and port_counts["hits"] >= 5

    def test_hit_launches_nothing_and_iter_view(self, sets, monkeypatch):
        es, tier = sets()
        es.make_bucket("b")
        data = payload(600_000, seed=4)
        es.put_object("b", "o", data)
        warm(es, "b", "o")
        items0 = dict(es_mod.fused.ITEMS)
        elections0 = es_mod.stats()["meta_read_requests"]
        h0 = tier.stats()["hits"]
        _, got = es.get_object("b", "o", offset=10, length=1000)
        assert bytes(got) == data[10:1010]
        fi, it = es.get_object_iter("b", "o", 100, 999)
        chunks = list(it)
        assert b"".join(bytes(c) for c in chunks) == data[100:1099]
        assert isinstance(chunks[0], np.ndarray)     # an arena view
        assert es.head_object("b", "o").size == len(data)
        assert es_mod.fused.ITEMS == items0        # no device work
        assert es_mod.stats()["meta_read_requests"] == elections0
        assert tier.stats()["hits"] == h0 + 2
        assert tier.stats()["meta_hits"] >= 1
        monkeypatch.setenv("MTPU_ZEROCOPY", "0")
        fi, it = es.get_object_iter("b", "o", 100, 999)
        chunks = list(it)
        assert not isinstance(chunks[0], np.ndarray)
        assert b"".join(bytes(c) for c in chunks) == data[100:1099]

    def test_ranged_hit_error_parity(self, sets, monkeypatch):
        es, tier = sets()
        es.make_bucket("b")
        data = payload(200_000, seed=3)
        es.put_object("b", "o", data)
        warm(es, "b", "o")
        with pytest.raises(StorageError) as hot_err:
            es.get_object("b", "o", offset=len(data) + 1)
        monkeypatch.setenv("MTPU_HOTCACHE", "0")
        with pytest.raises(StorageError) as cold_err:
            es.get_object("b", "o", offset=len(data) + 1)
        assert str(hot_err.value) == str(cold_err.value)

    def test_single_flight_one_engine_read(self, sets):
        es, tier = sets()
        es.make_bucket("b")
        data = payload(MIB, seed=6)
        es.put_object("b", "cold", data)
        reads = []
        direct = es._get_object_direct

        def counting(*a, **kw):
            reads.append(1)
            time.sleep(0.2)         # followers arrive while it reads
            return direct(*a, **kw)
        es._get_object_direct = counting
        results = [None] * 8
        barrier = threading.Barrier(8)

        def go(i):
            barrier.wait()
            _, got = es.get_object("b", "cold", offset=i, length=1000)
            results[i] = bytes(got)
        ts = [threading.Thread(target=go, args=(i,)) for i in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
        assert all(r == data[i:i + 1000] for i, r in enumerate(results))
        assert len(reads) == 1

    def test_devcache_served_read_fills(self, sets):
        """A read served from the device shard cache verified its rows
        when they were filled: it counts as full-k verified."""
        es, tier = sets()
        es.make_bucket("b")
        data = payload(MIB + 5, seed=8)
        es.put_object("b", "o", data)
        es.get_object("b", "o")                  # ghost; fills devcache
        hits0 = devcache.stats()["hits"]
        _, got = es.get_object("b", "o")         # devcache hit; fills
        assert devcache.stats()["hits"] > hits0
        assert bytes(got) == data and tier.stats()["fills"] == 1


# -- hazard a: a FileInfo cache older than the shared generation --------------

def test_fileinfo_cache_checked_against_shared_generation(sets):
    """Two sets over the same drives and one tier play two workers in
    threads.  B's FileInfo cache holds v1 when A PUTs v2 of a versioned
    key; B's next GET leads the miss.  Electing through its stale entry
    would fill v1 under the new generation, and A would then be served
    v1 from the tier.  Fails without the tier's generation in the
    FileInfo cache's stamp."""
    a, tier = sets(name="w")
    b, _ = sets(name="w", tier=tier)
    a._FI_CACHE_TTL = b._FI_CACHE_TTL = 3600.0
    a.make_bucket("b")
    v1, v2 = payload(300_000, seed=1), payload(310_000, seed=2)
    a.put_object("b", "o", v1, versioned=True)
    assert bytes(b.get_object("b", "o")[1]) == v1     # ghost, B's FI v1
    a.put_object("b", "o", v2, versioned=True)
    for es in (b, a, b, a):
        assert bytes(es.get_object("b", "o")[1]) == v2
    assert b.head_object("b", "o").size == len(v2)
    assert tier.stats()["fills"] == 1


_FORK_SCRIPT = textwrap.dedent(r"""
    import hashlib, json, os, select, signal, sys, time
    root, versioned = sys.argv[1], sys.argv[2] == "1"
    from minio_tpu_torch.engine.hotcache import HotObjectCache
    assert "torch" not in sys.modules
    tier = HotObjectCache(total_bytes=16 << 20)
    body = lambda seed: bytes(((i * 131 + seed * 7) & 0xFF)
                              for i in range(300_000 + seed))

    def worker(rfd, wfd):
        from minio_tpu_torch.server.workers import _set_pdeathsig
        _set_pdeathsig()
        from minio_tpu_torch.engine.erasure_set import ErasureSet
        from minio_tpu_torch.engine.hotcache import attach_sets
        from minio_tpu_torch.storage.drive import LocalDrive
        ErasureSet._FI_CACHE_TTL = 3600.0   # the hazard's window, held open
        es = ErasureSet([LocalDrive(f"{root}/d{i}") for i in range(4)],
                        device="cpu")
        attach_sets(es, tier)
        rf, wf = os.fdopen(rfd, "r"), os.fdopen(wfd, "w")
        for line in rf:
            cmd, _, arg = line.strip().partition(" ")
            if cmd == "quit":
                break
            try:
                if cmd == "mkbucket":
                    es.make_bucket("b")
                    out = "ok"
                elif cmd == "put":
                    es.put_object("b", "o", body(int(arg)),
                                  versioned=versioned)
                    out = "ok"
                else:
                    out = hashlib.sha256(
                        bytes(es.get_object("b", "o")[1])).hexdigest()
            except Exception as e:
                out = "ERR " + type(e).__name__
            wf.write(out + "\n")
            wf.flush()
        es.close()

    kids = {}
    for name in ("A", "B"):
        c_r, p_w = os.pipe()
        p_r, c_w = os.pipe()
        pid = os.fork()
        if pid == 0:
            rc = 0
            try:
                worker(c_r, c_w)
            except BaseException:
                rc = 1
            os._exit(rc)
        os.close(c_r)
        os.close(c_w)
        kids[name] = (pid, os.fdopen(p_w, "w"), p_r)

    def ask(name, cmd):
        pid, w, r = kids[name]
        w.write(cmd + "\n")
        w.flush()
        ready, _, _ = select.select([r], [], [], 60)
        if not ready:
            raise SystemExit(f"worker {name} gave no answer to {cmd}")
        line = b""
        while not line.endswith(b"\n"):
            chunk = os.read(r, 4096)
            if not chunk:
                raise SystemExit(f"worker {name} died on {cmd}")
            line += chunk
        return line.decode().strip()

    sha = lambda seed: hashlib.sha256(body(seed)).hexdigest()
    log = []
    try:
        log.append(ask("A", "mkbucket"))
        log.append(ask("A", "put 1"))
        log.append(ask("B", "get") == sha(1))     # B's FileInfo: v1
        log.append(ask("A", "put 2"))
        for who in ("B", "A", "B", "A"):
            log.append((who, ask(who, "get") == sha(2)))
    finally:
        for pid, w, r in kids.values():
            try:
                w.write("quit\n")
                w.flush()
            except OSError:
                pass
        deadline = time.monotonic() + 60
        codes = {}
        for name, (pid, w, r) in kids.items():
            while True:
                got, st = os.waitpid(pid, os.WNOHANG)
                if got:
                    codes[name] = os.waitstatus_to_exitcode(st)
                    break
                if time.monotonic() > deadline:
                    os.kill(pid, signal.SIGKILL)
                    os.waitpid(pid, 0)
                    codes[name] = "killed"
                    break
                time.sleep(0.05)
    print(json.dumps({"log": log, "codes": codes,
                      "stats": tier.stats()}))
""")


@pytest.mark.parametrize("versioned", [True, False],
                         ids=["versioned", "unversioned"])
def test_forked_workers_serve_the_new_version(tmp_path, versioned):
    """Hazard a across processes: two forked workers over one pre-fork
    tier.  The supervisor loads no torch and starts no thread before it
    forks; each child is joined within 60 s or killed (hazard c), and
    the whole run has a 240 s limit."""
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", _FORK_SCRIPT, str(tmp_path),
         "1" if versioned else "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["codes"] == {"A": 0, "B": 0}, proc.stderr[-3000:]
    assert res["log"][:4] == ["ok", "ok", True, "ok"]
    assert res["log"][4:] == [["B", True], ["A", True], ["B", True],
                              ["A", True]]
    assert res["stats"]["fills"] == 1 and res["stats"]["hits"] >= 2


# -- hazard b: every mutation bumps after it lands ----------------------------

_WRITES = ("rename_data", "write_metadata", "write_metadata_many",
           "delete_version", "update_metadata", "delete_volume")


class _Spy:
    """Orders a set's drive writes and its tier's generation bumps."""

    def __init__(self, es, tier):
        self.events = []
        self._mu = threading.Lock()
        for d in es.drives:
            for name in _WRITES:
                fn = getattr(d, name, None)
                if fn is not None:
                    setattr(d, name, self._wrap(name, fn))
        bump = tier.note_mutation

        def note(bucket):
            bump(bucket)
            with self._mu:
                self.events.append("bump")
        tier.note_mutation = note

    def _wrap(self, name, fn):
        def call(*a, **kw):
            out = fn(*a, **kw)
            with self._mu:
                self.events.append(name)
            return out
        return call

    def check(self):
        """At least one write and one bump, and no write after the
        first bump; then forget."""
        ev, self.events = self.events, []
        assert "bump" in ev and ev[0] != "bump", ev
        assert all(e == "bump" for e in ev[ev.index("bump"):]), ev


def _mutations(pkg):
    mp = jax_mp if pkg == "jax" else port_mp
    heal = jax_heal if pkg == "jax" else port_heal

    def overwrite(es, v):
        es.put_object("b", "o", payload(260_000, seed=11))
        return payload(260_000, seed=11)

    def delete(es, v):
        es.delete_object("b", "o")

    def delete_marker(es, v):
        es.delete_object("b", "o", versioned=True)

    def delete_bucket(es, v):
        es.delete_bucket("b", force=True)
        es.make_bucket("b")

    def metadata(es, v):
        fi = es.head_object("b", "o")
        fi.metadata["x-new"] = "stamped"
        es.update_object_metadata("b", "o", fi)
        return v

    def heal_it(es, v):
        shutil.rmtree(os.path.join(es.drives[0].root, "b", "o"))
        assert any(r.healed_drives for r in heal.heal_object(es, "b", "o"))
        return v

    def multipart(es, v):
        part = payload(300_000, seed=17)
        uid = mp.new_multipart_upload(es, "b", "o")
        info = mp.put_object_part(es, "b", "o", uid, 1, part)
        mp.complete_multipart_upload(es, "b", "o", uid, [(1, info.etag)])
        return part

    return {"overwrite": overwrite, "delete": delete,
            "delete_marker": delete_marker, "delete_bucket": delete_bucket,
            "metadata": metadata, "heal": heal_it, "multipart": multipart}


MUTATIONS = ("overwrite", "delete", "delete_marker", "delete_bucket",
             "metadata", "heal", "multipart")


@pytest.mark.parametrize("pkg", ["jax", "port"])
@pytest.mark.parametrize("mutation", MUTATIONS)
def test_mutation_bumps_after_it_lands_and_is_visible(sets, pkg, mutation):
    """Through a warm tier: the mutation's drive writes all come before
    its generation bump (a bump before the publish would let a racing
    read fill the old bytes under the new generation), and the next
    read sees it."""
    es, tier = sets(pkg)
    es.make_bucket("b")
    v1 = payload(250_000, seed=10)
    es.put_object("b", "o", v1, versioned=mutation == "delete_marker")
    assert warm(es, "b", "o")[1] == v1
    spy = _Spy(es, tier)
    want = _mutations(pkg)[mutation](es, v1)
    spy.check()
    if want is None:
        with pytest.raises(Exception) as ei:
            es.get_object("b", "o")
        assert type(ei.value).__name__ == "ErrObjectNotFound"
        with pytest.raises(Exception) as ei:
            es.head_object("b", "o")
        assert type(ei.value).__name__ == "ErrObjectNotFound"
    else:
        _, got = es.get_object("b", "o")
        assert bytes(got) == want
        if mutation == "metadata":
            assert es.head_object("b", "o").metadata["x-new"] == "stamped"
        assert warm(es, "b", "o")[1] == want


# -- hazard d: zero-copy views ------------------------------------------------

def test_views_pin_until_dead_and_release_on_next_operation(monkeypatch):
    c = hc.HotObjectCache(total_bytes=4 * MIB, n_entries=8)
    body = payload(300_000, seed=5)
    g = c.generation("b")
    c.fill("b", "o", "", {"k": 1}, body, g)
    c.fill("b", "o", "", {"k": 1}, body, g)
    released = []
    real_release = c.arena.release
    monkeypatch.setattr(c.arena, "release",
                        lambda off: released.append(off)
                        or real_release(off))
    fi, view = c.lookup_view("b", "o", "")
    part = view[1000:2000]                    # a slice keeps it pinned
    del view
    c.note_mutation("b")                       # the entry goes stale...
    assert c.lookup("b", "o", "") is None      # ...and is reaped
    # The reaped run stays allocated under the pin: its bytes intact.
    assert c.stats()["entries"] == 0
    assert c.stats()["in_use_bytes"] > 0
    assert bytes(part) == body[1000:2000]
    n = len(released)
    del part
    gc.collect()
    assert len(released) == n                  # not from the GC callback
    c.drain_released_views()
    assert len(released) == n + 1
    assert c.stats()["in_use_bytes"] == 0


def test_engine_views_return_arena_to_zero(sets):
    es, tier = sets(tier_bytes=8 * MIB)
    es.make_bucket("b")
    data = payload(400_000, seed=12)
    es.put_object("b", "o", data)
    warm(es, "b", "o")
    held = [list(es.get_object_iter("b", "o", i, 100)[1])[0]
            for i in range(5)]
    es.delete_object("b", "o")                 # the entry is stale now
    with pytest.raises(ErrObjectNotFound):
        es.get_object("b", "o")                # the lookup reaps it
    assert tier.stats()["entries"] == 0
    assert tier.stats()["in_use_bytes"] > 0    # pinned by the views
    assert [bytes(h) for h in held] == [data[i:i + 100] for i in range(5)]
    del held
    gc.collect()
    tier.drain_released_views()
    assert tier.stats()["in_use_bytes"] == 0


# -- hazard e: what may fill --------------------------------------------------

def _data_drive(es, bucket, obj, shard=0):
    fi, _ = es._read_metadata(bucket, obj)
    order = Q.shuffle_by_distribution(list(range(es.n)),
                                      fi.erasure.distribution)
    return order[shard], fi


class TestWhatFills:
    def _three_gets(self, es, data, name="o"):
        for _ in range(3):
            _, got = es.get_object("b", name)
            assert bytes(got) == data

    def test_degraded_read_bypasses(self, sets):
        es, tier = sets()
        es.make_bucket("b")
        data = payload(MIB + 9, seed=20)
        es.put_object("b", "o", data)
        pos, _ = _data_drive(es, "b", "o")
        es.drives[pos] = None
        self._three_gets(es, data)
        assert tier.stats()["fills"] == 0
        assert tier.stats()["bypassed"] >= 2

    def test_corrupted_shard_read_bypasses(self, sets, monkeypatch):
        monkeypatch.setenv("MTPU_DEVCACHE", "0")
        es, tier = sets()
        es.make_bucket("b")
        data = payload(2 * MIB, seed=21)
        es.put_object("b", "o", data)
        pos, fi = _data_drive(es, "b", "o")
        path = os.path.join(es.drives[pos].root, "b", "o", fi.data_dir,
                            "part.1")
        raw = bytearray(open(path, "rb").read())
        raw[len(raw) // 2] ^= 0xFF
        open(path, "wb").write(bytes(raw))
        self._three_gets(es, data)
        assert tier.stats()["fills"] == 0
        assert tier.stats()["bypassed"] >= 3

    def test_hedged_spare_read_bypasses(self, sets, monkeypatch):
        monkeypatch.setenv("MTPU_HEDGE", "1")
        monkeypatch.setenv("MTPU_HEDGE_MS", "5")
        monkeypatch.setenv("MTPU_DEVCACHE", "0")
        monkeypatch.setattr(es_mod, "SERIAL_FANOUT", False)
        es, tier = sets()
        es.make_bucket("b")
        data = payload(MIB, seed=22)
        es.put_object("b", "o", data)
        pos, _ = _data_drive(es, "b", "o")
        d = es.drives[pos]
        slow = d.read_file

        def straggle(*a, **kw):
            time.sleep(0.5)
            return slow(*a, **kw)
        d.read_file = straggle
        wins0 = es_mod.stats()["hedge_wins"]
        self._three_gets(es, data)
        assert es_mod.stats()["hedge_wins"] > wins0
        assert tier.stats()["fills"] == 0

    def test_breaker_rerouted_read_bypasses(self, sets, monkeypatch):
        es, tier = sets()
        es.make_bucket("b")
        data = payload(MIB, seed=23)
        es.put_object("b", "o", data)
        pos, _ = _data_drive(es, "b", "o")
        tripped = es.drives[pos]
        monkeypatch.setattr(es_mod, "drive_available",
                            lambda d: d is not None and d is not tripped)
        self._three_gets(es, data)
        assert tier.stats()["fills"] == 0

    @pytest.mark.parametrize("size", [0, 900, 500_000],
                             ids=["zero", "inline", "oversize"])
    def test_small_and_large_objects_bypass(self, sets, size):
        es, tier = sets(max_obj=400_000)
        es.make_bucket("b")
        data = payload(size, seed=24)
        es.put_object("b", "o", data)
        self._three_gets(es, data)
        assert tier.stats()["fills"] == 0

    def test_disabled_tier_is_the_oracle(self, sets, monkeypatch):
        monkeypatch.setenv("MTPU_HOTCACHE", "0")
        es, tier = sets()
        es.make_bucket("b")
        data = payload(300_000, seed=25)
        es.put_object("b", "o", data)
        self._three_gets(es, data)
        assert counts(tier) == dict.fromkeys(COUNTS, 0)
