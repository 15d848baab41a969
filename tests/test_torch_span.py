"""The port's span plane (minio_tpu_torch/observe/span.py) held to the
JAX package's: the zero-allocation disabled path, the ring, the filters,
the span trees of the same PUT, GET, degraded GET, multipart upload and
heal through both packages' engines, the device spans' wait on the card
(a stand-in for the CUDA stream and event), and the context carried
across the engine's pool threads.  Small sizes (EC:2+2 on the CPU)."""

import contextvars
import shutil
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import minio_tpu.observe.span as jspan
import minio_tpu_torch.observe.span as pspan
from minio_tpu.engine import heal as jheal
from minio_tpu.engine import multipart as jmp
from minio_tpu.engine.erasure_set import ErasureSet as JaxErasureSet
from minio_tpu.storage.drive import LocalDrive as JaxLocalDrive
from minio_tpu_torch.engine import heal as pheal
from minio_tpu_torch.engine import multipart as pmp
from minio_tpu_torch.engine.erasure_set import ErasureSet
from minio_tpu_torch.ops import coalesce, devcache, fused
from minio_tpu_torch.rpc import rest
from minio_tpu_torch.storage.drive import LocalDrive


@pytest.fixture(autouse=True)
def tracing_off(monkeypatch):
    """The tracers are process-global: leave every test with tracing off
    and the devcache out of the reads (a resident range skips the shard
    reads whose spans are compared); both coalescers start cold."""
    from minio_tpu.ops import coalesce as jco
    jco.reset()
    monkeypatch.setenv("MTPU_DEVCACHE", "0")
    coalesce.reset()
    devcache.reset()
    yield
    for sp in (jspan, pspan):
        sp.TRACER.configure(ring=0, sample=1.0)
        sp.TRACER.reset()
    coalesce.reset()
    devcache.reset()


def payload(size, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, size, dtype=np.uint8).tobytes()


def edges(rec: dict) -> set:
    """(parent name, child name) of every span of a trace record."""
    out = set()

    def walk(d):
        for c in d.get("spans", ()):
            out.add((d["name"], c["name"]))
            walk(c)
    walk(rec)
    return out


#: Spans left out of the comparison, by child name, with the reason.  On
#: the CPU the JAX package hashes and frames on the host (hashlib, its
#: native C passes: host.hash_batch, native.*), where the port runs its
#: device programs' plain versions, as on the card (device.*).  Either
#: package may route an item through its coalescer (coalesce.wait) or a
#: metadata read through its drive's lane (metalane.wait) as the lane's
#: occupancy estimate says, which the timing of the pool threads
#: decides, and the port's drive stats a volume on each call where the
#: JAX drive caches a volume's existence (drive.stat).
_JAX_ONLY = ("host.hash_batch", "native.", "coalesce.wait", "metalane.wait",
             "drive.stat")
_PORT_ONLY = ("device.", "coalesce.wait", "metalane.wait", "drive.stat")


def _trees(pkg_span, es, mp, hl, root) -> dict:
    """Trace records of the same operations through one package."""
    data = payload((3 << 20) + 5, seed=1)
    pkg_span.TRACER.configure(ring=64, sample=1.0)
    out = {}

    def traced(op, fn):
        with pkg_span.TRACER.root(op):
            fn()
        out[op] = pkg_span.TRACER.traces()[-1]

    traced("put", lambda: es.put_object("b", "o", data))
    traced("put_inline", lambda: es.put_object("b", "s", data[:1000]))
    traced("get", lambda: es.get_object("b", "o"))
    traced("get_iter", lambda: list(es.get_object_iter("b", "o")[1]))
    uid = mp.new_multipart_upload(es, "b", "m")
    traced("put_part",
           lambda: mp.put_object_part(es, "b", "m", uid, 1, data))
    etag = mp.list_parts(es, "b", "m", uid)[0].etag
    traced("complete", lambda: mp.complete_multipart_upload(
        es, "b", "m", uid, [(1, etag)]))
    shutil.rmtree(root / "1" / "b" / "o")
    traced("heal", lambda: hl.heal_object(es, "b", "o"))
    es.drives[0] = None
    traced("get_degraded", lambda: es.get_object("b", "o"))
    return out


def test_span_trees_match_the_jax_package(tmp_path):
    """The same PUT (streamed and inline), GET (whole and streamed),
    multipart part and complete, heal and degraded GET give the same
    span names and nesting in both packages, but for the spans listed
    in _JAX_ONLY and _PORT_ONLY."""
    trees = {}
    for name, sp, es_cls, drive_cls, mp, hl, kw in (
            ("jax", jspan, JaxErasureSet, JaxLocalDrive, jmp, jheal, {}),
            ("port", pspan, ErasureSet, LocalDrive, pmp, pheal,
             {"device": "cpu"})):
        root = tmp_path / name
        es = es_cls([drive_cls(str(root / str(i))) for i in range(4)],
                    **kw)
        es.make_bucket("b")
        try:
            trees[name] = _trees(sp, es, mp, hl, root)
        finally:
            if name == "port":
                es.close()
            else:
                es.pool.shutdown(wait=True)
                es._iter_pool.shutdown(wait=True)
    for op, jrec in trees["jax"].items():
        prec = trees["port"][op]
        assert prec["name"] == jrec["name"] == op
        je = {e for e in edges(jrec) if not e[1].startswith(_JAX_ONLY)}
        pe = {e for e in edges(prec) if not e[1].startswith(_PORT_ONLY)}
        assert pe == je, (op, sorted(je - pe), sorted(pe - je))
        # Every stage span the JAX tree nests under the root, the port's
        # does too (the engine stages a trace reader attributes time to).
        assert {c["name"] for c in jrec.get("spans", ())
                if not c["name"].startswith(_JAX_ONLY)} == \
            {c["name"] for c in prec.get("spans", ())
             if not c["name"].startswith(_PORT_ONLY)}, op
    # The port's device programs ran under the stages that call them.
    assert ("engine.encode", "device.encode_hash") in edges(
        trees["port"]["put"])
    assert ("engine.verify_decode", "device.verify_transform") in edges(
        trees["port"]["get_degraded"])


def test_disabled_path_allocates_no_spans(tmp_path):
    """Tracing off: root() is the NOOP singleton and an engine PUT and
    GET materialise no Span (SPAN_ALLOCS is the sentinel)."""
    es = ErasureSet([LocalDrive(str(tmp_path / f"d{i}")) for i in range(4)],
                    device="cpu")
    try:
        es.make_bucket("b")
        before = pspan.SPAN_ALLOCS
        assert pspan.TRACER.root("api.GetObject") is pspan.NOOP
        with pspan.span("engine.nothing"):
            pass
        pspan.record("engine.nothing", 0.001)
        es.put_object("b", "o", payload(1 << 20))
        _, got = es.get_object("b", "o")
        assert len(got) == 1 << 20
        assert pspan.SPAN_ALLOCS == before
    finally:
        es.close()


@pytest.mark.parametrize("sp", [jspan, pspan], ids=["jax", "port"])
def test_ring_filters_and_subscribers(sp):
    """The ring keeps the newest N, a resize keeps what it held, the
    filters of `mc admin trace` and a lone subscriber enabling tracing,
    alike in both packages."""
    sp.TRACER.configure(ring=3, sample=1.0)
    for i in range(7):
        with sp.TRACER.root(f"api.Op{i}"):
            pass
    assert [r["name"] for r in sp.TRACER.traces()] == \
        ["api.Op4", "api.Op5", "api.Op6"]
    sp.TRACER.configure(ring=8, sample=1.0)
    assert len(sp.TRACER.traces()) == 3
    sp.TRACER.configure(ring=0, sample=1.0)
    rec_ok = {"name": "api.GetObject", "dur_ms": 5.0, "error": False,
              "tags": {"path": "/b/x"}}
    rec_err = {"name": "api.GetObject", "dur_ms": 0.2, "error": True,
               "tags": {"path": "/other/y"}}
    f = sp.TraceFilter.from_query(
        {"err": "true", "path": "/b", "min-duration-ms": "1"})
    assert not f.matches(rec_ok) and not f.matches(rec_err)
    assert sp.TraceFilter(err_only=True).matches(rec_err)
    assert sp.TraceFilter(path_prefix="/b").matches(rec_ok)
    assert not sp.TRACER.enabled
    q = sp.TRACER.subscribe()
    try:
        with sp.TRACER.root("api.X", path="/p"):
            with sp.span("stage.one"):
                pass
        assert q[0]["spans"][0]["name"] == "stage.one"
    finally:
        sp.TRACER.unsubscribe(q)
    assert not sp.TRACER.enabled


def test_flatten_coverage_and_snapshot_match():
    """flatten, coverage and the per-API snapshot of the same span tree
    (measured durations pinned) are equal in both packages."""
    out = []
    for sp in (jspan, pspan):
        sp.TRACER.configure(ring=4, sample=1.0)
        root = sp.TRACER.root("api.PutObject", path="/b/o")
        with root:
            for name, dur in (("engine.encode", 0.004),
                              ("engine.publish", 0.003)):
                sp.record(name, dur)
            with sp.span("engine.write"):
                sp.record("drive.write", 0.002, drive="d1")
        root.dur_s = 0.01
        for c in root.children:
            if c.name == "engine.write":
                c.dur_s = 0.002
        rec = root.to_dict()
        snap = sp.TRACER.snapshot()["apis"]["api.PutObject"]
        out.append((sp.flatten(rec), sp.coverage(rec),
                    sorted(snap["stages"]), snap["count"]))
    assert out[0] == out[1]
    assert out[1][1] == pytest.approx(0.9)


def test_engine_put_get_coverage(tmp_path):
    """A traced PUT and GET of 8 MiB each yield at least five named
    stage spans whose direct children cover at least 80% of the root
    (the JAX package's bound)."""
    es = ErasureSet([LocalDrive(str(tmp_path / f"d{i}")) for i in range(4)],
                    device="cpu")
    try:
        es.make_bucket("b")
        data = payload(8 << 20, seed=9)
        es.put_object("b", "big", data)
        pspan.TRACER.configure(ring=8, sample=1.0)
        with pspan.TRACER.root("api.PutObject", path="/b/big"):
            es.put_object("b", "big", data)
        with pspan.TRACER.root("api.GetObject", path="/b/big"):
            _, got = es.get_object("b", "big")
        assert bytes(got) == data
        for rec in pspan.TRACER.traces()[-2:]:
            stages = pspan.flatten(rec)
            assert len(stages) >= 5, stages
            assert pspan.coverage(rec) >= 0.8, (rec["name"], stages)
    finally:
        es.close()


class _FakeCuda:
    """A stand-in for torch.cuda's stream and event: records what a call
    waited on, in order with the launches."""

    def __init__(self, log):
        self.log = log
        outer = self

        class Event:
            def record(self, stream):
                outer.log.append(("record", stream))

            def synchronize(self):
                outer.log.append(("synchronize",))

        self.Event = Event

    def current_stream(self, dev):
        self.log.append(("current_stream", str(dev)))
        return f"stream-of-{dev}"

    def synchronize(self, *a):
        raise AssertionError("a device-wide synchronize")


def test_device_span_waits_on_the_current_stream(monkeypatch):
    """A traced fused program closes its span only after an event
    recorded on the CURRENT stream after the launches has completed,
    and tags the card; an untraced one does not wait at all."""
    log = []
    monkeypatch.setattr(fused.torch, "cuda", _FakeCuda(log))
    dev = torch.device("cuda", 0)

    def launch():
        log.append(("launch",))
        return "out"

    assert fused._traced("device.encode_hash", dev, launch) == "out"
    assert log == [("launch",)]                   # untraced: no wait
    log.clear()
    pspan.TRACER.configure(ring=4, sample=1.0)
    with pspan.TRACER.root("api.PutObject"):
        assert fused._traced("device.encode_hash", dev, launch) == "out"
    assert log == [("launch",), ("current_stream", "cuda:0"),
                   ("record", "stream-of-cuda:0"), ("synchronize",)]
    rec = pspan.TRACER.traces()[-1]
    assert rec["spans"][0]["name"] == "device.encode_hash"
    assert rec["spans"][0]["tags"] == {"device": 0}


def test_traced_cpu_programs_open_device_spans(monkeypatch):
    """On the CPU the traced programs open their spans (no tag, nothing
    to wait for), with the JAX span names."""
    monkeypatch.setattr(fused, "_card_done",
                        lambda dev: pytest.fail("waited on the CPU"))
    x = np.random.default_rng(3).integers(0, 256, (2, 2, 64),
                                          dtype=np.uint8)
    pspan.TRACER.configure(ring=4, sample=1.0)
    with pspan.TRACER.root("api.X"):
        fused.encode_and_hash(x, 2, 2, device="cpu")
        fused.verify_and_transform(x, 2, 2, (0, 1), (), device="cpu")
        fused.verify_and_transform(x, 2, 2, (0, 1), (2,), device="cpu")
        fused.transform(x, 2, 2, (0, 1), (3,), device="cpu")
    names = [c["name"] for c in pspan.TRACER.traces()[-1]["spans"]]
    assert names == ["device.encode_hash", "device.verify",
                     "device.verify_transform", "device.verify_transform"]


def test_entry_points_still_raise_without_a_card():
    """device=None means the card: without CUDA the programs raise,
    traced or not."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    x = np.zeros((1, 2, 64), dtype=np.uint8)
    pspan.TRACER.configure(ring=4, sample=1.0)
    for traced in (False, True):
        with (pspan.TRACER.root("api.X") if traced
              else contextvars.copy_context().run(lambda: pspan.NOOP)):
            with pytest.raises(Exception):
                fused.encode_and_hash(x, 2, 2)


def test_coalesce_wait_recorded_by_the_submitter():
    """A coalesced item's queue wait is recorded by the thread that
    waits on its handle, under that thread's span; the lane thread opens
    no span of its own."""
    lane = coalesce.DispatchLane("cpu")
    gate = threading.Event()

    def fn(stacked, spans, ctx):
        gate.wait(5)
        return [stacked[lo:hi] for lo, hi in spans]

    lane._ema = 2.0                         # queue to the lane thread
    pspan.TRACER.configure(ring=4, sample=1.0)
    with pspan.TRACER.root("api.GetObject"):
        with pspan.span("engine.read_part"):
            h = lane.submit(("k",), np.zeros((1, 4), dtype=np.uint8), fn)
            time.sleep(0.05)
            gate.set()
            h.result()
    lane.close()
    rec = pspan.TRACER.traces()[-1]
    assert ("engine.read_part", "coalesce.wait") in edges(rec)
    assert pspan.TRACER.snapshot()["apis"].keys() == {"api.GetObject"}


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_metalane_wait_recorded_by_the_submitter(pkg, monkeypatch):
    """A metadata op the lane's dispatcher served records its queue wait
    (metalane.wait) under the submitter's span, in both packages."""
    from minio_tpu.ops import metalanes as jml
    from minio_tpu_torch.ops import metalanes as pml
    ml, sp = (jml, jspan) if pkg == "jax" else (pml, pspan)
    monkeypatch.setenv("MTPU_METABATCH_SOLO", "1")    # no inline op
    lane = ml.MetaLane("t", lambda item: item * 2,
                       lambda items: [(it * 2, None) for it in items])
    sp.TRACER.configure(ring=4, sample=1.0)
    with sp.TRACER.root("api.HeadObject"):
        with sp.span("engine.quorum"):
            assert lane.submit(21).result() == 42
    lane.close()
    rec = sp.TRACER.traces()[-1]
    assert ("engine.quorum", "metalane.wait") in edges(rec)


def test_wrap_ctx_carries_span_and_deadline():
    """wrap_ctx carries the current span and the request's RPC deadline
    (registered with carry_var) into a pool thread; untraced and without
    a deadline it returns the function unchanged."""
    def probe():
        return pspan.current(), rest.deadline_remaining()

    assert pspan.wrap_ctx(probe) is probe
    pspan.TRACER.configure(ring=4, sample=1.0)
    with ThreadPoolExecutor(1) as ex:
        with pspan.TRACER.root("api.X") as root:
            tok = rest.set_deadline(5.0)
            try:
                cur, left = ex.submit(pspan.wrap_ctx(probe)).result()
            finally:
                rest.clear_deadline(tok)
        assert cur is root and 0 < left <= 5.0
        assert ex.submit(probe).result() == (None, None)


def test_spent_deadline_refuses_the_rpc_without_dialing():
    """An RPC under a spent request deadline raises DeadlineExceeded
    without dialing, counts it, and does not mark the peer offline."""
    cli = rest.RPCClient("127.0.0.1:9", "tok", timeout=0.5)
    try:
        before = rest.stats()["deadline_exceeded"]
        tok = rest.set_deadline(-1.0)
        try:
            with pytest.raises(rest.DeadlineExceeded):
                cli.call("health.health", idempotent=True)
        finally:
            rest.clear_deadline(tok)
        assert rest.stats()["deadline_exceeded"] == before + 1
        assert cli.is_online()
    finally:
        cli.close()
