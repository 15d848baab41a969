"""The port's cross-request dispatch coalescer (minio_tpu_torch/ops/
coalesce.py) on the CPU: the scheduler on the scenarios of
tests/test_coalesce.py (inline idle submit, packing while a dispatch is
in flight, FIFO across keys, an oversized item alone, backpressure, a
poisoned member failing only itself, dispatcher death never hanging,
close failing queued handles, pad_batch), the pipelined staging, and the
engine on it: concurrent PUTs packed by the coalescer write the part
files of MTPU_COALESCE=0 and of the JAX package's coalesced PUTs, each
package reads the other's objects healthy and degraded, and heal ends in
the same state with the coalescer on and off."""

import os
import shutil
import threading
import time

import numpy as np
import pytest

from minio_tpu.engine.erasure_set import ErasureSet as JaxErasureSet
from minio_tpu.ops import coalesce as jax_coalesce
from minio_tpu.storage.drive import LocalDrive as JaxLocalDrive
from minio_tpu_torch.engine import heal
from minio_tpu_torch.engine import quorum as Q
from minio_tpu_torch.engine.erasure_set import BLOCK_SIZE, ErasureSet
from minio_tpu_torch.ops import coalesce, devcache, fused
from minio_tpu_torch.storage.drive import LocalDrive

CPU = "cpu"
IDENT = dict(version_id="", mod_time_ns=1_700_000_000_123_456_789)


@pytest.fixture(autouse=True)
def fresh_plane():
    """Every test starts from cold lanes and an empty shard cache."""
    coalesce.reset()
    devcache.reset()
    yield
    coalesce.reset()
    devcache.reset()


def sum_kernel(calls=None, gate=None, block_first=False, entered=None):
    """Per-span row sums; optionally blocks its first call on `gate` (after
    setting `entered`) so a test can queue more items behind it, and
    records each call's spans."""
    state = {"first": True}

    def kernel(stacked, spans, ctx):
        if block_first and state["first"]:
            state["first"] = False
            if entered is not None:
                entered.set()
            gate.wait(5.0)
        if calls is not None:
            calls.append(list(spans))
        return [int(stacked[lo:hi].sum()) for lo, hi in spans]

    return kernel


def queued_lane(co):
    """The CPU lane, its EMA forced up so submits queue instead of
    running inline."""
    lane = co.lane(CPU)
    lane._ema = 2.0
    return lane


def wait_for(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise TimeoutError("condition not reached")
        time.sleep(0.0002)


class TestScheduler:
    def test_idle_submit_runs_inline(self):
        co = coalesce.DispatchCoalescer()
        h = co.submit(("solo",), np.ones(3, dtype=np.uint8), sum_kernel(),
                      device=CPU)
        assert h.result(1.0) == 3
        assert co.lane(CPU)._thread is None
        st = co.stats()
        assert st["dispatches"] == 1 and st["items"] == 1
        assert st["inline_dispatches"] == 1
        co.close()

    def test_batches_items_queued_during_dispatch(self):
        co = coalesce.DispatchCoalescer()
        queued_lane(co)
        calls, gate, entered = [], threading.Event(), threading.Event()
        fn = sum_kernel(calls, gate, block_first=True, entered=entered)
        key = ("t", 1)
        h0 = co.submit(key, np.ones(2, dtype=np.uint8), fn, device=CPU)
        assert entered.wait(5.0)      # the dispatcher is blocked in fn
        hs = [co.submit(key, np.full(3, i, dtype=np.uint8), fn, device=CPU)
              for i in range(1, 4)]
        gate.set()
        assert h0.result(5.0) == 2
        assert [h.result(5.0) for h in hs] == [3, 6, 9]
        st = co.stats()
        assert st["dispatches"] == 2 and st["items"] == 4
        assert st["max_items"] == 3 and len(calls[1]) == 3
        co.close()

    def test_fifo_across_keys(self):
        co = coalesce.DispatchCoalescer()
        queued_lane(co)
        order, gate, entered = [], threading.Event(), threading.Event()

        def mk(tag):
            def kernel(stacked, spans, ctx):
                if tag == "warm":
                    entered.set()
                    gate.wait(5.0)
                else:
                    order.append(tag)
                return [None for _ in spans]
            return kernel

        hw = co.submit(("warm",), np.zeros(1, dtype=np.uint8), mk("warm"),
                       device=CPU)
        assert entered.wait(5.0)
        ha = co.submit(("a",), np.zeros(1, dtype=np.uint8), mk("a"),
                       device=CPU)
        hb = co.submit(("b",), np.zeros(1, dtype=np.uint8), mk("b"),
                       device=CPU)
        gate.set()
        for h in (hw, ha, hb):
            h.result(5.0)
        assert order == ["a", "b"]
        co.close()

    def test_oversized_item_dispatches_alone(self, monkeypatch):
        monkeypatch.setenv("MTPU_COALESCE_MAX_BATCH", "4")
        co = coalesce.DispatchCoalescer()
        h = co.submit(("big",), np.ones(100, dtype=np.uint8), sum_kernel(),
                      weight=100, device=CPU)
        assert h.result(5.0) == 100
        st = co.stats()
        assert st["dispatches"] == 1 and st["items"] == 1
        co.close()

    def test_backpressure_bounds_queue(self, monkeypatch):
        monkeypatch.setenv("MTPU_COALESCE_MAX_BATCH", "4")   # cap = 16
        co = coalesce.DispatchCoalescer()
        queued_lane(co)
        gate, entered = threading.Event(), threading.Event()
        fn = sum_kernel(gate=gate, block_first=True, entered=entered)
        key = ("bp",)
        co.submit(key, np.zeros(1, dtype=np.uint8), fn, weight=1, device=CPU)
        assert entered.wait(5.0)      # dispatcher blocked; queue empty
        co.submit(key, np.zeros(8, dtype=np.uint8), fn, weight=8, device=CPU)
        co.submit(key, np.zeros(8, dtype=np.uint8), fn, weight=8, device=CPU)
        done = threading.Event()

        def overflow():
            co.submit(key, np.zeros(8, dtype=np.uint8), fn, weight=8,
                      device=CPU)
            done.set()

        t = threading.Thread(target=overflow, daemon=True)
        t.start()
        assert not done.wait(0.3)     # 16 queued: the third submit blocks
        gate.set()
        assert done.wait(5.0)
        t.join(5.0)
        assert not t.is_alive()
        assert co.stats()["pending_weight"] <= 16
        co.close()

    def test_kernel_error_fans_out(self):
        co = coalesce.DispatchCoalescer()
        queued_lane(co)
        gate, entered = threading.Event(), threading.Event()

        def boom(stacked, spans, ctx):
            entered.set()
            gate.wait(5.0)
            raise ValueError("kernel exploded")

        h1 = co.submit(("err",), np.zeros(1, dtype=np.uint8), boom,
                       device=CPU)
        assert entered.wait(5.0)
        h2 = co.submit(("err",), np.zeros(1, dtype=np.uint8), boom,
                       device=CPU)
        gate.set()
        for h in (h1, h2):
            with pytest.raises(ValueError, match="exploded"):
                h.result(5.0)
        co.close()

    def test_pad_batch(self):
        x = np.arange(10, dtype=np.uint8).reshape(5, 2)
        p, n = coalesce.pad_batch(x, 4)
        assert n == 5 and p.shape == (8, 2)
        assert np.array_equal(p[:5], x) and not p[5:].any()
        same, n2 = coalesce.pad_batch(x[:4], 4)
        assert n2 == 4 and same.shape == (4, 2)
        one, n3 = coalesce.pad_batch(x, 1)    # the engine's PAD_ROWS
        assert one is x and n3 == 5

    def test_lanes_follow_the_cards(self):
        co = coalesce.DispatchCoalescer(nlanes=2)
        assert co.lane(CPU) is co.lane("cpu")
        assert co.lane(CPU).device.type == "cpu"
        co.close()


POISON = 66


def picky_kernel(stacked, spans, ctx):
    """Sums spans but refuses a span holding the POISON byte: a packed
    batch fails whole, and the per-member retry isolates the span."""
    out = []
    for lo, hi in spans:
        if (stacked[lo:hi] == POISON).any():
            raise ValueError("poisoned span")
        out.append(int(stacked[lo:hi].sum()))
    return out


class TestFaultContainment:
    def test_poisoned_member_fails_only_itself(self):
        co = coalesce.DispatchCoalescer()
        queued_lane(co)
        gate, entered = threading.Event(), threading.Event()
        warm = sum_kernel(gate=gate, block_first=True, entered=entered)
        key = ("fc", 1)
        before = coalesce.stats()["co_faults"]
        h0 = co.submit(key, np.ones(1, dtype=np.uint8), warm, device=CPU)
        assert entered.wait(5.0)
        good1 = co.submit(key, np.full(2, 3, dtype=np.uint8), picky_kernel,
                          device=CPU)
        bad = co.submit(key, np.full(2, POISON, dtype=np.uint8),
                        picky_kernel, device=CPU)
        good2 = co.submit(key, np.full(4, 2, dtype=np.uint8), picky_kernel,
                          device=CPU)
        gate.set()
        assert h0.result(5.0) == 1
        assert good1.result(5.0) == 6 and good2.result(5.0) == 8
        with pytest.raises(ValueError, match="poisoned"):
            bad.result(5.0)
        st = co.stats()
        assert st["batch_faults"] == 1 and st["member_retries"] == 3
        assert not st["broken"]
        assert coalesce.stats()["co_faults"] == before + 3
        assert co.submit(key, np.ones(5, dtype=np.uint8), picky_kernel,
                         device=CPU).result(5.0) == 5
        co.close()

    def test_single_poisoned_item_keeps_direct_error(self):
        co = coalesce.DispatchCoalescer()
        h = co.submit(("solo-p",), np.full(2, POISON, dtype=np.uint8),
                      picky_kernel, device=CPU)
        with pytest.raises(ValueError, match="poisoned"):
            h.result(5.0)
        st = co.stats()
        assert st["batch_faults"] == 1 and st["member_retries"] == 0
        co.close()

    def test_dispatcher_death_fails_queued_never_hangs(self, monkeypatch):
        co = coalesce.DispatchCoalescer()
        lane = queued_lane(co)
        lane._ema = 5.0
        monkeypatch.setattr(
            lane, "_pick_key",
            lambda: (_ for _ in ()).throw(RuntimeError("scheduler bug")))
        h = co.submit(("dead",), np.ones(3, dtype=np.uint8), sum_kernel(),
                      device=CPU)
        with pytest.raises(RuntimeError, match="dispatcher died"):
            h.result(5.0)
        assert co.stats()["broken"]
        h2 = co.submit(("dead",), np.ones(4, dtype=np.uint8), sum_kernel(),
                       device=CPU)
        assert h2.result(1.0) == 4    # later submits run inline
        co.close()

    def test_close_fails_pending_handles(self):
        co = coalesce.DispatchCoalescer()
        queued_lane(co)
        gate, entered = threading.Event(), threading.Event()
        h0 = co.submit(("cl",), np.ones(2, dtype=np.uint8),
                       sum_kernel(gate=gate, block_first=True,
                                  entered=entered), device=CPU)
        assert entered.wait(5.0)      # the dispatcher is blocked in h0
        h1 = co.submit(("cl",), np.ones(3, dtype=np.uint8), sum_kernel(),
                       device=CPU)
        co.close()
        with pytest.raises(RuntimeError, match="closed"):
            h1.result(5.0)
        gate.set()                    # the dispatch in flight finishes
        assert h0.result(5.0) == 2
        with pytest.raises(RuntimeError, match="closed"):
            co.submit(("cl",), np.ones(1, dtype=np.uint8), sum_kernel(),
                      device=CPU)


def staged_kernel(launched):
    """Row sums of (N, 4) rows with a pipelined form that records the
    staged input it was given."""
    def kernel(stacked, spans, ctx):
        return [int(stacked[lo:hi].sum()) for lo, hi in spans]

    def launch(x, n, spans, ctx):
        launched.append((tuple(x.shape), n))
        sums = [int(x[lo:hi].sum()) for lo, hi in spans]
        return lambda: sums

    kernel.launch = launch
    return kernel


class TestPipeline:
    @pytest.mark.parametrize("h2d", ["1", "0"])
    def test_staged_batches_resolve_in_order(self, monkeypatch, h2d):
        """Packed batches staged through the two buffers give the serial
        path's results; MTPU_H2D_PIPELINE=0 dispatches them serially."""
        monkeypatch.setenv("MTPU_H2D_PIPELINE", h2d)
        co = coalesce.DispatchCoalescer()
        lane = queued_lane(co)
        gate = threading.Event()
        hg = co.submit(("gate",), np.zeros(1, dtype=np.uint8),
                       sum_kernel(gate=gate, block_first=True), device=CPU)
        launched = []
        fn = staged_kernel(launched)
        rng = np.random.default_rng(3)
        payloads = [rng.integers(0, 256, (int(rng.integers(1, 4)), 4),
                                 dtype=np.uint8) for _ in range(12)]
        hs = [co.submit(("rows",), p, fn, device=CPU) for p in payloads]
        gate.set()
        hg.result(5.0)
        assert [h.result(5.0) for h in hs] == \
            [int(p.astype(np.int64).sum()) for p in payloads]
        st = lane.stats()
        if h2d == "1":
            assert st["pipeline_dispatches"] >= 1
            assert st["h2d_bytes"] == sum(p.nbytes for p in payloads)
            assert sum(n for _, n in launched) == sum(
                p.shape[0] for p in payloads)
        else:
            assert st["pipeline_dispatches"] == 0 and not launched
        co.close()

    def test_launch_failure_falls_back_to_serial(self):
        co = coalesce.DispatchCoalescer()
        queued_lane(co)
        gate = threading.Event()
        hg = co.submit(("gate",), np.zeros(1, dtype=np.uint8),
                       sum_kernel(gate=gate, block_first=True), device=CPU)
        fn = staged_kernel([])

        def broken(x, n, spans, ctx):
            raise RuntimeError("launch refused")

        fn.launch = broken
        hs = [co.submit(("rows",), np.full((2, 4), i, dtype=np.uint8), fn,
                        device=CPU) for i in range(3)]
        gate.set()
        hg.result(5.0)
        assert [h.result(5.0) for h in hs] == [0, 8, 16]
        assert co.stats()["pipeline_dispatches"] == 0
        co.close()


# -- the engine on the coalescer ---------------------------------------------

def body_of(size, seed):
    return np.random.default_rng(seed).integers(0, 256, size,
                                                dtype=np.uint8).tobytes()


# Inline, a tail block alone, one block, blocks + a tail.
SIZES = [60 * 1024, 300 * 1024, BLOCK_SIZE, 2 * BLOCK_SIZE + 4321]


def port_set(root, n=6, parity=2):
    return ErasureSet([LocalDrive(str(root / f"d{i}")) for i in range(n)],
                      default_parity=parity, device=CPU)


def in_threads(fn, items):
    errs, threads = [], []

    def run(item):
        try:
            fn(item)
        except Exception as e:  # noqa: BLE001 — reported below
            errs.append(e)

    for item in items:
        threads.append(threading.Thread(target=run, args=(item,)))
        threads[-1].start()
    for t in threads:
        t.join(60.0)
        assert not t.is_alive()
    assert not errs, errs


def held(fn, n_items):
    """Run `fn` while the CPU lane is held by a gate item until `n_items`
    items are queued behind it, so they pack."""
    lane = queued_lane(coalesce.get())
    gate = threading.Event()
    hg = lane.submit(("gate",), np.zeros(1, dtype=np.uint8),
                     sum_kernel(gate=gate, block_first=True))
    t = threading.Thread(target=fn)
    t.start()
    try:
        wait_for(lambda: lane.stats()["pending_items"] >= n_items)
    finally:
        gate.set()
        hg.result(10.0)
        t.join(60.0)
    assert not t.is_alive()
    return lane


def part_files(es, bucket, names):
    """{(drive, name): bytes} of every part file (xl.meta for inline
    objects) of `names`."""
    out = {}
    for pos, d in enumerate(es.drives):
        for name in names:
            base = os.path.join(d.root, bucket, name)
            dirs = [x for x in os.listdir(base)
                    if os.path.isdir(os.path.join(base, x))]
            path = (os.path.join(base, dirs[0], "part.1") if dirs
                    else os.path.join(base, "xl.meta"))
            with open(path, "rb") as f:
                out[pos, name] = f.read()
    return out


def test_coalesced_puts_same_part_files(tmp_path, monkeypatch):
    """Concurrent PUTs packed into shared launches write the same part
    files as the port's MTPU_COALESCE=0 and as the JAX package's
    coalesced PUTs; the objects read back, GETs packed too."""
    bodies = {f"o{i}": body_of(SIZES[i % len(SIZES)], seed=40 + i)
              for i in range(8)}
    names = sorted(bodies)

    def put_all(es):
        in_threads(lambda nm: es.put_object("b", nm, bodies[nm], **IDENT),
                   names)

    on = port_set(tmp_path / "on")
    on.make_bucket("b")
    before = dict(fused.ITEMS)
    lane = held(lambda: put_all(on), len(bodies) - 1)
    st = lane.stats()
    assert st["max_items"] >= 2 and st["pipeline_dispatches"] >= 1
    assert st["batch_faults"] == 0
    # Items are what the sizes call for, packed or not: one per batch of
    # up to 32 full blocks and one per tail block.
    calls = sum(-(-(len(b) // BLOCK_SIZE) // 32) + (len(b) % BLOCK_SIZE > 0)
                for b in bodies.values())
    assert fused.ITEMS["gf_matmul"] - before["gf_matmul"] == calls
    assert fused.ITEMS["mxh256"] - before["mxh256"] == calls

    def get_all():
        got = {}
        in_threads(lambda nm: got.__setitem__(
            nm, bytes(on.get_object("b", nm)[1])), names)
        assert got == bodies

    lane = held(get_all, len(bodies) - 2)
    assert lane.stats()["max_items"] >= 2

    monkeypatch.setenv("MTPU_COALESCE", "0")
    off = port_set(tmp_path / "off")
    off.make_bucket("b")
    put_all(off)
    monkeypatch.setenv("MTPU_COALESCE", "1")
    jax_coalesce.reset()
    try:
        jes = JaxErasureSet([JaxLocalDrive(str(tmp_path / "jax" / f"d{i}"))
                             for i in range(6)], default_parity=2)
        jes.make_bucket("b")
        put_all(jes)
    finally:
        jax_coalesce.reset()
    want = part_files(on, "b", names)
    assert part_files(off, "b", names) == want
    assert part_files(jes, "b", names) == want
    for es in (on, off):
        es.close()


def data_positions(fi, count):
    order = Q.shuffle_by_distribution(
        list(range(len(fi.erasure.distribution))), fi.erasure.distribution)
    return [order[s] for s in range(count)]


def test_packages_read_each_other(tmp_path):
    """Objects the port PUT concurrently through its coalescer read back
    in the JAX package, and the JAX package's in the port (coalesced
    concurrent GETs), healthy and with two data-shard drives away."""
    bodies = {f"o{i}": body_of(SIZES[1 + i % 3], seed=60 + i)
              for i in range(6)}
    names = sorted(bodies)
    paths = [str(tmp_path / "p" / f"d{i}") for i in range(6)]
    es = ErasureSet([LocalDrive(p) for p in paths], default_parity=2,
                    device=CPU)
    es.make_bucket("b")
    held(lambda: in_threads(lambda nm: es.put_object("b", nm, bodies[nm]),
                            names), len(names) - 1)
    jes = JaxErasureSet([JaxLocalDrive(p) for p in paths], default_parity=2)
    for nm in names:
        assert bytes(jes.get_object("b", nm)[1]) == bodies[nm]
        fi = jes.head_object("b", nm)
        saved = list(jes.drives)
        for pos in data_positions(fi, 2):
            jes.drives[pos] = None
        assert bytes(jes.get_object("b", nm)[1]) == bodies[nm]
        jes.drives = saved

    jpaths = [str(tmp_path / "j" / f"d{i}") for i in range(6)]
    jes = JaxErasureSet([JaxLocalDrive(p) for p in jpaths], default_parity=2)
    jes.make_bucket("b")
    for nm in names:
        jes.put_object("b", nm, bodies[nm])
    es2 = ErasureSet([LocalDrive(p) for p in jpaths], default_parity=2,
                     device=CPU)
    got = {}

    def get_all():
        in_threads(lambda nm: got.__setitem__(
            nm, bytes(es2.get_object("b", nm)[1])), names)

    held(get_all, len(names) - 2)
    assert got == bodies
    fi = es2.head_object("b", names[-1])
    away = data_positions(fi, 2)
    for pos in away:
        es2.drives[pos] = None
    got.clear()
    held(get_all, 1)                  # degraded: "vt" items pack
    assert got == bodies
    assert coalesce.stats()["co_fallbacks"] == 0
    es.close()
    es2.close()


def drive_tree(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            rel = os.path.relpath(p, root)
            if rel.startswith(".mtpu.sys"):
                continue
            with open(p, "rb") as fh:
                out[rel] = fh.read()
    return out


@pytest.mark.parametrize("mode", ["1", "0"], ids=["coalesce", "direct"])
def test_heal_end_state(tmp_path, monkeypatch, mode):
    """Two drives wiped and healed with four workers: the healed drives
    hold what they held before, with the coalescer on and off."""
    monkeypatch.setenv("MTPU_COALESCE", mode)
    monkeypatch.setenv("MTPU_DEVCACHE", "0")
    es = port_set(tmp_path)
    es.make_bucket("b")
    names = [f"o{i}" for i in range(6)]
    for i, nm in enumerate(names):
        es.put_object("b", nm, body_of(SIZES[i % len(SIZES)], seed=80 + i),
                      **IDENT)
    golden = {p: drive_tree(d.root) for p, d in enumerate(es.drives)}
    wiped = [1, 4]
    for pos in wiped:
        root = es.drives[pos].root
        shutil.rmtree(root)
        es.drives[pos] = LocalDrive(root)
    heal.heal_bucket(es, "b")
    in_threads(lambda nm: heal.heal_object(es, "b", nm), names)
    for pos in wiped:
        assert drive_tree(es.drives[pos].root) == golden[pos]
    if mode == "1":
        assert coalesce.get().stats()["items"] > 0
    assert coalesce.stats()["co_fallbacks"] == 0
    es.close()


def test_engine_falls_back_when_handles_fail(tmp_path, monkeypatch):
    """A coalescer whose every handle fails: PUT and GET recompute
    through the direct calls and count the fallbacks."""
    class FailHandle(coalesce.Handle):
        def __init__(self):
            super().__init__(1, 1)

        def result(self, timeout=None):
            raise RuntimeError("coalescer dispatcher died: stub")

    class BrokenCoalescer:
        def submit(self, key, payload, fn, weight=None, device=None):
            return FailHandle()

        def hot(self, device=None):
            return True

        def note_read(self, delta, device=None):
            pass

    monkeypatch.setattr(coalesce, "get", lambda: BrokenCoalescer())
    monkeypatch.setenv("MTPU_DEVCACHE", "0")
    es = port_set(tmp_path)
    es.make_bucket("b")
    data = body_of(BLOCK_SIZE + 99, seed=90)
    before = coalesce.stats()["co_fallbacks"]
    es.put_object("b", "fb", data)
    assert bytes(es.get_object("b", "fb")[1]) == data
    fi = es.head_object("b", "fb")
    es.drives[data_positions(fi, 1)[0]] = None
    assert bytes(es.get_object("b", "fb")[1]) == data
    # PUT: 2 batches; GET: 2 verifies; degraded GET: 2.
    assert coalesce.stats()["co_fallbacks"] - before == 6
    es.close()
