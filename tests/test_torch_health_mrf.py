"""The drive health wrap, hedged reads and the MRF queue of the port
(minio_tpu_torch: storage/health_wrap.py, the engine's breaker and hedge
paths, background/mrf.py; device="cpu") held to the JAX package.
Tolerance: byte-exact.

- The breaker walks the same states as the JAX HealthWrappedDrive under
  one scripted fake drive; an open circuit fails fast; probes close it;
  close() stops the prober.
- With a breaker-offline drive a PUT upgrades its parity and writes the
  xl.meta the JAX set writes, the read fan-out never touches the drive,
  and the MRF queue takes the object.
- Hedged reads (MTPU_HEDGE_MS=5) over a slow data-shard drive give the
  bytes of MTPU_HEDGE=0 and of the JAX set, rebuilding on the device.
- The MRF journal round trip equals the JAX queue's; drained heals
  leave every drive as a set that never lost the drive, and as the JAX
  queue's heal.
"""

import os
import threading
import time

import numpy as np
import pytest

import minio_tpu.engine.erasure_set as jax_es_mod
import minio_tpu.storage.errors as jax_errors
import minio_tpu_torch.engine.erasure_set as es_mod
import minio_tpu_torch.storage.errors as port_errors
from minio_tpu.background import mrf as jax_mrf
from minio_tpu.engine import heal as jax_heal
from minio_tpu.engine.erasure_set import ErasureSet as JaxErasureSet
from minio_tpu.storage import health_wrap as jax_hw
from minio_tpu.storage.drive import LocalDrive as JaxLocalDrive
from minio_tpu_torch.background import mrf
from minio_tpu_torch.engine import heal
from minio_tpu_torch.engine import quorum as Q
from minio_tpu_torch.engine.erasure_set import ErasureSet
from minio_tpu_torch.ops import coalesce, fused
from minio_tpu_torch.storage import health_wrap as hw
from minio_tpu_torch.storage.drive import SYS_VOL, LocalDrive
from minio_tpu_torch.storage.xlmeta import XLMeta

MIB = 1 << 20
UPGRADED = "x-mtpu-internal-erasure-upgraded"


def body_of(size, seed=0):
    return np.random.default_rng(seed).integers(0, 256, size,
                                                dtype=np.uint8).tobytes()


@pytest.fixture(autouse=True)
def no_threads_left():
    """No executor, MRF loop or port prober a test starts outlives it."""
    def live():
        return {t for t in threading.enumerate()
                if t.name.startswith(("ThreadPoolExecutor", "mtpu-mrf"))
                or (t.name == "mtpu-drive-probe"
                    and getattr(t, "_port", False))}
    before = live()
    coalesce.reset()
    yield
    coalesce.reset()
    assert not live() - before


@pytest.fixture
def fast_breaker(monkeypatch):
    monkeypatch.setenv("MTPU_BREAKER_ERRS", "2")
    monkeypatch.setenv("MTPU_BREAKER_OFFLINE_ERRS", "4")
    monkeypatch.setenv("MTPU_BREAKER_PROBE_S", "30")


def _close_jax_set(es):
    es.pool.shutdown(wait=True)
    es._iter_pool.shutdown(wait=True)


# -- the breaker state machine -------------------------------------------------

class ScriptDrive:
    """A fake drive whose read_all follows a script of outcomes and
    whose disk_info answers while `alive`."""

    def __init__(self, errors):
        self.errors = errors
        self.alive = True
        self.root = "/nowhere"
        self.calls = 0

    def read_all(self, vol, path, outcome="ok"):
        self.calls += 1
        if outcome == "fault":
            raise OSError(5, "I/O error")
        if outcome == "benign":
            raise self.errors.ErrFileNotFound(path)
        if outcome == "slow":
            time.sleep(0.03)
        return b"x"

    def disk_info(self):
        if not self.alive:
            raise OSError(5, "dead")
        return {}


SCRIPT = (["ok", "fault", "fault", "ok", "benign", "benign", "fault",
           "fault", "fault", "fault", "fault", "fault"]
          + ["probe-dead", "ok", "probe"]
          + ["slow", "slow", "slow", "ok", "fault", "ok"])


def _run_script(mod, errors):
    d = ScriptDrive(errors)
    wd = mod.HealthWrappedDrive(d)
    seen = []
    for step in SCRIPT:
        if step == "probe-dead":
            d.alive = False
            wd.probe_now()
        elif step == "probe":
            d.alive = True
            wd.probe_now()
        else:
            try:
                wd.read_all("v", "f", outcome=step)
                res = "ok"
            except Exception as e:  # noqa: BLE001 — recorded
                res = type(e).__name__
            seen.append((step, res))
        seen.append((wd.health_state(), wd.health_info()[
            "consecutive_errors"], d.calls,
            [(t["from"], t["to"]) for t in wd.health_info()["transitions"]]))
    stats = {k: v["calls"] for k, v in wd.api_stats().items()}
    return seen, stats, wd


def test_breaker_sequence_equals_jax(monkeypatch, fast_breaker):
    monkeypatch.setenv("MTPU_BREAKER_SLOW_MS", "20")
    monkeypatch.setenv("MTPU_BREAKER_SLOW_CALLS", "3")
    before = hw.stats()["transitions"]
    port, port_stats, pwd = _run_script(hw, port_errors)
    jax, jax_stats, jwd = _run_script(jax_hw, jax_errors)
    pwd.close()
    object.__setattr__(jwd, "_probe_seq", jwd._probe_seq + 1)
    assert port == jax
    assert port_stats == jax_stats
    walked = [s[0] for s in port if isinstance(s[0], str)
              and s[0] in ("ok", "suspect", "offline")]
    assert {"suspect", "offline"} <= set(walked)
    after = hw.stats()["transitions"]
    assert after["offline"] == before["offline"] + 1


def test_open_circuit_fails_fast_and_probe_closes(tmp_path, fast_breaker):
    d = LocalDrive(str(tmp_path / "d"))
    wd = hw.HealthWrappedDrive(d)
    assert isinstance(wd, LocalDrive) and hw.drive_available(wd)
    assert not hw.drive_available(None)
    real = d.read_all
    d.read_all = lambda *a: (_ for _ in ()).throw(OSError(5, "io"))
    for _ in range(4):
        with pytest.raises(OSError):
            wd.read_all(SYS_VOL, "x")
    assert wd.health_state() == "offline" and not hw.drive_available(wd)
    d.read_all = real
    with pytest.raises(port_errors.ErrDiskNotFound):
        wd.read_all(SYS_VOL, "x")            # the raw drive is not touched
    assert wd.api_stats()["read_all"]["calls"] == 4
    assert wd.probe_now() and wd.health_state() == "ok"
    wd.close()


def test_background_prober_closes_and_close_stops(tmp_path, monkeypatch):
    monkeypatch.setenv("MTPU_BREAKER_ERRS", "1")
    monkeypatch.setenv("MTPU_BREAKER_OFFLINE_ERRS", "2")
    monkeypatch.setenv("MTPU_BREAKER_PROBE_S", "0.02")
    d = LocalDrive(str(tmp_path / "d"))
    wd = hw.HealthWrappedDrive(d)
    real = d.disk_info
    d.disk_info = lambda: (_ for _ in ()).throw(OSError(5, "io"))
    for _ in range(2):
        with pytest.raises(OSError):
            wd.disk_info()
    assert wd.health_state() == "offline"
    wd._prober._port = True
    d.disk_info = real
    deadline = time.monotonic() + 10
    while wd.health_state() != "ok" and time.monotonic() < deadline:
        time.sleep(0.01)
    assert wd.health_state() == "ok"
    # close(): a prober waiting on a dead drive stops at once.
    monkeypatch.setenv("MTPU_BREAKER_PROBE_S", "30")
    d.disk_info = lambda: (_ for _ in ()).throw(OSError(5, "io"))
    for _ in range(2):
        with pytest.raises(OSError):
            wd.disk_info()
    wd._prober._port = True
    t0 = time.monotonic()
    wd.close()
    assert not wd._prober.is_alive() and time.monotonic() - t0 < 5


def test_breaker_oracle_flag(tmp_path, monkeypatch, fast_breaker):
    monkeypatch.setenv("MTPU_BREAKER", "0")
    d = LocalDrive(str(tmp_path / "d"))
    wd = hw.HealthWrappedDrive(d)
    d.read_all = lambda *a: (_ for _ in ()).throw(OSError(5, "io"))
    for _ in range(10):
        with pytest.raises(OSError):
            wd.read_all(SYS_VOL, "x")
    assert wd.health_state() == "ok" and hw.drive_available(wd)
    assert wd.total_errors() == 10


# -- the breaker in the engine ---------------------------------------------------

def _trip_offline(wd):
    """Walk a wrapped drive's circuit open; the raw drive stays fine."""
    inner = wd._drive
    for name in ("read_all", "disk_info"):
        setattr(inner, name,
                lambda *a, **kw: (_ for _ in ()).throw(OSError(5, "io")))
    for _ in range(4):
        with pytest.raises(OSError):
            wd.read_all("bkt", "nothing")
    for name in ("read_all", "disk_info"):
        delattr(inner, name)
    assert wd.health_state() == "offline"


def _pin(monkeypatch):
    """One data-dir uuid for every PUT of both packages."""
    for mod in (es_mod, jax_es_mod):
        monkeypatch.setattr(mod, "new_uuid",
                            lambda: "00000000-0000-4000-8000-000000000000")


IDENT = dict(version_id="", mod_time_ns=1_700_000_000_123_456_789)


def _port_set(root, n=6, parity=2, wrap=True):
    drives = [LocalDrive(str(root / f"d{i}")) for i in range(n)]
    es = ErasureSet(hw.wrap_drives(drives) if wrap else drives,
                    default_parity=parity, device="cpu")
    es.make_bucket("bkt")
    return es


def _jax_set(root, n=6, parity=2):
    es = JaxErasureSet(jax_hw.wrap_drives(
        [JaxLocalDrive(str(root / f"d{i}")) for i in range(n)]),
        default_parity=parity)
    es.make_bucket("bkt")
    return es


def _stop_probes(es):
    for d in es.drives:
        if hasattr(d, "_probe_seq"):
            if isinstance(d, LocalDrive):
                d.close()
            else:
                object.__setattr__(d, "_probe_seq", d._probe_seq + 1)


@pytest.mark.parametrize("size", [100 * 1024, 3 * MIB + 7],
                         ids=["inline", "streamed"])
def test_parity_upgrade_xlmeta_equals_jax(tmp_path, monkeypatch,
                                          fast_breaker, size):
    _pin(monkeypatch)
    body = body_of(size, seed=5)
    port = _port_set(tmp_path / "port")
    jax = _jax_set(tmp_path / "jax")
    try:
        for es in (port, jax):
            _trip_offline(es.drives[1])
        port.mrf = mrf.MRFQueue(lambda *a: None)
        fi = port.put_object("bkt", "o", body, **IDENT)
        jfi = jax.put_object("bkt", "o", body, **IDENT)
        assert fi.erasure.parity_blocks == jfi.erasure.parity_blocks == 3
        assert fi.metadata[UPGRADED] == jfi.metadata[UPGRADED] == "1-offline"
        assert port.mrf.pending() == 1
        for pd, jd in zip(port.drives, jax.drives):
            paths = [os.path.join(d.root, "bkt", "o", "xl.meta")
                     for d in (pd, jd)]
            assert os.path.exists(paths[0]) == os.path.exists(paths[1])
            if os.path.exists(paths[0]):
                assert open(paths[0], "rb").read() == \
                    open(paths[1], "rb").read()
        assert not os.path.exists(os.path.join(port.drives[1].root, "bkt",
                                               "o"))
        # Reads skip the open circuit: the raw drive sees no read_file.
        calls = port.drives[1].api_stats().get("read_file", {}).get(
            "calls", 0)
        assert bytes(port.get_object("bkt", "o")[1]) == body
        assert port.drives[1].api_stats().get("read_file", {}).get(
            "calls", 0) == calls
    finally:
        _stop_probes(port)
        _stop_probes(jax)
        port.close()
        _close_jax_set(jax)


# -- hedged reads ----------------------------------------------------------------

def _slow_data_drive(es, fi, delay):
    """Make the drive of data shard 0 sleep `delay` s in each read_file;
    returns its position."""
    order = Q.shuffle_by_distribution(list(range(es.n)),
                                      fi.erasure.distribution)
    d = es.drives[order[0]]
    real = d.read_file

    def slow(*a, **kw):
        time.sleep(delay)
        return real(*a, **kw)
    d.read_file = slow
    return order[0]


@pytest.mark.parametrize("algo", ["mxh256", "highwayhash256S"])
def test_hedged_get_equals_unhedged_and_jax(tmp_path, monkeypatch, algo):
    monkeypatch.setenv("MTPU_BITROT_ALGO", algo)
    monkeypatch.setenv("MTPU_HEDGE_MS", "5")
    monkeypatch.setattr(es_mod, "SERIAL_FANOUT", False)
    size = 3 * MIB + 12345 if algo == "mxh256" else 300 * 1024 + 3
    body = body_of(size, seed=31)
    es = _port_set(tmp_path / "port", wrap=False)
    try:
        fi = es.put_object("bkt", "o", body)
        _slow_data_drive(es, fi, 0.05)
        got = {}
        for hedge in ("1", "0"):
            monkeypatch.setenv("MTPU_HEDGE", hedge)
            st0, items0 = es_mod.stats(), dict(fused.ITEMS)
            for off, ln in [(0, -1), (777, 100_000), (size - 5, 5)]:
                got[hedge, off] = bytes(es.get_object("bkt", "o", off,
                                                      ln)[1])
            st = {k: v - st0[k] for k, v in es_mod.stats().items()}
            gf = fused.ITEMS["gf_matmul"] - items0["gf_matmul"]
            if hedge == "1":
                assert st["hedged_reads"] >= 3 and st["hedge_fired"] >= 1
                assert st["hedge_spares"] >= 1 and st["hedge_wins"] >= 1
                assert gf >= 1             # the spare's rows rebuilt
            else:
                assert st["hedged_reads"] == 0 and gf == 0
    finally:
        es.close()
    jes = JaxErasureSet([JaxLocalDrive(str(tmp_path / "port" / f"d{i}"))
                         for i in range(6)], default_parity=2)
    try:
        for off, ln in [(0, -1), (777, 100_000), (size - 5, 5)]:
            want = bytes(jes.get_object("bkt", "o", off, ln)[1])
            assert got["1", off] == got["0", off] == want
    finally:
        _close_jax_set(jes)


def test_hedge_worthwhile_on_a_serial_host(tmp_path):
    es = _port_set(tmp_path, n=4, wrap=False)
    try:
        assert not es._hedge_worthwhile([0, 1])
        es._note_read_ms(0, 0.4)
        es._note_read_ms(1, 0.5)
        assert not es._hedge_worthwhile([0, 1])
        for _ in range(8):
            es._note_read_ms(1, 40.0)
        assert es._hedge_worthwhile([0, 1])
    finally:
        es.close()


# -- the MRF queue ---------------------------------------------------------------

def _journal_round(mod, path):
    fail = {"b/o2@"}

    def heal_fn(b, o, v):
        if f"{b}/{o}@{v}" in fail:
            raise OSError("drive still away")
    q = mod.MRFQueue(heal_fn, journal_path=str(path), retry_interval=0.0,
                     jitter=0.0, seed=1)
    for o in ("o1", "o2", "o3"):
        q.enqueue("b", o, "")
    q.enqueue("b", "o1", "")                 # one key, one entry
    healed = q.drain_once()
    q.stop()
    raw = open(path, "rb").read()
    q2 = mod.MRFQueue(heal_fn, journal_path=str(path), retry_interval=0.0)
    replay = (q2.replayed, q2.stats())
    fail.clear()
    q2.drain_once()
    q2.stop()
    return healed, raw, replay, q2.stats(), open(path, "rb").read()


def test_mrf_journal_round_trip_equals_jax(tmp_path):
    port = _journal_round(mrf, tmp_path / "p.jsonl")
    jax = _journal_round(jax_mrf, tmp_path / "j.jsonl")
    assert port == jax
    assert port[2][0] == 1 and port[3]["pending"] == 0


def test_mrf_backoff_drops_after_max_attempts():
    q = mrf.MRFQueue(lambda *a: (_ for _ in ()).throw(OSError("x")),
                     retry_interval=0.0, max_attempts=3, jitter=0.0)
    q.enqueue("b", "o")
    for _ in range(3):
        for it in q._q.values():
            it["next_try"] = 0.0
        q.drain_once()
    assert q.stats() == {"pending": 0, "healed": 0, "dropped": 1,
                         "retries": 3, "replayed": 0}


def _files(es, skip=("tmp", "metacache", "multipart")):
    out = []
    for d in es.drives:
        root = d.root
        files = {}
        for dirpath, _, names in os.walk(root):
            rel = os.path.relpath(dirpath, root)
            if rel.split(os.sep)[0] == SYS_VOL:
                continue
            for f in names:
                with open(os.path.join(dirpath, f), "rb") as fh:
                    files[os.path.join(rel, f)] = fh.read()
        out.append(files)
    return out


def test_mrf_heal_equals_never_lost_and_jax(tmp_path, monkeypatch,
                                           fast_breaker):
    """A breaker-offline drive misses two PUTs (one streamed, one
    inline); MRF enqueues both; once the drive answers, one drain heals
    it.  Every drive then equals a set that never lost the drive (same
    parity and metadata written directly), and the JAX set whose MRF
    queue healed the same loss."""
    _pin(monkeypatch)
    bodies = {"big": body_of(3 * MIB + 99, seed=61),
              "small": body_of(9000, seed=62)}
    port = _port_set(tmp_path / "port")
    twin = _port_set(tmp_path / "twin", wrap=False)
    jax = _jax_set(tmp_path / "jax")
    try:
        port.mrf = mrf.MRFQueue(
            lambda b, o, v: heal.heal_object(port, b, o, v))
        jax.mrf = jax_mrf.MRFQueue(
            lambda b, o, v: jax_heal.heal_object(jax, b, o, v))
        for es in (port, jax):
            _trip_offline(es.drives[2])
        for key, body in bodies.items():
            fi = port.put_object("bkt", key, body, **IDENT)
            jax.put_object("bkt", key, body, **IDENT)
            twin.put_object("bkt", key, body, parity=3,
                            metadata={UPGRADED: "1-offline"}, **IDENT)
            assert fi.metadata[UPGRADED] == "1-offline"
        assert port.mrf.pending() == jax.mrf.pending() == 2
        items0 = dict(fused.ITEMS)
        for es in (port, jax):
            assert es.drives[2].probe_now()
            assert es.mrf.drain_once() == 2
        assert fused.ITEMS["gf_matmul"] > items0["gf_matmul"]
        got = _files(port)
        assert got == _files(twin) == _files(jax)
        assert got[2]                      # the healed drive holds both
        for key, body in bodies.items():
            assert bytes(port.get_object("bkt", key)[1]) == body
        meta = XLMeta.from_bytes(got[2][os.path.join("bkt", "big",
                                                     "xl.meta")])
        assert meta.versions
    finally:
        for es in (port, jax):
            _stop_probes(es)
        port.close()
        twin.close()
        _close_jax_set(jax)


def test_attach_mrf_journals_on_first_drive(tmp_path):
    from minio_tpu_torch.engine.pools import ServerPools
    from minio_tpu_torch.engine.sets import ErasureSets
    drives = [LocalDrive(str(tmp_path / f"d{i}")) for i in range(4)]
    pools = ServerPools([ErasureSets(drives, set_drive_count=4,
                                     device="cpu")])
    try:
        jp = os.path.join(drives[0].root, SYS_VOL, "mrf-journal.jsonl")
        with open(jp, "w") as f:
            f.write('{"op":"enq","b":"bkt","o":"gone","vid":""}\n')
        before = mrf.stats()["replayed"]
        queues = mrf.attach_mrf(pools)
        try:
            assert len(queues) == 1 and queues[0].replayed == 1
            assert pools.pools[0].sets[0].mrf is queues[0]
            assert mrf.stats()["replayed"] == before + 1
        finally:
            for q in queues:
                q.stop()
    finally:
        pools.close()
