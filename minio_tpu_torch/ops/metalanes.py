"""Per-drive metadata lanes: group-commit writes and coalesced reads.

Counterpart of minio_tpu/ops/metalanes.py.  Without this plane a small
(inline) PUT pays one fsynced ``write_metadata`` per drive through a
per-request fan-out, and every HEAD or GET metadata miss an all-N
``read_version`` fan-out: N threads x M requests of tiny drive calls.
The lanes apply the coalescer's discipline (ops/coalesce.py) to that
traffic:

- one ``MetaLane`` per (drive, kind) owns a FIFO queue and a lazy
  daemon dispatcher.  A write lane drains the concurrent inline-PUT
  publishes landing on its drive into ONE
  ``drive.write_metadata_many`` call, whose blobs share a single
  journal fsync and a single drive sync before any caller is
  acknowledged (group commit); a
  read lane drains distinct keys' metadata reads into one
  ``drive.read_version_many`` round.
- an idle lane runs the item on the caller's thread through the exact
  single-op drive call (``write_metadata`` / ``read_version``), so a
  lone request keeps the single-op latency and bytes; packing engages
  once the engine's in-flight counters (`note_put`, `reading`) or a
  busy lane show concurrency, and an occupancy EMA holds the window
  open while batches pack.
- a write round of fewer than ``JOURNAL_MIN_ITEMS`` queued publishes
  is handed back: each caller runs its own solo ``write_metadata``, in
  parallel.  A journaled batch pays two syncs (the segment's fsync and
  the drive's sync), a solo publish one, so group commit can only pay
  from three items up.
- a failed batch retries its members solo, so one poisoned item fails
  alone; a dead dispatcher fails its queued handles and every later
  submit runs inline.

The lanes are process-local: each pool worker has its own, and a
forked child drops its parent's (`_reset_after_fork`).

Env, read per call:

- MTPU_METABATCH=0 turns the plane off: the single-op fan-outs, one
  fsync per xl.meta publish (the byte-identical oracle);
- MTPU_METABATCH_WINDOW_US: how long the oldest queued item waits for
  company once the window engages (default 250);
- MTPU_METABATCH_DEPTH: items per batched drive call (default 64);
- MTPU_METABATCH_SOLO=1 sends even a lone PUT through the journaled
  batch path (a batch of one; no round is handed back);
- MTPU_META_TRIM=0 turns off the engine's K+1 read trim
  (engine/erasure_set._read_version_fanout); it rides MTPU_METABATCH.

`counters()` holds the plane's process-wide counts (the JAX package
records them into DATA_PATH): read rounds and the keys they served,
trim outcomes, lane dispatches and inline ops.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import deque

_STATS_MU = threading.Lock()
_STATS = {"read_rounds": 0, "read_keys": 0, "trim_hits": 0,
          "trim_fallbacks": 0, "lane_dispatches": 0, "inline_ops": 0}


def counters() -> dict:
    with _STATS_MU:
        return dict(_STATS)


def _count(**kw) -> None:
    with _STATS_MU:
        for key, n in kw.items():
            _STATS[key] += n


def record_read_round(rounds: int, keys: int) -> None:
    """`rounds` per-drive read dispatches served `keys` lookups."""
    _count(read_rounds=rounds, read_keys=keys)


def record_trim(hit: bool) -> None:
    """A K+1 trimmed round accepted (hit) or widened to every drive."""
    _count(**{"trim_hits" if hit else "trim_fallbacks": 1})


def enabled() -> bool:
    return os.environ.get("MTPU_METABATCH", "1") != "0"


def trim_enabled() -> bool:
    return enabled() and os.environ.get("MTPU_META_TRIM", "1") != "0"


def solo_forced() -> bool:
    return os.environ.get("MTPU_METABATCH_SOLO", "") == "1"


def window_s() -> float:
    try:
        us = float(os.environ.get("MTPU_METABATCH_WINDOW_US", "250"))
    except ValueError:
        us = 250.0
    return max(0.0, us) / 1e6


#: the fewest queued publishes a write round journals (see above)
JOURNAL_MIN_ITEMS = 3


def depth() -> int:
    try:
        return max(1, int(os.environ.get("MTPU_METABATCH_DEPTH", "64")))
    except ValueError:
        return 64


class MetaHandle:
    """The future of one submitted metadata op."""

    __slots__ = ("_ev", "_res", "_exc", "_t_enq", "_back")

    def __init__(self):
        self._ev = threading.Event()
        self._res = None
        self._exc: BaseException | None = None
        self._t_enq = time.monotonic()
        # (lane, item) when the lane handed the op back to its caller
        self._back = None

    def result(self, timeout: float | None = 120.0):
        if not self._ev.wait(timeout):
            raise TimeoutError("batched metadata op did not complete")
        back, self._back = self._back, None
        if back is not None:
            lane, item = back
            try:
                self._res = lane._run_handed_back(item)
            except BaseException as e:  # noqa: BLE001 — raised below
                self._exc = e
        if self._exc is not None:
            raise self._exc
        return self._res

    def _resolve(self, res=None, exc: BaseException | None = None) -> None:
        self._res = res
        self._exc = exc
        self._ev.set()


class MetaLane:
    """One drive's scheduler for one op kind ("write" or "read").

    `solo_fn(item)` is the exact single-op path; `batch_fn` (the drive's
    `write_metadata_many` / `read_version_many`, or None for a drive
    without one) takes a list of items and returns one `(result, exc)`
    pair per item.  Without a batch op the lane still runs its items in
    one dispatcher round of solo calls.  A round of fewer than
    `min_batch` items (unless MTPU_METABATCH_SOLO) is handed back: each
    item's caller runs `solo_fn` itself."""

    #: queued items allowed, as a multiple of the depth; beyond it
    #: submit() blocks (backpressure)
    QUEUE_FACTOR = 4

    def __init__(self, name: str, solo_fn, batch_fn=None,
                 min_batch: int = 1):
        self.name = name
        self._solo = solo_fn
        self._batch = batch_fn
        self._min_batch = min_batch
        self._mu = threading.Lock()
        self._work = threading.Condition(self._mu)
        self._space = threading.Condition(self._mu)
        self._queue: deque = deque()
        self._dispatching = False
        self._inline = 0
        # Occupancy EMA: ~1.0 means lone requests (run inline at once),
        # above it packing pays and the window holds the head item.
        self._ema = 1.0
        self._thread: threading.Thread | None = None
        self._stopped = False
        self._broken: BaseException | None = None
        self.dispatches = 0
        self.items = 0
        self.max_items = 0
        self.inline_ops = 0
        self.batch_faults = 0
        self.member_retries = 0
        self.handed_back = 0

    def busy(self) -> bool:
        return (len(self._queue) > 0 or self._dispatching
                or self._inline > 0 or self._ema > 1.05)

    # -- submission ----------------------------------------------------------

    def submit(self, item) -> MetaHandle:
        h = MetaHandle()
        cap = self.QUEUE_FACTOR * depth()
        with self._mu:
            if self._stopped:
                raise RuntimeError("metadata lane closed")
            # An idle lane (nothing queued or dispatching, no recent
            # packing) runs the single-op path on this thread.
            # MTPU_METABATCH_SOLO turns this off, so a lone PUT takes the
            # journal as a batch of one.
            inline = (self._broken is not None
                      or (not solo_forced() and not self._queue
                          and not self._dispatching
                          and self._inline == 0 and self._ema <= 1.05))
            if inline:
                self._inline += 1
            else:
                if self._thread is None:
                    self._thread = threading.Thread(
                        target=self._loop,
                        name=f"mtpu-metalane-{self.name}", daemon=True)
                    self._thread.start()
                while len(self._queue) >= cap:
                    self._space.wait(0.05)
                    cap = self.QUEUE_FACTOR * depth()
                self._queue.append((item, h))
                self._work.notify()
        if inline:
            try:
                res = self._solo(item)
            except BaseException as e:  # noqa: BLE001 — the caller raises
                h._resolve(exc=e)
            else:
                h._resolve(res=res)
            with self._mu:
                self._inline -= 1
                self.inline_ops += 1
            _count(inline_ops=1)
        return h

    # -- dispatcher ----------------------------------------------------------

    def _loop(self) -> None:
        try:
            while True:
                with self._mu:
                    while not self._queue:
                        if self._stopped:
                            return
                        self._work.wait()
                    budget = depth()
                    # Adaptive window: hold the head item for company
                    # only while recent dispatches packed, and never
                    # past the oldest item's age bound.
                    if self._ema > 1.05 and len(self._queue) < budget:
                        deadline = self._queue[0][1]._t_enq + window_s()
                        while (len(self._queue) < budget
                               and not self._stopped):
                            left = deadline - time.monotonic()
                            if left <= 0:
                                break
                            self._work.wait(left)
                    items = []
                    while self._queue and len(items) < budget:
                        items.append(self._queue.popleft())
                    self._dispatching = True
                    self._space.notify_all()
                self._dispatch(items)
                with self._mu:
                    self._dispatching = False
        except BaseException as e:  # noqa: BLE001 — the dispatcher died
            self._abort(e)

    def _abort(self, exc: BaseException) -> None:
        """Dispatcher death: fail every queued handle and run every later
        submit inline, so no submitter waits on a dispatcher that is
        gone."""
        with self._mu:
            self._broken = exc
            victims = [h for _, h in self._queue]
            self._queue.clear()
            self._dispatching = False
            self._space.notify_all()
            self._work.notify_all()
        err = RuntimeError(f"metadata lane dispatcher died: {exc!r}")
        for h in victims:
            h._resolve(exc=err)

    def _run_handed_back(self, item):
        try:
            return self._solo(item)
        finally:
            with self._mu:
                self._inline -= 1
                self.inline_ops += 1
            _count(inline_ops=1)

    def _dispatch(self, items: list) -> None:
        if len(items) < self._min_batch and not solo_forced():
            # Too few to pay for a batch: each caller runs its own solo
            # call, in parallel, as an inline op of the lane.  The round
            # still feeds the occupancy EMA, so rounds that keep
            # arriving in pairs open the window for a third.
            with self._mu:
                self._inline += len(items)
                self.handed_back += len(items)
                self._ema = 0.75 * self._ema + 0.25 * len(items)
            for it, h in items:
                h._back = (self, it)
                h._ev.set()
            return
        try:
            if self._batch is not None:
                results = self._batch([it for it, _ in items])
            else:
                results = []
                for it, _ in items:
                    try:
                        results.append((self._solo(it), None))
                    except Exception as e:  # noqa: BLE001 — per item
                        results.append((None, e))
            if len(results) != len(items):
                raise RuntimeError(
                    f"batch returned {len(results)} results for "
                    f"{len(items)} items")
        except BaseException as e:  # noqa: BLE001 — contain the fault
            with self._mu:
                self.batch_faults += 1
            if len(items) == 1:
                items[0][1]._resolve(exc=e)
                return
            # A batch carries items of unrelated requests: retry each
            # solo, and only those that fail again get an error.
            for it, h in items:
                try:
                    res = self._solo(it)
                except BaseException as me:  # noqa: BLE001 — its own
                    h._resolve(exc=me)
                else:
                    h._resolve(res=res)
                with self._mu:
                    self.member_retries += 1
            return
        for (_, h), (res, exc) in zip(items, results):
            h._resolve(res=res, exc=exc)
        with self._mu:
            self.dispatches += 1
            self.items += len(items)
            self.max_items = max(self.max_items, len(items))
            self._ema = 0.75 * self._ema + 0.25 * len(items)
        _count(lane_dispatches=1)

    # -- lifecycle -----------------------------------------------------------

    def close(self) -> None:
        with self._mu:
            self._stopped = True
            victims = [h for _, h in self._queue]
            self._queue.clear()
            self._work.notify_all()
            self._space.notify_all()
        for h in victims:
            h._resolve(exc=RuntimeError("metadata lane closed"))

    def stats(self) -> dict:
        with self._mu:
            return {
                "dispatches": self.dispatches,
                "items": self.items,
                "max_items": self.max_items,
                "inline_ops": self.inline_ops,
                "batch_faults": self.batch_faults,
                "member_retries": self.member_retries,
                "handed_back": self.handed_back,
                "occupancy": (self.items / self.dispatches
                              if self.dispatches else 0.0),
                "pending": len(self._queue),
                "broken": self._broken is not None,
            }


class MetaBatcher:
    """One write lane and one read lane per drive, and the request-level
    in-flight counters that engage packing (an idle submit runs inline,
    so queue depth alone cannot show concurrency)."""

    def __init__(self):
        self._mu = threading.Lock()
        # (id(drive), kind) -> (drive, lane); the drive reference keeps
        # the id stable for the lane's life.
        self._lanes: dict[tuple, tuple] = {}
        self._closed = False
        self._inflight_puts = 0
        self._inflight_reads = 0

    # -- lanes -----------------------------------------------------------------

    def _lane(self, drive, kind: str, solo_fn, batch_fn,
              min_batch: int = 1) -> MetaLane:
        key = (id(drive), kind)
        got = self._lanes.get(key)
        if got is not None:
            return got[1]
        with self._mu:
            got = self._lanes.get(key)
            if got is None:
                name = f"{getattr(drive, 'root', '?')}-{kind}"
                lane = MetaLane(os.path.basename(str(name)) or name,
                                solo_fn, batch_fn, min_batch)
                if self._closed:
                    lane._stopped = True
                got = self._lanes[key] = (drive, lane)
        return got[1]

    def write_lane(self, drive) -> MetaLane:
        def solo(item):
            vol, obj, fi = item
            drive.write_metadata(vol, obj, fi)

        wmm = getattr(drive, "write_metadata_many", None)

        def batch(items):
            return [(None, e) for e in wmm(items)]

        return self._lane(drive, "write", solo,
                          batch if wmm is not None else None,
                          JOURNAL_MIN_ITEMS)

    def read_lane(self, drive) -> MetaLane:
        def solo(item):
            vol, obj, vid = item
            fi = drive.read_version(vol, obj, vid)
            record_read_round(1, 1)
            return fi

        rvm = getattr(drive, "read_version_many", None)

        def batch(items):
            out = rvm(items)
            record_read_round(1, len(items))
            return out

        return self._lane(drive, "read", solo,
                          batch if rvm is not None else None)

    def submit_write(self, drive, vol: str, obj: str, fi) -> MetaHandle:
        return self.write_lane(drive).submit((vol, obj, fi))

    def submit_read(self, drive, vol: str, obj: str,
                    version_id: str) -> MetaHandle:
        return self.read_lane(drive).submit((vol, obj, version_id))

    # -- ignition ----------------------------------------------------------------

    def note_put(self, delta: int) -> None:
        with self._mu:
            self._inflight_puts += delta

    def note_read(self, delta: int) -> None:
        with self._mu:
            self._inflight_reads += delta

    @contextlib.contextmanager
    def reading(self):
        """One metadata-reading request in flight, counted once on its
        thread however many layers note it (the HEAD/GET handler around
        the engine's election)."""
        outer = not getattr(_TLS, "reading", False)
        if outer:
            _TLS.reading = True
            self.note_read(1)
        try:
            yield
        finally:
            if outer:
                self.note_read(-1)
                _TLS.reading = False

    def _busy(self, kind: str) -> bool:
        return any(lane.busy() for (_, k), (_, lane)
                   in list(self._lanes.items()) if k == kind)

    def put_hot(self) -> bool:
        """Whether a small PUT's publish fan-out should go through the
        write lanes (likely to group-commit) rather than the single-op
        fan-out."""
        return self._inflight_puts > 1 or self._busy("write")

    def read_hot(self) -> bool:
        return self._inflight_reads > 1 or self._busy("read")

    # -- lifecycle ---------------------------------------------------------------

    def close(self) -> None:
        with self._mu:
            self._closed = True
            lanes = [lane for _, lane in self._lanes.values()]
        for lane in lanes:
            lane.close()

    def stats(self) -> dict:
        out = {"dispatches": 0, "items": 0, "inline_ops": 0,
               "batch_faults": 0, "member_retries": 0, "handed_back": 0,
               "max_items": 0, "lanes": 0}
        for _, lane in list(self._lanes.values()):
            st = lane.stats()
            out["lanes"] += 1
            for k in ("dispatches", "items", "inline_ops", "batch_faults",
                      "member_retries", "handed_back"):
                out[k] += st[k]
            out["max_items"] = max(out["max_items"], st["max_items"])
        out["occupancy"] = (out["items"] / out["dispatches"]
                            if out["dispatches"] else 0.0)
        return out


# -- the process's batcher -----------------------------------------------------

_MB: MetaBatcher | None = None
_MB_MU = threading.Lock()
_TLS = threading.local()


def get() -> MetaBatcher:
    global _MB
    mb = _MB
    if mb is None:
        with _MB_MU:
            if _MB is None:
                _MB = MetaBatcher()
            mb = _MB
    return mb


def reset() -> None:
    """Close the batcher (its dispatchers exit), so the next get()
    starts from cold lanes."""
    global _MB
    with _MB_MU:
        if _MB is not None:
            _MB.close()
        _MB = None


def _reset_after_fork() -> None:
    # A forked child inherits the batcher but not its dispatcher
    # threads: its submits would queue forever.
    global _MB
    _MB = None


os.register_at_fork(after_in_child=_reset_after_fork)
