"""Cross-request dispatch coalescing for the erasure and bitrot data plane
(torch).

Counterpart of minio_tpu/ops/coalesce.py.  In
a worker of the pre-fork pool (server/workers.py) `attach_remote`
installs the cross-process front end (ops/ipc_dispatch.RemoteCoalescer)
as what `get()` returns: the engine's call sites are unchanged, and
their device batches go to the device owner's lanes.

Concurrent requests submit their device work (a PUT batch's encode, a
GET's verify, a degraded GET's or a heal's verify + rebuild) to one
`DispatchLane` per card; the lane packs compatible items from every
request into one launch and hands each request its slice back through a
`Handle`.  `DispatchCoalescer` routes each submit to the lane of the
submitting set's card (`devices.n_devices()` lanes).

Scheduling contract (per lane), as in the reference:

- items are compatible when they share a key `(kind, k, m, algo,
  shard_size, ...)`: the same kernels at the same geometry, so their
  block axes concatenate;
- the key whose head item is oldest is served first (FIFO across keys),
  and a head item larger than the batch budget dispatches alone;
- an idle lane runs a submit inline on the caller's thread (and stream):
  a lone request pays no hand-off.  Under load the lane thread holds the
  head item up to MTPU_COALESCE_WINDOW_US for company when the occupancy
  EMA shows packing; arrivals during a launch join the next batch;
- submit() blocks while the queued weight exceeds QUEUE_FACTOR times the
  budget (backpressure);
- a packed batch that fails is retried member by member, so one poisoned
  member fails only itself; a dispatcher thread that dies fails every
  queued handle and later submits run inline.

Pipelined dispatch (MTPU_H2D_PIPELINE, ops/devcache.py): the lane thread
packs each batch into one of two staging buffers (pinned on a card),
copies it to the card with a non-blocking copy on the lane's own CUDA
stream, launches the kernels on that stream, and only then resolves the
previous batch, so this batch's packing and copy overlap the previous
batch's kernels.  An event recorded after each copy guards its buffer: it
is packed again only once that copy is complete.  The stream is created
on the lane thread's first pipelined dispatch, never at import or before
a fork.  Inline and serial dispatches run on the caller's current stream
and sync before they return.

Tracing (observe/span.py): the lane thread carries no request context,
so the programs it runs open no span and never wait for the card; the
submitter's `Handle.result()` records the item's queue wait as a
`coalesce.wait` child of whatever span the caller is in, and an inline
dispatch runs the program on the caller's thread, where its
`device.*` span nests under the caller's stage span.

`pad_batch` is the reference's padding of a batch to a multiple of its
jit-shape bucket; the port's kernels take any batch, so the engine pads
to a multiple of 1 (ROADMAP Queue C: a divergence with the same bytes).

Env (read per call):

- MTPU_COALESCE=0 turns coalescing off: the direct-dispatch oracle;
- MTPU_COALESCE_WINDOW_US: the longest the oldest queued item waits for
  company once the window engages (default 250);
- MTPU_COALESCE_MAX_BATCH: the batch budget in 1 MiB-block weight units
  (default 64).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import deque

import numpy as np
import torch

from ..observe import span as ospan
from . import devcache, devices


def enabled() -> bool:
    return os.environ.get("MTPU_COALESCE", "1") != "0"


def window_s() -> float:
    try:
        us = float(os.environ.get("MTPU_COALESCE_WINDOW_US", "250"))
    except ValueError:
        us = 250.0
    return max(0.0, us) / 1e6


def max_batch() -> int:
    try:
        return max(1, int(os.environ.get("MTPU_COALESCE_MAX_BATCH", "64")))
    except ValueError:
        return 64


def pad_batch(x: np.ndarray, multiple: int) -> tuple[np.ndarray, int]:
    """Zero-pad axis 0 up to the next multiple of `multiple`.  Returns
    (padded, original_n); `x` itself when nothing is added."""
    n = x.shape[0]
    pad = (-n) % multiple
    if not pad:
        return x, n
    return np.concatenate(
        [x, np.zeros((pad,) + x.shape[1:], dtype=x.dtype)]), n


# -- module counters ----------------------------------------------------------

_COUNTERS_MU = threading.Lock()
_COUNTERS = {"co_fallbacks": 0, "co_faults": 0}


def _count(name: str, n: int = 1) -> None:
    with _COUNTERS_MU:
        _COUNTERS[name] += n


def record_co_fallback() -> None:
    """A request recomputed a failed handle's item through the direct
    path."""
    _count("co_fallbacks")


def stats() -> dict:
    """Process-wide counters: co_fallbacks (direct recomputes after a
    failed handle) and co_faults (items of batches that faulted).  The
    dispatches and their items are each lane's (`DispatchLane.stats`),
    which the metrics registry renders."""
    with _COUNTERS_MU:
        return dict(_COUNTERS)


class _BufPool:
    """Free-list of uint8 scratch buffers a kernel may rent for a large
    output that outlives the dispatch (released with the last handle)."""

    KEEP = 4

    def __init__(self):
        self._mu = threading.Lock()
        self._bufs: list[np.ndarray] = []

    def rent(self, nbytes: int) -> np.ndarray:
        with self._mu:
            for i, b in enumerate(self._bufs):
                if b.size >= nbytes:
                    return self._bufs.pop(i)
        return np.empty(nbytes, dtype=np.uint8)

    def give(self, buf: np.ndarray) -> None:
        with self._mu:
            self._bufs.append(buf)
            if len(self._bufs) > self.KEEP:
                self._bufs.sort(key=lambda b: b.size)
                self._bufs.pop(0)       # drop the smallest


class DispatchCtx:
    """Per-dispatch context handed to kernels.  `rent()` borrows a pooled
    scratch buffer, returned to the pool once every item of the dispatch
    has been release()d (an unreleased handle forfeits reuse only)."""

    __slots__ = ("_pool", "_mu", "_refs", "buf")

    def __init__(self, pool: _BufPool, nitems: int):
        self._pool = pool
        self._mu = threading.Lock()
        self._refs = nitems
        self.buf = None

    def rent(self, nbytes: int) -> np.ndarray:
        self.buf = self._pool.rent(nbytes)
        return self.buf

    def _deref(self) -> None:
        with self._mu:
            self._refs -= 1
            done = self._refs == 0
        if done and self.buf is not None:
            self._pool.give(self.buf)
            self.buf = None


class Handle:
    """Future for one submitted item.  `result()` waits (bounded) for the
    lane to resolve it; `release()` says the caller is done with any
    pooled buffer the result aliases."""

    __slots__ = ("_ev", "_res", "_exc", "_t_enq", "_t_disp", "_ctx",
                 "weight", "nrows")

    #: The span the caller's wait is recorded under.
    WAIT_SPAN = "coalesce.wait"

    def __init__(self, weight: int, nrows: int):
        self._ev = threading.Event()
        self._res = None
        self._exc: BaseException | None = None
        self._t_enq = time.monotonic()
        self._t_disp: float | None = None
        self._ctx: DispatchCtx | None = None
        self.weight = weight
        self.nrows = nrows

    def result(self, timeout: float | None = 120.0):
        if not self._ev.wait(timeout):
            raise TimeoutError("coalesced dispatch did not complete")
        if self._t_disp is not None:
            ospan.record(self.WAIT_SPAN,
                         max(0.0, self._t_disp - self._t_enq))
            self._t_disp = None
        if self._exc is not None:
            raise self._exc
        return self._res

    def release(self) -> None:
        ctx, self._ctx = self._ctx, None
        if ctx is not None:
            ctx._deref()


class DispatchLane:
    """One card's scheduler: per-key FIFO queues and one daemon dispatcher
    thread, started on the first queued submit.  Queues, occupancy EMA,
    staging, stream and stats are the lane's own."""

    #: Queued-weight cap as a multiple of the batch budget; beyond it
    #: submit() blocks.
    QUEUE_FACTOR = 4

    def __init__(self, device):
        self.device = torch.device(device)
        self.index = devcache.card_index(self.device)
        self._cuda = self.device.type == "cuda"
        self._mu = threading.Lock()
        self._work = threading.Condition(self._mu)
        self._space = threading.Condition(self._mu)
        self._queues: dict[tuple, deque] = {}
        self._fns: dict[tuple, object] = {}
        self._pending_weight = 0
        self._pending_items = 0
        self._dispatching = False
        self._inline = 0
        self._inflight_reads = 0
        # Occupancy EMA: ~1 means lone requests (fire at once), > 1 that
        # concurrent traffic packs (waiting the window pays).
        self._ema = 1.0
        self._thread: threading.Thread | None = None
        self._stopped = False
        # The fatal exception if the dispatcher thread died: queued
        # handles were failed and later submits run inline.
        self._broken: BaseException | None = None
        self._bufs = _BufPool()
        # Pipeline state, private to the lane thread: the lane's stream,
        # two staging slots of (host buffer, event of its last copy), and
        # at most one launched batch not yet resolved.
        self._stream = None
        self._staging: list = [(None, None), (None, None)]
        self._staging_flip = 0
        self._pending: tuple | None = None
        self.dispatches = 0
        self.inline_dispatches = 0
        self.items = 0
        self.weight = 0
        self.wait_s = 0.0
        self.max_items = 0
        self.batch_faults = 0
        self.member_retries = 0
        self.h2d_bytes = 0
        self.h2d_dispatches = 0
        self.pipeline_dispatches = 0
        self.pack_s = 0.0
        self.h2d_s = 0.0
        self.resolve_s = 0.0
        self.overlap_s = 0.0

    # -- submission ----------------------------------------------------------

    def submit(self, key: tuple, payload: np.ndarray, fn,
               weight: int | None = None) -> Handle:
        """Queue one item.  `payload` is its batch (axis 0 concatenates);
        `fn(stacked, spans, ctx)` computes a packed batch and returns one
        result per (lo, hi) span, and `fn.launch(x, n, spans, ctx)`, where
        present, is its pipelined form (`x` staged on the card, returns a
        resolve() that yields the results).  `weight` is the item's cost
        in budget units (default: axis-0 length).  Every submitter of a
        key passes an equivalent fn: the key names all it closes over."""
        payload = np.asarray(payload)
        nrows = int(payload.shape[0]) if payload.ndim else 1
        h = Handle(int(weight) if weight is not None else nrows, nrows)
        cap = self.QUEUE_FACTOR * max_batch()
        with self._mu:
            if self._stopped:
                raise RuntimeError("coalescer closed")
            # Idle: nothing queued or in flight and no recent packing.
            # Run on this thread; a concurrent submit sees `_inline` and
            # queues, so packing starts as soon as two requests overlap.
            inline = (self._broken is not None
                      or (not self._pending_items and not self._dispatching
                          and self._inline == 0 and self._ema <= 1.05))
            if inline:
                self._inline += 1
            else:
                if self._thread is None:
                    self._thread = threading.Thread(
                        target=self._loop,
                        name=f"mtpu-coalesce-{self.device}", daemon=True)
                    self._thread.start()
                # An item never waits on its own weight: a single
                # oversized item is always admissible.
                while self._pending_weight and \
                        self._pending_weight + h.weight > cap:
                    self._space.wait(0.05)
                    cap = self.QUEUE_FACTOR * max_batch()
                q = self._queues.get(key)
                if q is None:
                    q = self._queues[key] = deque()
                self._fns[key] = fn
                q.append((payload, h))
                self._pending_weight += h.weight
                self._pending_items += 1
                self._work.notify()
        if inline:
            try:
                self._dispatch([(payload, h)], h.weight, fn, inline=True)
            finally:
                with self._mu:
                    self._inline -= 1
        return h

    # -- routing signals -----------------------------------------------------

    def hot(self) -> bool:
        """Whether more work through this lane is likely to pack: work
        queued or dispatching, recent dispatches packed > 1 item, or more
        than one read in flight."""
        return (self._pending_items > 0 or self._dispatching
                or self._inline > 0 or self._ema > 1.05
                or self._inflight_reads > 1)

    def note_read(self, delta: int) -> None:
        """Reads in flight (a storm of GETs queues no encode work, so the
        queue alone cannot make hot() true)."""
        with self._mu:
            self._inflight_reads += delta

    # -- dispatcher ----------------------------------------------------------

    def _queue_weight(self, q: deque) -> int:
        return sum(h.weight for _, h in q)

    def _pick_key(self):
        oldest_key, oldest_t = None, None
        for key, q in self._queues.items():
            if q and (oldest_t is None or q[0][1]._t_enq < oldest_t):
                oldest_key, oldest_t = key, q[0][1]._t_enq
        return oldest_key

    def _loop(self) -> None:
        try:
            while True:
                do_drain = False
                with self._mu:
                    key = self._pick_key()
                    while key is None:
                        if self._pending is not None:
                            # A launch is in flight: give new work one
                            # window to arrive, then resolve it; never
                            # park with an unresolved launch.
                            self._work.wait(window_s() or 0.0005)
                            key = self._pick_key()
                            if key is None:
                                do_drain = True
                            break
                        if self._stopped:
                            return
                        self._work.wait()
                        key = self._pick_key()
                    if not do_drain:
                        q = self._queues[key]
                        budget = max_batch()
                        # Wait for company only when the EMA shows
                        # packing, bounded by the head item's age; with a
                        # launch in flight, pack now.
                        if (self._pending is None and self._ema > 1.05
                                and self._queue_weight(q) < budget):
                            deadline = q[0][1]._t_enq + window_s()
                            while (self._queue_weight(q) < budget
                                   and not self._stopped):
                                left = deadline - time.monotonic()
                                if left <= 0:
                                    break
                                self._work.wait(left)
                        items: list[tuple] = []
                        w = 0
                        while q and (not items
                                     or w + q[0][1].weight <= budget):
                            payload, h = q.popleft()
                            items.append((payload, h))
                            w += h.weight
                        self._pending_weight -= w
                        self._pending_items -= len(items)
                        fn = self._fns[key]
                        self._dispatching = True
                        self._space.notify_all()
                if do_drain:
                    self._drain_pipeline()
                else:
                    self._dispatch(items, w, fn, pipelined=True)
                with self._mu:
                    # Stay "dispatching" while a launch is unresolved, so
                    # an inline submit cannot overtake it.
                    self._dispatching = self._pending is not None
        except BaseException as e:  # noqa: BLE001 — dispatcher death
            # _dispatch contains kernel faults itself; what escapes here
            # is the scheduler dying.  Fail everything queued, re-raise
            # only an interrupt.
            self._abort(e)
            if not isinstance(e, Exception):
                raise

    def _abort(self, exc: BaseException) -> None:
        """Dispatcher death: fail every queued and launched handle, and
        run later submits inline."""
        with self._mu:
            self._broken = exc
            victims: list[Handle] = []
            pending, self._pending = self._pending, None
            if pending is not None:
                victims.extend(h for _, h in pending[1])
            for q in self._queues.values():
                victims.extend(h for _, h in q)
                q.clear()
            self._queues.clear()
            self._fns.clear()
            self._pending_weight = 0
            self._pending_items = 0
            self._dispatching = False
            self._space.notify_all()
            self._work.notify_all()
        err = RuntimeError(f"coalescer dispatcher died: {exc!r}")
        for h in victims:
            h._exc = err
            h._ev.set()

    def _spans(self, items: list[tuple]) -> list[tuple[int, int]]:
        spans, lo = [], 0
        for _, h in items:
            spans.append((lo, lo + h.nrows))
            lo += h.nrows
        return spans

    def _retry_members(self, items: list[tuple], fn) -> None:
        """A packed batch faulted: run each member alone, so only the
        guilty member(s) keep an exception."""
        _count("co_faults", len(items))
        for payload, h in items:
            mctx = DispatchCtx(self._bufs, 1)
            try:
                res = fn(payload, [(0, h.nrows)], mctx)[0]
            except Exception as me:  # noqa: BLE001 — the guilty member
                if mctx.buf is not None:
                    self._bufs.give(mctx.buf)
                    mctx.buf = None
                h._exc = me
            else:
                h._ctx = mctx
                h._res = res
            with self._mu:
                self.member_retries += 1
            h._ev.set()

    def _deliver(self, items: list[tuple], w: int, results, ctx,
                 t_disp: float) -> None:
        wait_sum = 0.0
        for (_, h), res in zip(items, results):
            wait_sum += t_disp - h._t_enq
            h._t_disp = t_disp
            h._ctx = ctx
            h._res = res
            h._ev.set()
        with self._mu:
            self.dispatches += 1
            self.items += len(items)
            self.weight += w
            self.wait_s += wait_sum
            self.max_items = max(self.max_items, len(items))
            self._ema = 0.75 * self._ema + 0.25 * len(items)

    def _dispatch(self, items: list[tuple], w: int, fn,
                  pipelined: bool = False, inline: bool = False) -> None:
        if pipelined:
            launch = getattr(fn, "launch", None)
            if launch is not None and devcache.h2d_pipeline_enabled():
                if self._dispatch_pipelined(items, w, fn, launch):
                    return
            # A serial dispatch from the lane thread must not overtake a
            # pending launch (per-key FIFO): resolve it first.
            if self._pending is not None:
                self._drain_pipeline()
        t_disp = time.monotonic()
        ctx = DispatchCtx(self._bufs, len(items))
        try:
            if len(items) == 1:
                stacked = items[0][0]
            else:
                stacked = np.concatenate([p for p, _ in items], axis=0)
            results = fn(stacked, self._spans(items), ctx)
        except Exception as e:  # noqa: BLE001 — contain the fault
            if ctx.buf is not None:
                self._bufs.give(ctx.buf)
                ctx.buf = None
            with self._mu:
                self.batch_faults += 1
            if len(items) == 1:
                _count("co_faults")
                h = items[0][1]
                h._exc = e
                h._ev.set()
                return
            self._retry_members(items, fn)
            return
        if inline:
            with self._mu:
                self.inline_dispatches += 1
        self._deliver(items, w, results, ctx, t_disp)

    # -- pinned, double-buffered staging ---------------------------------------

    def _stream_ctx(self):
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def _staging_slot(self, slot: int, nbytes: int) -> torch.Tensor:
        """The slot's host buffer, at least `nbytes` long, once the copy
        that last read it is complete (pinned on a card; plain memory on
        the CPU, where pinning needs CUDA)."""
        buf, ev = self._staging[slot]
        if ev is not None:
            ev.synchronize()
        if buf is None or buf.numel() < nbytes:
            buf = torch.empty(nbytes, dtype=torch.uint8,
                              pin_memory=self._cuda)
        self._staging[slot] = (buf, None)
        return buf

    def _dispatch_pipelined(self, items: list[tuple], w: int, fn,
                            launch) -> bool:
        """Pack the batch into the spare staging buffer, copy it to the
        card on the lane's stream, launch the kernels there, then resolve
        the previous launch: this batch's host work overlaps the previous
        batch's kernels.  Returns False (nothing dispatched) when the
        batch cannot be staged or the launch raised; the caller then
        dispatches it serially."""
        first = items[0][0]
        if first.dtype != np.uint8 or first.ndim < 2:
            return False
        row_shape = first.shape[1:]
        row_bytes = int(np.prod(row_shape))
        if row_bytes <= 0:
            return False
        for p, _ in items:
            if p.dtype != np.uint8 or p.shape[1:] != row_shape:
                return False
        t0 = time.monotonic()
        if self._cuda and self._stream is None:
            self._stream = torch.cuda.Stream(device=self.device)
        n = sum(h.nrows for _, h in items)
        mult = int(getattr(fn, "pad_rows", 1) or 1)
        padded = n + (-n) % mult
        need = padded * row_bytes
        slot = self._staging_flip
        self._staging_flip ^= 1
        host = self._staging_slot(slot, need)[:need]
        view = host.numpy().reshape((padded,) + row_shape)
        lo = 0
        for p, h in items:
            view[lo:lo + h.nrows] = p
            lo += h.nrows
        if padded > n:
            view[n:] = 0
        t_pack = time.monotonic()
        spans = self._spans(items)
        ctx = DispatchCtx(self._bufs, len(items))
        with self._stream_ctx():
            x = torch.empty((padded,) + row_shape, dtype=torch.uint8,
                            device=self.device)
            x.view(-1).copy_(host, non_blocking=self._cuda)
            if self._cuda:
                ev = torch.cuda.Event()
                ev.record(self._stream)
                self._staging[slot] = (self._staging[slot][0], ev)
            devcache.note_h2d(need, self.index)
            t_h2d = time.monotonic()
            try:
                resolve = launch(x, n, spans, ctx)
            except Exception:  # noqa: BLE001 — the serial path retries
                if ctx.buf is not None:
                    self._bufs.give(ctx.buf)
                    ctx.buf = None
                return False
        prev, self._pending = self._pending, (resolve, items, w, fn, ctx,
                                              t_pack)
        host_s = time.monotonic() - t0
        with self._mu:
            self.h2d_bytes += need
            self.h2d_dispatches += 1
            self.pipeline_dispatches += 1
            self.pack_s += t_pack - t0
            self.h2d_s += t_h2d - t_pack
            if prev is not None:
                # This batch's host work ran while `prev`'s kernels did.
                self.overlap_s += host_s
        if prev is not None:
            self._resolve(prev)
        return True

    def _drain_pipeline(self) -> None:
        pending, self._pending = self._pending, None
        if pending is not None:
            self._resolve(pending)

    def _resolve(self, pending: tuple) -> None:
        """Copy one launched batch's results back (on the lane's stream,
        which the copy syncs) and hand each item its slice."""
        resolve, items, w, fn, ctx, t_disp = pending
        t0 = time.monotonic()
        try:
            with self._stream_ctx():
                results = resolve()
        except Exception:  # noqa: BLE001 — contain the fault
            if ctx.buf is not None:
                self._bufs.give(ctx.buf)
                ctx.buf = None
            with self._mu:
                self.batch_faults += 1
            self._retry_members(items, fn)
            with self._mu:
                self.resolve_s += time.monotonic() - t0
            return
        self._deliver(items, w, results, ctx, t_disp)
        with self._mu:
            self.resolve_s += time.monotonic() - t0

    # -- lifecycle / introspection ------------------------------------------

    def close(self) -> None:
        with self._mu:
            self._stopped = True
            # Queued work will never be served: fail it now.
            victims: list[Handle] = []
            for q in self._queues.values():
                victims.extend(h for _, h in q)
                q.clear()
            self._queues.clear()
            self._fns.clear()
            self._pending_weight = 0
            self._pending_items = 0
            self._work.notify_all()
            self._space.notify_all()
        for h in victims:
            h._exc = RuntimeError("coalescer closed")
            h._ev.set()

    def stats(self) -> dict:
        with self._mu:
            return {
                "device": str(self.device),
                "dispatches": self.dispatches,
                "inline_dispatches": self.inline_dispatches,
                "items": self.items,
                "weight": self.weight,
                "wait_s": self.wait_s,
                "max_items": self.max_items,
                "occupancy": (self.items / self.dispatches
                              if self.dispatches else 0.0),
                "pending_items": self._pending_items,
                "pending_weight": self._pending_weight,
                "batch_faults": self.batch_faults,
                "member_retries": self.member_retries,
                "h2d_bytes": self.h2d_bytes,
                "h2d_dispatches": self.h2d_dispatches,
                "pipeline_dispatches": self.pipeline_dispatches,
                "pack_s": self.pack_s,
                "h2d_s": self.h2d_s,
                "resolve_s": self.resolve_s,
                "overlap_s": self.overlap_s,
                "broken": self._broken is not None,
            }


_SUMMED = ("dispatches", "inline_dispatches", "items", "weight", "wait_s",
           "pending_items", "pending_weight", "batch_faults",
           "member_retries", "h2d_bytes", "h2d_dispatches",
           "pipeline_dispatches", "pack_s", "h2d_s", "resolve_s",
           "overlap_s")


class DispatchCoalescer:
    """One lane per card: a submit goes to the lane of its device
    (`cuda:i` to lane i % n_devices(), the CPU to a lane of its own);
    stats are summed over the lanes touched."""

    def __init__(self, nlanes: int | None = None):
        self._lanes_mu = threading.Lock()
        self._want_lanes = nlanes
        self._lanes: dict[torch.device, DispatchLane] = {}
        self._closed = False

    def nlanes(self) -> int:
        n = self._want_lanes
        if n is None:
            n = self._want_lanes = devices.n_devices()
        return n

    def lane(self, device=None) -> DispatchLane:
        dev = devices.resolve(device)
        if dev.type == "cuda":
            dev = torch.device("cuda", dev.index % self.nlanes())
        lane = self._lanes.get(dev)
        if lane is None:
            with self._lanes_mu:
                lane = self._lanes.get(dev)
                if lane is None:
                    lane = DispatchLane(dev)
                    if self._closed:
                        # A straggler after close (a late note_read) gets
                        # a lane that refuses submits and never hangs.
                        lane._stopped = True
                    self._lanes[dev] = lane
        return lane

    def submit(self, key: tuple, payload: np.ndarray, fn,
               weight: int | None = None, device=None) -> Handle:
        return self.lane(device).submit(key, payload, fn, weight)

    def hot(self, device=None) -> bool:
        return self.lane(device).hot()

    def note_read(self, delta: int, device=None) -> None:
        self.lane(device).note_read(delta)

    def close(self) -> None:
        with self._lanes_mu:
            self._closed = True
            lanes = list(self._lanes.values())
        for ln in lanes:
            ln.close()

    def lane_stats(self) -> dict[str, dict]:
        """Per-lane stats of the lanes touched, by device name."""
        return {str(d): ln.stats() for d, ln in list(self._lanes.items())}

    def stats(self) -> dict:
        per = self.lane_stats()
        out = dict.fromkeys(_SUMMED, 0)
        out["max_items"] = 0
        broken = False
        for st in per.values():
            for k in _SUMMED:
                out[k] += st[k]
            out["max_items"] = max(out["max_items"], st["max_items"])
            broken = broken or st["broken"]
        out["occupancy"] = (out["items"] / out["dispatches"]
                            if out["dispatches"] else 0.0)
        out["broken"] = broken
        out["n_lanes"] = self.nlanes()
        out["lanes"] = per
        return out


# -- shared kernels ----------------------------------------------------------

def make_digest_kernel(algo: str, device):
    """Bitrot digests over stacked (N, S) rows on `device`: the healthy
    GET's verify and heal's digests of rebuilt rows.  One result (rows,
    32) per span."""
    from . import fused

    def kernel(stacked, spans, ctx):
        out = fused.hash_rows(stacked, algo, device=device,
                              items=len(spans)).cpu().numpy()
        return [out[lo:hi] for lo, hi in spans]

    def launch(x, n, spans, ctx):
        out_d = fused.hash_rows(x, algo, device=device, items=len(spans))

        def resolve():
            out = out_d.cpu().numpy()[:n]
            return [out[lo:hi] for lo, hi in spans]

        return resolve

    kernel.launch = launch
    return kernel


# -- process singleton -------------------------------------------------------

_CO: DispatchCoalescer | None = None
_CO_MU = threading.Lock()

#: The cross-process front end (ops/ipc_dispatch.RemoteCoalescer) a pool
#: worker attaches: while set, `get()` returns it, and it routes the
#: device kinds to the owner and the rest to this process's own lanes.
_REMOTE = None


def get():
    r = _REMOTE
    if r is not None:
        return r
    global _CO
    co = _CO
    if co is None:
        with _CO_MU:
            if _CO is None:
                _CO = DispatchCoalescer()
            co = _CO
    return co


def attach_remote(remote) -> None:
    """Install a cross-process front end as this process's coalescer;
    detach_remote() restores in-process dispatch."""
    global _REMOTE
    _REMOTE = remote


def detach_remote() -> None:
    global _REMOTE
    r, _REMOTE = _REMOTE, None
    if r is not None:
        r.close()


def reset() -> None:
    """Retire the singleton (its lane threads exit), so a flag change
    starts from a cold scheduler."""
    global _CO
    with _CO_MU:
        if _CO is not None:
            _CO.close()
        _CO = None


def _reset_after_fork() -> None:
    # A forked child inherits the singleton but not its lane threads, and
    # cannot use the parent's CUDA streams: it builds fresh lanes.  A
    # remote front end's listener thread and pending handles stay behind
    # in the parent too.
    global _CO, _REMOTE
    _CO = None
    _REMOTE = None


os.register_at_fork(after_in_child=_reset_after_fork)
