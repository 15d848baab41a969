"""Reconstruct-pipeline primitives for heal.

Counterpart of minio_tpu/parallel/pipeline.py (`prefetch_map` :36,
`StagePipeline` :71, `Frontier` :154, `run_window` :182).  Pooled calls
carry the caller's span context and deadline budget (observe/span.py
`wrap_ctx`): stage timings, and the `coalesce.wait` a stage records when
it blocks on a coalesced dispatch, attach to the request that submitted
the work, not to an anonymous pool thread.

- ``prefetch_map``: ordered map with a bounded read-ahead window, the
  parallelReader analogue (cmd/erasure-decode.go:101): batch *i+1*'s
  drive reads run while batch *i* is verified and rebuilt on the device.
- ``StagePipeline``: read → compute → write with exactly one write in
  flight, the parallelWriter analogue (cmd/erasure-encode.go:36): the
  appends of batch *i−1* overlap the device work of batch *i*.  Appends
  to one staging file must stay ordered, hence the single outstanding
  write.
- ``run_window`` + ``Frontier``: a bounded-worker ordered walk with a
  contiguous-completion frontier, so `heal_drive` checkpoints its
  HealingTracker at a resume point no unfinished object precedes (cf.
  healErasureSet's bounded workers, cmd/global-heal.go:166).

Everything runs inline when no pool is given.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import FIRST_COMPLETED, Executor, wait

from ..observe import span as ospan


def prefetch_map(fn, items, pool: Executor | None, depth: int = 1):
    """Yield ``fn(item)`` in order with up to `depth` calls in flight
    ahead of the consumer.  ``pool=None`` or ``depth<1`` runs inline."""
    if pool is None or depth < 1:
        for item in items:
            yield fn(item)
        return
    fn = ospan.wrap_ctx(fn)
    pending = []
    it = iter(items)
    try:
        for item in it:
            pending.append(pool.submit(fn, item))
            if len(pending) > depth:
                yield pending.pop(0).result()
        while pending:
            yield pending.pop(0).result()
    finally:
        # A consumer that stops early (or a result() that raised) must
        # not leak running futures into the pool.
        for f in pending:
            f.cancel()
        for f in pending:
            if not f.cancelled():
                try:
                    f.result()
                except Exception:  # noqa: BLE001 — draining
                    pass


class StagePipeline:
    """read → compute → write with one write in flight.

    ``run(reads, compute, write)`` drains `reads` (typically a
    ``prefetch_map`` generator), calls ``compute`` inline, and submits
    ``write`` to the pool keeping exactly one outstanding: batch *i*'s
    compute overlaps batch *i−1*'s appends while the append order holds.
    With ``pool=None`` every stage runs inline.

    ``on_batch(read_s, compute_s, write_s)``, when given, is called once
    per batch with the wall-clock seconds spent pulling the item from
    `reads`, in `compute` and in `write`.  With a pool the write time
    reported beside a batch is the previous batch's (they overlap by
    design); only the sums are meaningful."""

    def __init__(self, pool: Executor | None):
        self.pool = pool

    def run(self, reads, compute, write, on_batch=None) -> int:
        n = 0
        clock = time.perf_counter
        it = iter(reads)
        if self.pool is None:
            while True:
                t0 = clock()
                try:
                    item = next(it)
                except StopIteration:
                    break
                t1 = clock()
                res = compute(item)
                t2 = clock()
                write(res)
                if on_batch is not None:
                    on_batch(t1 - t0, t2 - t1, clock() - t2)
                n += 1
            return n
        wfut = None
        pend_rs = pend_cs = 0.0

        @ospan.wrap_ctx
        def timed_write(res):
            t0 = clock()
            write(res)
            return clock() - t0

        try:
            while True:
                t0 = clock()
                try:
                    item = next(it)
                except StopIteration:
                    break
                t1 = clock()
                res = compute(item)
                t2 = clock()
                if wfut is not None:
                    w_s = wfut.result()
                    wfut = None
                    if on_batch is not None:
                        on_batch(pend_rs, pend_cs, w_s)
                pend_rs, pend_cs = t1 - t0, t2 - t1
                wfut = self.pool.submit(timed_write, res)
                n += 1
            if wfut is not None:
                w_s = wfut.result()
                wfut = None
                if on_batch is not None:
                    on_batch(pend_rs, pend_cs, w_s)
        finally:
            # compute or read raised with a write still in flight: the
            # caller is about to clean up staging files, so let the
            # append land first.
            if wfut is not None:
                try:
                    wfut.result()
                except Exception:  # noqa: BLE001 — the first error wins
                    pass
        return n


class Frontier:
    """Contiguous-completion tracker for out-of-order workers.

    ``mark(i)`` records that item *i* completed; ``position`` is the
    count of contiguously completed items from 0, the only safe
    checkpoint under concurrency (an interrupted run may have healed
    items beyond the frontier; healing them again on resume is a no-op,
    skipping an unfinished one would lose data).  Thread-safe."""

    def __init__(self):
        self._done: set[int] = set()
        self._next = 0
        self._mu = threading.Lock()

    def mark(self, i: int) -> int:
        with self._mu:
            self._done.add(i)
            while self._next in self._done:
                self._done.discard(self._next)
                self._next += 1
            return self._next

    @property
    def position(self) -> int:
        with self._mu:
            return self._next


def run_window(fn, items, pool: Executor | None, window: int,
               stop: threading.Event | None = None):
    """Run ``fn(item)`` over ordered `items` with at most `window` in
    flight; yield ``(idx, item, result, err)`` as each completes
    (completion order, not submission order).

    Bounded by construction: `items` may be a lazy iterator of any
    length; at most `window` tasks exist at once.  Setting `stop` halts
    new submissions and lets the tasks in flight drain.  With
    ``pool=None`` or ``window<=1`` items run inline, and `stop` is
    checked between items."""
    if pool is None or window <= 1:
        for idx, item in enumerate(items):
            if stop is not None and stop.is_set():
                return
            try:
                yield idx, item, fn(item), None
            except Exception as e:  # noqa: BLE001 — the caller classifies
                yield idx, item, None, e
        return

    it = enumerate(items)
    futs = {}
    pooled_fn = ospan.wrap_ctx(fn)

    def submit_next() -> bool:
        if stop is not None and stop.is_set():
            return False
        try:
            idx, item = next(it)
        except StopIteration:
            return False
        futs[pool.submit(pooled_fn, item)] = (idx, item)
        return True

    for _ in range(window):
        if not submit_next():
            break
    while futs:
        done, _ = wait(list(futs), return_when=FIRST_COMPLETED)
        for f in done:
            idx, item = futs.pop(f)
            err = f.exception()
            yield idx, item, (None if err is not None else f.result()), err
        while len(futs) < window:
            if not submit_next():
                break
