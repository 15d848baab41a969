"""The port's copy of minio_tpu/observe/span.py (it imports nothing of
the JAX package).

Request-scoped span trees: the madmin trace / `mc admin top apis`
observability plane (cf. cmd/admin-handlers.go TraceHandler and
internal/pubsub usage in the reference).

A request opens ONE root span (``TRACER.root("api.PutObject", ...)``);
code anywhere below it on the same logical call chain opens nested
stage spans with the module-level ``span("engine.encode")`` helper, or
attaches pre-measured timings with ``record(name, seconds)`` (the
StagePipeline ``on_batch`` bridge).  Span placement rides contextvars,
so the tree needs no plumbing through call signatures; fan-out code
that jumps threads wraps the worker callable in ``wrap_ctx`` to carry
the current span across.

Cost model (the whole point):

- Tracing OFF (no subscriber, no retention ring): ``TRACER.root`` is a
  bool check returning the shared ``NOOP`` singleton, and ``span()`` /
  ``record()`` are a single contextvar read — no Span object is ever
  allocated (``SPAN_ALLOCS`` is the test sentinel for that).
- Tracing ON: spans cost one object + two perf_counter reads each, paid
  only by requests actually being traced (``MTPU_TRACE_SAMPLE``
  down-samples root creation; untraced requests fall back to NOOP).

Completed root spans become plain-dict trace records that fan out to:
a bounded ring of recent traces (``MTPU_TRACE_RING``, newest-N kept),
live PubSub subscribers (the admin NDJSON stream), and per-API
aggregates (latency percentiles + per-stage duration histograms served
by ``GET /minio/admin/v3/top/apis`` and the Prometheus exporter).
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from contextvars import ContextVar

from .trace import PubSub

_current: ContextVar = ContextVar("mtpu_span", default=None)

#: Request-scoped vars other layers register (rpc.rest's deadline
#: budget) so wrap_ctx carries them across pool hops alongside the span
#: — fan-out workers run in their own contextvars context and would
#: otherwise silently drop the caller's request scope.
_CARRIED: list[ContextVar] = []


def carry_var(var: ContextVar) -> None:
    """Register a contextvar for cross-thread carry in wrap_ctx.  The
    var's default must be None (None values are not re-set in the
    worker, keeping the all-defaults path zero-cost)."""
    if var not in _CARRIED:
        _CARRIED.append(var)

#: Counts every Span.__init__ — the tests' allocation sentinel proving
#: the disabled path never materialises span objects.
SPAN_ALLOCS = 0

#: Bound on children held per span: a pathological stream can emit
#: unbounded per-batch spans; beyond this the tree drops the extras
#: (durations still aggregate via record()'s parent check failing last).
MAX_CHILDREN = 4096


class _NoopSpan:
    """Shared do-nothing span for the disabled path. One instance,
    no state, so ``with span(...)`` costs no allocation when off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def tag(self, **kw):
        return self


NOOP = _NoopSpan()


class Span:
    __slots__ = ("name", "tags", "t0", "dur_s", "children",
                 "_parent", "_token", "_tracer")

    def __init__(self, tracer, name: str, tags: dict | None = None):
        global SPAN_ALLOCS
        SPAN_ALLOCS += 1
        self._tracer = tracer
        self.name = name
        self.tags = tags if tags is not None else {}
        self.t0 = 0.0
        self.dur_s = 0.0
        self.children: list[Span] = []
        self._parent = None
        self._token = None

    def tag(self, **kw):
        self.tags.update(kw)
        return self

    def __enter__(self):
        self._parent = _current.get()
        self._token = _current.set(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, et, ev, tb):
        self.dur_s = time.perf_counter() - self.t0
        try:
            _current.reset(self._token)
        except ValueError:
            # Entered in one context, exited in another (thread hop):
            # restore the parent by value instead.
            _current.set(self._parent)
        p = self._parent
        if p is not None:
            if len(p.children) < MAX_CHILDREN:
                p.children.append(self)
        else:
            self._tracer._finish_root(self, et is not None)
        return False

    def to_dict(self) -> dict:
        d = {"name": self.name, "dur_ms": round(self.dur_s * 1e3, 4)}
        if self.tags:
            d["tags"] = dict(self.tags)
        if self.children:
            d["spans"] = [c.to_dict() for c in self.children]
        return d


class TraceFilter:
    """The three server-side stream filters of `mc admin trace`:
    errors-only, request-path prefix, minimum root duration."""

    __slots__ = ("err_only", "path_prefix", "min_ms")

    def __init__(self, err_only: bool = False, path_prefix: str = "",
                 min_ms: float = 0.0):
        self.err_only = err_only
        self.path_prefix = path_prefix
        self.min_ms = min_ms

    @classmethod
    def from_query(cls, query: dict) -> "TraceFilter":
        err = str(query.get("err", query.get("errOnly", ""))
                  ).lower() in ("1", "true", "yes", "on")
        prefix = query.get("path", query.get("prefix", ""))
        try:
            # minio's threshold is a duration string; accept plain ms.
            min_ms = float(query.get("min-duration-ms",
                                     query.get("threshold", 0)) or 0)
        except ValueError:
            min_ms = 0.0
        return cls(err_only=err, path_prefix=prefix, min_ms=min_ms)

    def matches(self, rec: dict) -> bool:
        if self.err_only and not rec.get("error"):
            return False
        if self.path_prefix:
            path = str(rec.get("tags", {}).get("path", ""))
            if not path.startswith(self.path_prefix):
                return False
        if self.min_ms and rec.get("dur_ms", 0.0) < self.min_ms:
            return False
        return True


#: Stage-duration histogram bucket upper bounds, milliseconds.
BUCKETS_MS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0,
              50.0, 100.0, 250.0, 1000.0, float("inf"))

_MAX_APIS = 128        # aggregate cardinality bounds (hostile paths)
_MAX_STAGES = 64
_PCTL_WINDOW = 512     # per-API root durations kept for percentiles


class _ApiAgg:
    __slots__ = ("count", "errors", "total_ms", "durs_ms", "stages")

    def __init__(self):
        self.count = 0
        self.errors = 0
        self.total_ms = 0.0
        self.durs_ms: deque = deque(maxlen=_PCTL_WINDOW)
        # stage name -> [count, total_ms, per-bucket counts]
        self.stages: dict[str, list] = {}


def _pctl(sorted_ms: list, q: float) -> float:
    if not sorted_ms:
        return 0.0
    i = min(len(sorted_ms) - 1, int(q * (len(sorted_ms) - 1) + 0.5))
    return sorted_ms[i]


class SpanTracer:
    """Process-global span sink: retention ring + live PubSub + per-API
    aggregates.  ``enabled`` is a plain bool re-derived on every
    configure/subscribe change so the request path reads one attribute."""

    def __init__(self):
        self.pubsub = PubSub()
        self._mu = threading.Lock()
        self._ring: deque | None = None
        self._agg: dict[str, _ApiAgg] = {}
        self._stride = 1
        self._nroot = 0
        self.enabled = False
        self.configure()

    # -- configuration -------------------------------------------------------

    def configure(self, ring: int | None = None,
                  sample: float | None = None) -> None:
        """(Re)apply retention/sampling; None reads the env knobs
        MTPU_TRACE_RING (trace ring capacity, 0 = off) and
        MTPU_TRACE_SAMPLE (fraction of requests rooted, default 1)."""
        if ring is None:
            try:
                ring = int(os.environ.get("MTPU_TRACE_RING", "0") or 0)
            except ValueError:
                ring = 0
        if sample is None:
            try:
                sample = float(
                    os.environ.get("MTPU_TRACE_SAMPLE", "1") or 1)
            except ValueError:
                sample = 1.0
        with self._mu:
            old = list(self._ring) if self._ring is not None else []
            self._ring = deque(old, maxlen=ring) if ring > 0 else None
            self._stride = (max(1, round(1.0 / sample))
                            if 0.0 < sample < 1.0 else 1)
            self._refresh_enabled()

    def _refresh_enabled(self) -> None:
        self.enabled = (self._ring is not None
                        or self.pubsub.num_subscribers > 0)

    def subscribe(self, maxlen: int = 1000):
        q = self.pubsub.subscribe(maxlen)
        with self._mu:
            self._refresh_enabled()
        return q

    def unsubscribe(self, q) -> None:
        self.pubsub.unsubscribe(q)
        with self._mu:
            self._refresh_enabled()

    # -- span creation -------------------------------------------------------

    def root(self, name: str, **tags):
        """Open a request root span; NOOP when tracing is off or the
        request loses the sampling draw."""
        if not self.enabled:
            return NOOP
        if self._stride > 1:
            self._nroot += 1                 # racy increment is fine:
            if self._nroot % self._stride:   # sampling, not accounting
                return NOOP
        return Span(self, name, tags)

    # -- completion sinks ----------------------------------------------------

    def _finish_root(self, root: Span, exc: bool) -> None:
        err = exc or bool(root.tags.get("error"))
        rec = root.to_dict()
        rec["time"] = time.time()
        rec["error"] = err
        with self._mu:
            self._aggregate_locked(root, err)
            if self._ring is not None:
                self._ring.append(rec)
        self.pubsub.publish(rec)

    def _aggregate_locked(self, root: Span, err: bool) -> None:
        api = root.name
        agg = self._agg.get(api)
        if agg is None:
            if len(self._agg) >= _MAX_APIS:
                return
            agg = self._agg[api] = _ApiAgg()
        dur_ms = root.dur_s * 1e3
        agg.count += 1
        agg.errors += err
        agg.total_ms += dur_ms
        agg.durs_ms.append(dur_ms)
        stack = list(root.children)
        while stack:
            sp = stack.pop()
            st = agg.stages.get(sp.name)
            if st is None:
                if len(agg.stages) >= _MAX_STAGES:
                    stack.extend(sp.children)
                    continue
                st = agg.stages[sp.name] = [0, 0.0,
                                            [0] * len(BUCKETS_MS)]
            ms = sp.dur_s * 1e3
            st[0] += 1
            st[1] += ms
            for i, b in enumerate(BUCKETS_MS):
                if ms <= b:
                    st[2][i] += 1
                    break
            stack.extend(sp.children)

    # -- read-side -----------------------------------------------------------

    def traces(self, filt: TraceFilter | None = None) -> list[dict]:
        """Retained trace records, oldest first."""
        with self._mu:
            recs = list(self._ring) if self._ring is not None else []
        if filt is not None:
            recs = [r for r in recs if filt.matches(r)]
        return recs

    def snapshot(self) -> dict:
        """Aggregated per-API latency + stage histograms (top/apis)."""
        apis = {}
        with self._mu:
            for api, a in sorted(self._agg.items()):
                durs = sorted(a.durs_ms)
                apis[api] = {
                    "count": a.count,
                    "errors": a.errors,
                    "avg_ms": round(a.total_ms / a.count, 4)
                    if a.count else 0.0,
                    "p50_ms": round(_pctl(durs, 0.50), 4),
                    "p90_ms": round(_pctl(durs, 0.90), 4),
                    "p99_ms": round(_pctl(durs, 0.99), 4),
                    "stages": {
                        name: {"count": st[0],
                               "total_ms": round(st[1], 4),
                               "buckets": list(st[2])}
                        for name, st in sorted(a.stages.items())},
                }
        return {"apis": apis,
                "bucket_bounds_ms": [b for b in BUCKETS_MS
                                     if b != float("inf")]}

    def reset(self) -> None:
        """Drop retained traces and aggregates (tests/bench)."""
        with self._mu:
            if self._ring is not None:
                self._ring.clear()
            self._agg.clear()
            self._nroot = 0


TRACER = SpanTracer()


# -- module-level fast-path helpers (the instrumentation surface) -----------

def span(name: str):
    """Nested stage span under the current request; NOOP (one
    contextvar read, zero allocation) when no request is being traced."""
    if _current.get() is None:
        return NOOP
    return Span(TRACER, name)


def root_span(name: str, **tags):
    return TRACER.root(name, **tags)


def record(name: str, seconds: float, **tags) -> None:
    """Attach a pre-measured child span (StagePipeline on_batch timings,
    device sync times, per-drive I/O) to the current span, if any."""
    parent = _current.get()
    if parent is not None and len(parent.children) < MAX_CHILDREN:
        sp = Span(TRACER, name, tags or None)
        sp.dur_s = seconds
        parent.children.append(sp)


def current():
    return _current.get()


def active() -> bool:
    """True when the calling context is inside a traced request."""
    return _current.get() is not None


def wrap_ctx(fn):
    """Carry the current span — plus every carry_var-registered
    request-scoped var (deadline budgets) — across a thread-pool hop:
    returns fn bound to the calling context's values, or fn unchanged
    when nothing is set (the zero-cost default).  Values are re-set in
    the worker's own context rather than via
    contextvars.copy_context().run — a single Context object cannot be
    entered concurrently from the many pool threads a fan-out uses."""
    cur = _current.get()
    extras = [(v, v.get()) for v in _CARRIED]
    if cur is None and all(val is None for _, val in extras):
        return fn

    def run(*a, **kw):
        tokens = [(v, v.set(val)) for v, val in extras
                  if val is not None]
        token = _current.set(cur) if cur is not None else None
        try:
            return fn(*a, **kw)
        finally:
            if token is not None:
                _current.reset(token)
            for v, tk in reversed(tokens):
                v.reset(tk)
    return run


def timed_iter(gen, name: str):
    """Wrap a batch generator so the time blocked producing each item
    is recorded as a child span of the consumer's current span.
    Returns the generator unchanged when untraced."""
    if _current.get() is None:
        return gen

    def timed():
        it = iter(gen)
        while True:
            t0 = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            record(name, time.perf_counter() - t0)
            yield item
    return timed()


# -- analysis helpers (bench attribution, tests) ----------------------------

def flatten(rec: dict) -> dict:
    """Summed duration (ms) per span name over a whole trace record."""
    out: dict[str, float] = {}

    def walk(d):
        for c in d.get("spans", ()):
            out[c["name"]] = out.get(c["name"], 0.0) + c["dur_ms"]
            walk(c)
    walk(rec)
    return out


def coverage(rec: dict) -> float:
    """Fraction of root wall time accounted for by its direct children
    (capped at 1.0 — pipelined children legitimately overlap)."""
    total = rec.get("dur_ms", 0.0)
    if not total:
        return 0.0
    return min(1.0, sum(c["dur_ms"] for c in rec.get("spans", ()))
               / total)
