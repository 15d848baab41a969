"""Prometheus metrics: counters/gauges/histograms + text exposition.

The port's copy of minio_tpu/observe/metrics.py (the cmd/metrics-v2.go
role): API request/error counters by handler, in-flight gauge, latency
histogram, plus cluster families (capacity, object/bucket counts from the
scanner usage tree, heal stats), rendered in the Prometheus text format
at /minio/v2/metrics/{cluster,node}.  Family names, HELP, TYPE and labels
are the JAX package's, so one scraper reads both; the port adds a few
families of its own (`PORT_FAMILIES`: its kernels' launches and items,
the notification targets, two metadata-plane and two hot-tier counts).

One counter per quantity: what a module of the port already counts is
rendered from that module at scrape time (the coalescer's lanes and the
pool's IPC front end, zero-copy sends, the metadata plane, elections and
hedges, drive publishes, the boot sweep, breaker transitions, MRF
replays, the RPC client, the hot tier, the device shard cache and the
host->device ledger); `DATA_PATH` holds only what no module counts: the
heal, degraded-read, healthy-read and multipart data-path stages and the
graceful drains.  Planes the port does not have (the native digest
lanes, the chaos transport, the disk cache) render their families at 0.
"""

from __future__ import annotations

import threading

from .lastminute import ApiWindow


class Counter:
    def __init__(self, name: str, help_: str, label_names=()):
        self.name = name
        self.help = help_
        self.label_names = tuple(label_names)
        self._mu = threading.Lock()
        self._values: dict[tuple, float] = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = tuple(labels.get(n, "") for n in self.label_names)
        with self._mu:
            self._values[key] = self._values.get(key, 0.0) + amount

    def get(self, **labels) -> float:
        key = tuple(labels.get(n, "") for n in self.label_names)
        with self._mu:
            return self._values.get(key, 0.0)

    def render(self, out: list) -> None:
        out.append(f"# HELP {self.name} {self.help}")
        out.append(f"# TYPE {self.name} counter")
        with self._mu:
            if not self._values:
                out.append(f"{self.name} 0")
            for key, v in sorted(self._values.items()):
                lbl = ",".join(f'{n}="{val}"' for n, val in
                               zip(self.label_names, key))
                out.append(f"{self.name}{{{lbl}}} {v:g}" if lbl
                           else f"{self.name} {v:g}")


class Gauge(Counter):
    def set(self, value: float, **labels) -> None:
        key = tuple(labels.get(n, "") for n in self.label_names)
        with self._mu:
            self._values[key] = value

    def render(self, out: list) -> None:
        out.append(f"# HELP {self.name} {self.help}")
        out.append(f"# TYPE {self.name} gauge")
        with self._mu:
            if not self._values:
                out.append(f"{self.name} 0")
            for key, v in sorted(self._values.items()):
                lbl = ",".join(f'{n}="{val}"' for n, val in
                               zip(self.label_names, key))
                out.append(f"{self.name}{{{lbl}}} {v:g}" if lbl
                           else f"{self.name} {v:g}")


class Histogram:
    BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5, 10, float("inf"))

    def __init__(self, name: str, help_: str):
        self.name = name
        self.help = help_
        self._mu = threading.Lock()
        self._counts = [0] * len(self.BUCKETS)
        self._sum = 0.0
        self._n = 0

    def observe(self, value: float) -> None:
        with self._mu:
            self._sum += value
            self._n += 1
            for i, b in enumerate(self.BUCKETS):
                if value <= b:
                    self._counts[i] += 1

    def render(self, out: list) -> None:
        out.append(f"# HELP {self.name} {self.help}")
        out.append(f"# TYPE {self.name} histogram")
        with self._mu:
            for b, c in zip(self.BUCKETS, self._counts):
                le = "+Inf" if b == float("inf") else f"{b:g}"
                out.append(f'{self.name}_bucket{{le="{le}"}} {c}')
            out.append(f"{self.name}_sum {self._sum:g}")
            out.append(f"{self.name}_count {self._n}")


class BandwidthMonitor:
    """Per-bucket rx/tx rates over a sliding window — the bandwidth
    monitor the admin API reports (cf. cmd/admin-router.go bandwidth
    route + internal/bucket/bandwidth/monitor.go, which the reference
    uses for replication throttling and `mc admin bandwidth`)."""

    WINDOW = 10.0                    # seconds
    MAX_BUCKETS = 1024               # hostile-path cardinality bound

    def __init__(self):
        import collections
        import threading
        self._mu = threading.Lock()
        # bucket -> deque[(ts, rx, tx)]
        self._events: dict[str, object] = {}
        self._deque = collections.deque

    def record(self, bucket: str, rx: int, tx: int) -> None:
        import time as _t
        now = _t.monotonic()
        cutoff = now - self.WINDOW
        with self._mu:
            dq = self._events.get(bucket)
            if dq is None:
                if len(self._events) >= self.MAX_BUCKETS:
                    # evict idle buckets before refusing new ones
                    for name, other in list(self._events.items()):
                        while other and other[0][0] < cutoff:
                            other.popleft()
                        if not other:
                            del self._events[name]
                    if len(self._events) >= self.MAX_BUCKETS:
                        return           # saturated: drop, don't grow
                dq = self._events[bucket] = self._deque()
            dq.append((now, rx, tx))
            while dq and dq[0][0] < cutoff:
                dq.popleft()

    def report(self, buckets: list[str] | None = None) -> dict:
        import time as _t
        now = _t.monotonic()
        cutoff = now - self.WINDOW
        out = {}
        with self._mu:
            for bucket, dq in list(self._events.items()):
                while dq and dq[0][0] < cutoff:
                    dq.popleft()
                if not dq:
                    # evict idle buckets: _events must not grow with
                    # every bucket name ever requested
                    del self._events[bucket]
                    continue
                if buckets and bucket not in buckets:
                    continue
                rx = sum(e[1] for e in dq)
                tx = sum(e[2] for e in dq)
                out[bucket] = {
                    "rx_bytes_per_s": round(rx / self.WINDOW, 1),
                    "tx_bytes_per_s": round(tx / self.WINDOW, 1)}
        return out


class DataPathStats:
    """Process-global heal / degraded-read data-path accounting.

    The reconstruct pipeline (engine/heal.py, ErasureSet._read_blocks)
    runs deep inside the engine where no MetricsRegistry instance is
    reachable, and must work without a server at all (tests, `heal_drive`
    from an admin job).  So the engine records into this singleton and
    the registry renders from a snapshot, the split the reference makes
    between globalBackgroundHealState and the metrics collector
    (cmd/metrics-v2.go getHealMetrics).  Only the quantities no other
    module of the port counts live here (see the module docstring); the
    pipelined heal's stage seconds are engine/heal.STAGES'."""

    def __init__(self):
        self._mu = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._mu:
            self.heal_bytes = 0              # repaired shard bytes written
            self.heal_source_bytes = 0       # surviving shard bytes read
            self.heal_batches = 0
            self.heal_batch_blocks = 0       # blocks actually carried
            self.heal_batch_capacity = 0     # blocks the batches could carry
            self.heal_objects = 0
            self.degraded_reads = 0
            self.degraded_bytes = 0
            self.degraded_s = 0.0
            # Healthy reads: the k data shards read and verified in one
            # round, no GF(2^8) work.
            self.healthy_reads = 0
            self.healthy_bytes = 0
            self.healthy_stage_s = {"read": 0.0, "verify": 0.0,
                                    "assemble": 0.0}
            self.fastpath_fallbacks = 0
            # Multipart PUT stages (a part's encode and shard writes).
            self.mp_batches = 0
            self.mp_bytes = 0
            self.mp_stage_s = {"encode": 0.0, "write": 0.0,
                               "complete": 0.0}
            # Graceful drains (leftover = requests still inflight when
            # the drain timeout expired).
            self.drains = 0
            self.drain_leftover = 0
            self.drain_s = 0.0

    def record_heal_batch(self, blocks: int, capacity: int,
                          source_bytes: int, out_bytes: int) -> None:
        with self._mu:
            self.heal_batches += 1
            self.heal_batch_blocks += blocks
            self.heal_batch_capacity += capacity
            self.heal_source_bytes += source_bytes
            self.heal_bytes += out_bytes

    def record_heal_object(self) -> None:
        with self._mu:
            self.heal_objects += 1

    def record_degraded_read(self, nbytes: int, seconds: float) -> None:
        with self._mu:
            self.degraded_reads += 1
            self.degraded_bytes += nbytes
            self.degraded_s += seconds

    def record_healthy_read(self, nbytes: int, read_s: float,
                            verify_s: float, assemble_s: float) -> None:
        with self._mu:
            self.healthy_reads += 1
            self.healthy_bytes += nbytes
            self.healthy_stage_s["read"] += read_s
            self.healthy_stage_s["verify"] += verify_s
            self.healthy_stage_s["assemble"] += assemble_s

    def record_fastpath_fallback(self) -> None:
        with self._mu:
            self.fastpath_fallbacks += 1

    def record_mp_batch(self, nbytes: int, encode_s: float,
                        write_s: float) -> None:
        with self._mu:
            self.mp_batches += 1
            self.mp_bytes += nbytes
            self.mp_stage_s["encode"] += encode_s
            self.mp_stage_s["write"] += write_s

    def record_mp_complete(self, seconds: float) -> None:
        with self._mu:
            self.mp_stage_s["complete"] += seconds

    def record_drain(self, leftover: int, seconds: float) -> None:
        with self._mu:
            self.drains += 1
            self.drain_leftover += leftover
            self.drain_s += seconds

    def snapshot(self) -> dict:
        with self._mu:
            return {
                "heal_bytes": self.heal_bytes,
                "heal_source_bytes": self.heal_source_bytes,
                "heal_batches": self.heal_batches,
                "heal_batch_blocks": self.heal_batch_blocks,
                "heal_batch_capacity": self.heal_batch_capacity,
                "heal_batch_occupancy": (
                    self.heal_batch_blocks / self.heal_batch_capacity
                    if self.heal_batch_capacity else 0.0),
                "heal_objects": self.heal_objects,
                "degraded_reads": self.degraded_reads,
                "degraded_bytes": self.degraded_bytes,
                "degraded_seconds": self.degraded_s,
                "healthy_reads": self.healthy_reads,
                "healthy_bytes": self.healthy_bytes,
                "healthy_stage_s": dict(self.healthy_stage_s),
                "fastpath_fallbacks": self.fastpath_fallbacks,
                "mp_batches": self.mp_batches,
                "mp_bytes": self.mp_bytes,
                "mp_stage_s": dict(self.mp_stage_s),
                "drains": self.drains,
                "drain_leftover": self.drain_leftover,
                "drain_seconds": self.drain_s,
            }


#: Engine-side singleton (see DataPathStats docstring).
DATA_PATH = DataPathStats()


def _lane_index(name: str) -> int:
    """A coalescer lane's card index from its device name ("cuda:1" is
    1, the CPU's lane 0), the label the JAX package's lanes carry."""
    _, _, idx = name.partition(":")
    return int(idx) if idx.isdigit() else 0


#: The port's families beyond the JAX package's (see the module
#: docstring); every other family is the JAX package's, name for name.
PORT_FAMILIES = (
    "mtpu_kernel_launches_total", "mtpu_kernel_items_total",
    "mtpu_meta_group_items_max", "mtpu_meta_read_keys_total",
    "mtpu_hotcache_ghost_defers_total", "mtpu_hotcache_arena_in_use_bytes",
    "mtpu_notify_events_sent_total", "mtpu_notify_events_delivered_total",
    "mtpu_notify_events_parked_total", "mtpu_notify_events_retried_total",
    "mtpu_notify_events_dropped_total", "mtpu_notify_backlog_events")


class MetricsRegistry:
    """Every family a node exports.  `kernels=False` leaves out this
    process's kernel launch and item families: in the worker pool the
    pool's own families (server/workers.py render_prom) carry every
    worker's and the owner's."""

    def __init__(self, kernels: bool = True):
        self.api_requests = Counter(
            "mtpu_s3_requests_total", "S3 requests by API and status",
            ("api", "status"))
        self.api_errors = Counter(
            "mtpu_s3_errors_total", "S3 error responses by code", ("code",))
        self.inflight = Gauge(
            "mtpu_s3_requests_inflight", "Requests currently being served")
        self.latency = Histogram(
            "mtpu_s3_ttfb_seconds", "Request latency seconds")
        self.bytes_rx = Counter("mtpu_s3_rx_bytes_total",
                                "Bytes received from clients")
        self.bytes_tx = Counter("mtpu_s3_tx_bytes_total",
                                "Bytes sent to clients")
        self.bucket_usage = Gauge("mtpu_bucket_usage_total_bytes",
                                  "Bucket usage from last scan", ("bucket",))
        self.bucket_objects = Gauge("mtpu_bucket_objects",
                                    "Object count from last scan",
                                    ("bucket",))
        self.heal_total = Counter("mtpu_heal_objects_healed_total",
                                  "Objects healed")
        # Reconstruct-pipeline families (rendered from DATA_PATH):
        # throughput, per-stage latency, and batch occupancy for heal
        # and the degraded-read path.
        self.heal_bytes = Gauge("mtpu_heal_repaired_bytes_total",
                                "Repaired shard bytes written by heal")
        self.heal_source_bytes = Gauge(
            "mtpu_heal_source_bytes_total",
            "Surviving shard bytes read by heal")
        self.heal_stage_seconds = Gauge(
            "mtpu_heal_stage_seconds_total",
            "Heal pipeline time by stage", ("stage",))
        self.heal_batches = Gauge("mtpu_heal_batches_total",
                                  "Reconstruct batches dispatched by heal")
        self.heal_batch_occupancy = Gauge(
            "mtpu_heal_batch_occupancy_ratio",
            "Blocks carried / batch capacity (1.0 = full batches)")
        self.degraded_reads = Gauge("mtpu_degraded_reads_total",
                                    "GET segments served by reconstruction")
        self.degraded_bytes = Gauge(
            "mtpu_degraded_read_bytes_total",
            "Bytes served through the degraded-read path")
        self.degraded_seconds = Gauge(
            "mtpu_degraded_read_seconds_total",
            "Time spent reconstructing degraded reads")
        # Healthy-read fast-path families: verify-only verdicts +
        # systematic assembly, zero GF(2^8) work (MTPU_GET_FASTPATH).
        self.healthy_reads = Gauge(
            "mtpu_healthy_reads_total",
            "GET segments served by the verify-only fast path")
        self.healthy_bytes = Gauge(
            "mtpu_healthy_read_bytes_total",
            "Bytes served through the verify-only fast path")
        self.healthy_stage_seconds = Gauge(
            "mtpu_healthy_read_stage_seconds_total",
            "Healthy-read fast path time by stage", ("stage",))
        self.fastpath_fallbacks = Gauge(
            "mtpu_get_fastpath_fallbacks_total",
            "Fast-path reads that fell back to verify+decode")
        # Multipart PUT pipeline families.
        self.mp_batches = Gauge(
            "mtpu_multipart_put_batches_total",
            "Encode batches through the multipart PUT pipeline")
        self.mp_bytes = Gauge(
            "mtpu_multipart_put_bytes_total",
            "Part bytes through the multipart PUT pipeline")
        self.mp_stage_seconds = Gauge(
            "mtpu_multipart_put_stage_seconds_total",
            "Multipart PUT pipeline time by stage", ("stage",))
        # Cross-request dispatch-coalescing families (MTPU_COALESCE).
        self.co_dispatches = Gauge(
            "mtpu_coalesce_dispatches_total",
            "Coalesced kernel launches")
        self.co_items = Gauge(
            "mtpu_coalesce_items_total",
            "Work items submitted to the dispatch coalescer")
        self.co_blocks = Gauge(
            "mtpu_coalesce_block_weight_total",
            "Summed work-item weight through coalesced dispatches "
            "(1 MiB-block units)")
        self.co_occupancy = Gauge(
            "mtpu_coalesce_batch_occupancy_items",
            "Mean work items per coalesced dispatch (>1 = cross-request "
            "batching is happening)")
        self.co_wait_seconds = Gauge(
            "mtpu_coalesce_queue_wait_seconds_total",
            "Summed per-item queue wait before dispatch")
        # Dispatch fault-containment families.
        self.co_batch_faults = Gauge(
            "mtpu_coalesce_batch_faults_total",
            "Coalesced dispatches that raised and were retried "
            "member-by-member")
        self.co_member_retries = Gauge(
            "mtpu_coalesce_member_retries_total",
            "Batch member spans retried individually after a fault")
        self.co_fallbacks = Gauge(
            "mtpu_coalesce_fallbacks_total",
            "Call sites that recomputed a span through the direct "
            "path after a failed coalesced handle")
        # Per-device coalescer-lane families: one series per
        # device lane, so skew between lanes is visible (a pinned
        # keyspace lights one device; spread lights them all).
        self.device_lane_dispatches = Gauge(
            "mtpu_device_lane_dispatches_total",
            "Coalesced kernel launches per device lane", ("device",))
        self.device_lane_occupancy = Gauge(
            "mtpu_device_lane_occupancy",
            "Mean work items per dispatch on this device lane",
            ("device",))
        self.device_lane_queue_wait = Gauge(
            "mtpu_device_lane_queue_wait_seconds_total",
            "Summed per-item queue wait before dispatch on this "
            "device lane", ("device",))
        # Cross-process dispatch families (worker pool).
        self.ipc_submits = Gauge(
            "mtpu_ipc_dispatch_submits_total",
            "Work items shipped to the device-owner process")
        self.ipc_results = Gauge(
            "mtpu_ipc_dispatch_results_total",
            "Remote dispatch results received back")
        self.ipc_fallbacks = Gauge(
            "mtpu_ipc_dispatch_fallbacks_total",
            "Remote submits that degraded to worker-local compute "
            "(arena/ring backpressure or owner loss)")
        self.ipc_owner_deaths = Gauge(
            "mtpu_ipc_owner_deaths_total",
            "Device-owner heartbeat losses observed by this worker")
        # Hedged shard-read families (MTPU_HEDGE).
        self.hedged_reads = Gauge(
            "mtpu_hedged_reads_total",
            "Stripe reads gathered through the first-k-wins path")
        self.hedge_fired = Gauge(
            "mtpu_hedge_timers_fired_total",
            "Hedge delays that expired (stragglers covered by spares)")
        self.hedge_spares = Gauge(
            "mtpu_hedge_spare_reads_total",
            "Speculative parity-shard reads launched")
        self.hedge_wins = Gauge(
            "mtpu_hedge_wins_total",
            "Hedged spare rows that made the final k")
        # Native digest-plane families (MTPU_NATIVE_DIGEST).
        self.dg_md5_calls = Gauge(
            "mtpu_digest_md5_lane_calls_total",
            "Native multi-buffer MD5 lane-scheduler ticks")
        self.dg_md5_streams = Gauge(
            "mtpu_digest_md5_streams_total",
            "Streams advanced across MD5 lane-scheduler ticks")
        self.dg_md5_bytes = Gauge(
            "mtpu_digest_md5_bytes_total",
            "Bytes hashed through native MD5 lanes")
        self.dg_md5_occupancy = Gauge(
            "mtpu_digest_md5_lane_occupancy_streams",
            "Mean streams per MD5 lane tick (>1 = lanes are shared)")
        self.dg_sha_calls = Gauge(
            "mtpu_digest_sha256_batch_calls_total",
            "Batched native SHA256 calls")
        self.dg_sha_bufs = Gauge(
            "mtpu_digest_sha256_buffers_total",
            "Buffers verified through batched native SHA256")
        self.dg_sha_bytes = Gauge(
            "mtpu_digest_sha256_bytes_total",
            "Bytes hashed through batched native SHA256")
        # Drive circuit-breaker state (0=ok 1=suspect 2=offline) and
        # lifetime transitions by target state.
        self.drive_state = Gauge(
            "mtpu_drive_state",
            "Per-drive breaker state: 0 ok, 1 suspect, 2 offline",
            ("pool", "set", "drive"))
        self.drive_transitions = Gauge(
            "mtpu_drive_state_transitions_total",
            "Breaker state transitions by target state", ("state",))
        # Process-lifecycle families: boot recovery sweep + graceful
        # drain (cmd/prepare-storage.go / cmd/signals.go analogues).
        self.recovery_sweeps = Gauge(
            "mtpu_recovery_drive_sweeps_total",
            "Per-drive boot-time recovery sweeps run")
        self.recovery_tmp = Gauge(
            "mtpu_recovery_tmp_entries_swept_total",
            "Stale tmp/trash entries removed at boot")
        self.recovery_mp_stage = Gauge(
            "mtpu_recovery_multipart_stage_swept_total",
            "Orphaned multipart staging files removed at boot")
        self.mrf_replayed = Gauge(
            "mtpu_mrf_journal_replayed_total",
            "MRF journal entries replayed into the queue on boot")
        self.drains = Gauge(
            "mtpu_drains_total", "Graceful drains started")
        self.drain_leftover = Gauge(
            "mtpu_drain_leftover_requests_total",
            "Requests still inflight when the drain timeout expired")
        self.drain_seconds = Gauge(
            "mtpu_drain_seconds_total", "Time spent draining")
        # MRF heal-queue families.
        self.mrf_pending = Gauge(
            "mtpu_mrf_pending", "Objects queued for MRF heal")
        self.mrf_healed = Gauge(
            "mtpu_mrf_healed_total", "Objects healed off the MRF queue")
        self.mrf_dropped = Gauge(
            "mtpu_mrf_dropped_total",
            "MRF entries dropped (attempts exhausted or queue shed)")
        self.mrf_retries = Gauge(
            "mtpu_mrf_retries_total", "Failed MRF heal attempts")
        # Span-aggregate families (rendered from observe.span TRACER):
        # per-API traced-request percentiles + per-stage span histograms
        # ("le" carries the cumulative bucket bound in ms).
        self.trace_api_count = Gauge(
            "mtpu_trace_api_requests_total",
            "Traced requests by API (span roots)", ("api",))
        self.trace_api_errors = Gauge(
            "mtpu_trace_api_errors_total",
            "Traced error requests by API", ("api",))
        self.trace_api_latency = Gauge(
            "mtpu_trace_api_latency_ms",
            "Traced request latency percentiles in ms",
            ("api", "quantile"))
        self.trace_stage_ms = Gauge(
            "mtpu_trace_stage_ms_total",
            "Summed span time by API and stage in ms", ("api", "stage"))
        self.trace_stage_count = Gauge(
            "mtpu_trace_stage_spans_total",
            "Span count by API and stage", ("api", "stage"))
        self.trace_stage_hist = Gauge(
            "mtpu_trace_stage_duration_ms_bucket",
            "Cumulative span duration histogram by API and stage",
            ("api", "stage", "le"))
        self.drive_online = Gauge("mtpu_cluster_drives_online",
                                  "Online drives")
        self.drive_offline = Gauge("mtpu_cluster_drives_offline",
                                   "Offline drives")
        # Peer-liveness families (rpc/rest.py RPCClient accounting,
        # cf. the reference's internode health checker): per-endpoint
        # state/flap-count/staleness plus fleet-wide flip, retry,
        # deadline-exhaustion and chaos-injection counters.
        self.peer_state = Gauge(
            "mtpu_peer_state",
            "Peer RPC endpoint state: 1 online, 0 offline",
            ("endpoint",))
        self.peer_transitions = Gauge(
            "mtpu_peer_transitions_total",
            "Peer online/offline transitions", ("endpoint",))
        self.peer_last_seen = Gauge(
            "mtpu_peer_last_seen_seconds",
            "Seconds since the peer last answered an RPC "
            "(-1: never)", ("endpoint",))
        self.peer_rpc_timeout = Gauge(
            "mtpu_peer_rpc_timeout_seconds",
            "Adaptive per-call RPC deadline for the peer",
            ("endpoint",))
        self.peer_flaps = Gauge(
            "mtpu_peer_flaps_total",
            "Peer state flips across all endpoints by direction",
            ("state",))
        self.rpc_retries = Gauge(
            "mtpu_rpc_retries_total",
            "Idempotent RPC retries after retryable transport faults")
        self.rpc_deadline_exceeded = Gauge(
            "mtpu_rpc_deadline_exceeded_total",
            "RPCs aborted because the request deadline budget ran out")
        self.netchaos_injected = Gauge(
            "mtpu_netchaos_injected_total",
            "Chaos-injected transport faults by kind (MTPU_NETCHAOS)",
            ("kind",))
        # Disk-cache gauges (cf. getCacheMetrics, cmd/metrics-v2.go)
        self.cache_hits = Gauge("mtpu_cache_hits_total",
                                "Disk cache hits")
        self.cache_misses = Gauge("mtpu_cache_misses_total",
                                  "Disk cache misses")
        self.cache_evictions = Gauge("mtpu_cache_evicted_total",
                                     "Disk cache LRU evictions")
        self.cache_usage = Gauge("mtpu_cache_usage_bytes",
                                 "Disk cache bytes in use")
        self.cache_max = Gauge("mtpu_cache_total_bytes",
                               "Disk cache size budget")
        # RAM hot-object tier (engine/hotcache.py; cf. the reference's
        # cmd/disk-cache*.go tier, here shared-memory + pool-shared).
        self.hotcache_hits = Gauge("mtpu_hotcache_hits_total",
                                   "Hot-object cache body hits")
        self.hotcache_misses = Gauge("mtpu_hotcache_misses_total",
                                     "Hot-object cache misses")
        self.hotcache_meta_hits = Gauge(
            "mtpu_hotcache_meta_hits_total",
            "Hot-object cache metadata-only (HEAD/conditional) hits")
        self.hotcache_ratio = Gauge("mtpu_hotcache_hit_ratio",
                                    "Hot-object cache hit ratio")
        self.hotcache_fills = Gauge("mtpu_hotcache_fills_total",
                                    "Verified reads admitted to the "
                                    "hot cache")
        self.hotcache_evictions = Gauge(
            "mtpu_hotcache_evictions_total",
            "Hot-cache CLOCK evictions")
        self.hotcache_bypassed = Gauge(
            "mtpu_hotcache_bypassed_total",
            "Reads that bypassed fill (degraded/oversize/ineligible)")
        self.hotcache_stale = Gauge(
            "mtpu_hotcache_stale_generation_total",
            "Lookups/fills dropped on a stale bucket generation")
        self.hotcache_invalidations = Gauge(
            "mtpu_hotcache_invalidations_total",
            "Bucket-generation bumps from mutation paths")
        self.hotcache_entries = Gauge("mtpu_hotcache_entries",
                                      "Live hot-cache entries")
        self.hotcache_bytes = Gauge("mtpu_hotcache_usage_bytes",
                                    "Hot-cache body bytes cached")
        self.hotcache_segment = Gauge("mtpu_hotcache_total_bytes",
                                      "Hot-cache shared-segment size")
        # Zero-copy data path (ops/zerocopy.py + ops/bpool.py; cf.
        # internal/bpool/bpool.go and the xl-storage O_DIRECT write
        # contract).  Synced from DATA_PATH / ops.bpool.stats().
        self.zerocopy_hot_views = Gauge(
            "mtpu_zerocopy_hot_views_total",
            "Hot-cache GETs served as pinned arena views (no body copy)")
        self.zerocopy_hot_view_bytes = Gauge(
            "mtpu_zerocopy_hot_view_bytes_total",
            "Body bytes served straight from pinned arena views")
        self.zerocopy_sendmsg = Gauge(
            "mtpu_zerocopy_sendmsg_total",
            "Responses shipped by gather-write sendmsg")
        self.zerocopy_sendmsg_bytes = Gauge(
            "mtpu_zerocopy_sendmsg_bytes_total",
            "Body bytes shipped by gather-write sendmsg")
        self.zerocopy_sendfile = Gauge(
            "mtpu_zerocopy_sendfile_total",
            "Responses shipped by kernel sendfile")
        self.zerocopy_sendfile_bytes = Gauge(
            "mtpu_zerocopy_sendfile_bytes_total",
            "Body bytes shipped by kernel sendfile")
        self.zerocopy_vectored_writes = Gauge(
            "mtpu_zerocopy_vectored_writes_total",
            "Shard appends written as single pwritev batches")
        self.zerocopy_vectored_write_bytes = Gauge(
            "mtpu_zerocopy_vectored_write_bytes_total",
            "Shard bytes written through vectored batches")
        self.zerocopy_fallbacks = Gauge(
            "mtpu_zerocopy_fallbacks_total",
            "Eligible responses that fell back to the buffered writer")
        # Small-object metadata plane (ops/metalanes.py; cf. the
        # reference's format-v2 inline discipline,
        # cmd/xl-storage-format-v2.go).  Synced from DATA_PATH.
        self.meta_publishes = Gauge(
            "mtpu_meta_publishes_total",
            "xl.meta publishes across all drives (solo + batched)")
        self.meta_fsyncs = Gauge(
            "mtpu_meta_fsyncs_total",
            "fsyncs paying for metadata publishes (group commit "
            "amortizes one journal fsync over a whole batch)")
        self.meta_fsyncs_per_object = Gauge(
            "mtpu_meta_fsyncs_per_object",
            "Amortized fsyncs per xl.meta publish (oracle: 1.0)")
        self.meta_group_commits = Gauge(
            "mtpu_meta_group_commits_total",
            "Group-committed metadata batches (one journal fsync each)")
        self.meta_group_items = Gauge(
            "mtpu_meta_group_items_total",
            "xl.meta publishes carried inside group commits")
        self.meta_batch_occupancy = Gauge(
            "mtpu_meta_batch_occupancy",
            "Mean publishes per group commit")
        self.meta_journal_replays = Gauge(
            "mtpu_meta_journal_replays_total",
            "xl.meta entries republished from metadata journal "
            "segments at boot recovery")
        self.meta_read_requests = Gauge(
            "mtpu_meta_read_requests_total",
            "Engine metadata reads (quorum _read_metadata calls)")
        self.meta_read_rounds = Gauge(
            "mtpu_meta_read_rounds_total",
            "Per-drive metadata read dispatches serving those requests")
        self.meta_read_fanouts = Gauge(
            "mtpu_meta_read_fanouts_per_request",
            "Drive dispatches per metadata read (oracle: N drives; "
            "coalescing drives it below 1)")
        self.meta_trim_hits = Gauge(
            "mtpu_meta_trim_hits_total",
            "K+1-trimmed read fan-outs accepted at quorum")
        self.meta_trim_fallbacks = Gauge(
            "mtpu_meta_trim_fallbacks_total",
            "Trimmed fan-outs that widened to the remaining drives")
        self.meta_lane_dispatches = Gauge(
            "mtpu_meta_lane_dispatches_total",
            "Metadata lane dispatcher rounds")
        self.meta_inline_ops = Gauge(
            "mtpu_meta_inline_ops_total",
            "Lane submits executed inline on the caller's thread "
            "(idle fast path)")
        self.bpool_gets = Gauge(
            "mtpu_bpool_gets_total",
            "Scratch-buffer leases handed out by the aligned pool")
        self.bpool_fallbacks = Gauge(
            "mtpu_bpool_fallbacks_total",
            "Leases served by anonymous mmap (pool off or full)")
        self.bpool_released = Gauge(
            "mtpu_bpool_released_total",
            "Leases explicitly released back to the pool")
        self.bpool_leak_reclaims = Gauge(
            "mtpu_bpool_leak_reclaims_total",
            "Leaked leases reclaimed by the finalize backstop")
        self.bpool_bytes = Gauge(
            "mtpu_bpool_total_bytes", "Aligned-pool arena size")
        self.bpool_in_use = Gauge(
            "mtpu_bpool_in_use_bytes", "Aligned-pool bytes leased out")
        # Device-resident shard plane (ops/devcache.py) + host->device
        # boundary ledger: the instrumented proof that object bytes
        # cross the tunnel at most once (first touch ~1.0 byte crossed
        # per byte served, ~0 on cache hits).
        self.devcache_hits = Gauge(
            "mtpu_devcache_hits_total",
            "Reads served from the device-resident shard cache")
        self.devcache_misses = Gauge(
            "mtpu_devcache_misses_total",
            "Shard-cache probes that fell through to disk")
        self.devcache_ratio = Gauge(
            "mtpu_devcache_hit_ratio",
            "Lifetime shard-cache hit ratio")
        self.devcache_fills = Gauge(
            "mtpu_devcache_fills_total",
            "Verified fast-path reads admitted to the shard cache")
        self.devcache_evictions = Gauge(
            "mtpu_devcache_evictions_total",
            "Shard-cache entries evicted by the LRU capacity bound")
        self.devcache_invalidations = Gauge(
            "mtpu_devcache_invalidations_total",
            "Bucket mutations noted by the shard cache (_mark_dirty)")
        self.devcache_stale_drops = Gauge(
            "mtpu_devcache_stale_drops_total",
            "Entries/fills dropped by generation mismatch")
        self.devcache_rejects = Gauge(
            "mtpu_devcache_rejects_total",
            "Fills rejected (range larger than the cache capacity)")
        self.devcache_entries = Gauge(
            "mtpu_devcache_entries",
            "Resident shard-cache entries")
        self.devcache_resident = Gauge(
            "mtpu_devcache_resident_bytes",
            "Payload bytes resident in the shard cache")
        self.devcache_capacity = Gauge(
            "mtpu_devcache_capacity_bytes",
            "Shard-cache capacity bound (MTPU_DEVCACHE_MB)")
        self.h2d_bytes = Gauge(
            "mtpu_h2d_bytes_total",
            "Bytes that crossed the host->device boundary")
        self.h2d_dispatches = Gauge(
            "mtpu_h2d_dispatches_total",
            "Host->device upload crossings (device_put calls)")
        self.h2d_lane_bytes = Gauge(
            "mtpu_h2d_lane_bytes_total",
            "Host->device bytes per device lane")
        self.h2d_lane_dispatches = Gauge(
            "mtpu_h2d_lane_dispatches_total",
            "Host->device crossings per device lane")
        self.h2d_pipeline_dispatches = Gauge(
            "mtpu_h2d_pipeline_dispatches_total",
            "Coalesced batches shipped through the pinned-staging "
            "double-buffered upload pipeline")
        self.h2d_overlap_seconds = Gauge(
            "mtpu_h2d_overlap_seconds_total",
            "Host pack/upload time overlapped with device execution")
        self.h2d_pack_seconds = Gauge(
            "mtpu_h2d_pack_seconds_total",
            "Time packing batches into pinned staging buffers")
        self.h2d_upload_seconds = Gauge(
            "mtpu_h2d_upload_seconds_total",
            "Time issuing async device_put uploads from staging")
        self.h2d_resolve_seconds = Gauge(
            "mtpu_h2d_resolve_seconds_total",
            "Time syncing pipelined kernel results (resolve phase)")
        # ILM transition/restore + warm-tier families (bucket/tier.py;
        # cf. getClusterTierMetrics, cmd/metrics-v3-cluster-usage.go).
        self.ilm_transitioned = Gauge(
            "mtpu_ilm_transitioned_total",
            "Versions moved to a warm tier (stub left hot)")
        self.ilm_transition_bytes = Gauge(
            "mtpu_ilm_transition_bytes_total",
            "Bytes streamed to warm tiers by transitions")
        self.ilm_transition_errors = Gauge(
            "mtpu_ilm_transition_errors_total",
            "Transitions aborted by tier faults (journal reaps)")
        self.ilm_restored = Gauge(
            "mtpu_ilm_restored_total",
            "Restore-on-POST rehydrations completed")
        self.ilm_restore_bytes = Gauge(
            "mtpu_ilm_restore_bytes_total",
            "Bytes streamed back hot by restores")
        self.ilm_restore_expired = Gauge(
            "mtpu_ilm_restore_expired_total",
            "Temporary restores re-expired by the scanner")
        self.ilm_journal_pending = Gauge(
            "mtpu_ilm_journal_pending",
            "Tier-journal records awaiting resolution (drains to 0)")
        self.ilm_journal_replayed = Gauge(
            "mtpu_ilm_journal_replayed_total",
            "Journal records resolved by boot replay")
        self.ilm_orphans_reaped = Gauge(
            "mtpu_ilm_orphans_reaped_total",
            "Orphaned tier objects reaped via the journal")
        # Bucket replication families (bucket/replication.py; cf.
        # getReplicationSiteMetrics, cmd/metrics-v2.go replication).
        self.repl_queued = Gauge(
            "mtpu_repl_queued",
            "Replication tasks in backlog or in flight (drains to 0)")
        self.repl_completed = Gauge(
            "mtpu_repl_completed_total",
            "Replication tasks copied to their target")
        self.repl_failed = Gauge(
            "mtpu_repl_failed_total",
            "Replication tasks whose FIRST attempt failed")
        self.repl_retries = Gauge(
            "mtpu_repl_retries_total",
            "Replication re-attempts after a failed first try")
        self.repl_dropped = Gauge(
            "mtpu_repl_dropped_total",
            "Journaled tasks dropped (bucket unwired / source gone)")
        self.repl_bytes = Gauge(
            "mtpu_repl_bytes_total",
            "Bytes copied to replication targets")
        self.repl_proxied = Gauge(
            "mtpu_repl_proxied_reads_total",
            "GETs served by proxying to a replication target")
        self.repl_journal_pending = Gauge(
            "mtpu_repl_journal_pending",
            "Intent-journal records awaiting completion (drains to 0)")
        self.repl_journal_replayed = Gauge(
            "mtpu_repl_journal_replayed_total",
            "Intents restored into the backlog by boot replay")
        self.repl_lag = Gauge(
            "mtpu_repl_lag_seconds",
            "Age of the oldest unreplicated task per target bucket",
            ("target",))
        self.repl_breaker_open = Gauge(
            "mtpu_repl_breaker_open",
            "Per-target breakers currently open (target unreachable)")
        self.tier_objects = Gauge(
            "mtpu_tier_objects",
            "Objects currently resident in the warm tier", ("tier",))
        self.tier_bytes = Gauge(
            "mtpu_tier_bytes",
            "Bytes currently resident in the warm tier", ("tier",))
        self.tier_read_through = Gauge(
            "mtpu_tier_read_through_total",
            "Stub GET/HEAD reads streamed through from tiers")
        self.tier_freed = Gauge(
            "mtpu_tier_freed_total",
            "Tier objects deleted through the journal")
        # Multi-pool placement + decommission families (cf.
        # getClusterHealthMetrics pool rows, cmd/metrics-v3-cluster.go).
        self.pool_total_bytes = Gauge(
            "mtpu_pool_total_bytes", "Pool raw capacity", ("pool",))
        self.pool_free_bytes = Gauge(
            "mtpu_pool_free_bytes", "Pool free capacity", ("pool",))
        self.pool_draining = Gauge(
            "mtpu_pool_draining",
            "Pool is excluded from new placement (decommission)",
            ("pool",))
        self.decom_state = Gauge(
            "mtpu_decom_state",
            "Decommission state: 0 draining, 1 paused, 2 complete, "
            "3 cancelled, 4 failed", ("pool",))
        self.decom_objects_moved = Gauge(
            "mtpu_decom_objects_moved_total",
            "Objects fully drained off the pool", ("pool",))
        self.decom_objects_remaining = Gauge(
            "mtpu_decom_objects_remaining",
            "Objects still to drain", ("pool",))
        self.decom_versions_moved = Gauge(
            "mtpu_decom_versions_moved_total",
            "Versions re-PUT off the pool", ("pool",))
        self.decom_bytes_moved = Gauge(
            "mtpu_decom_bytes_moved_total",
            "Bytes re-PUT off the pool", ("pool",))
        self.decom_bytes_per_sec = Gauge(
            "mtpu_decom_bytes_per_sec",
            "Current drain throughput", ("pool",))
        self.decom_uploads_relocated = Gauge(
            "mtpu_decom_uploads_relocated_total",
            "Pending multipart uploads re-staged off the pool",
            ("pool",))
        # Sliding last-minute SLO families (observe/lastminute.py):
        # merged from the per-worker ring at scrape time.
        self.api_lm_count = Gauge(
            "mtpu_api_last_minute_count",
            "Requests in the sliding SLO window by API", ("api",))
        self.api_lm_errors = Gauge(
            "mtpu_api_last_minute_errors",
            "Error responses in the sliding SLO window by API",
            ("api",))
        self.api_lm_p50 = Gauge(
            "mtpu_api_last_minute_p50",
            "Sliding-window p50 latency in ms by API", ("api",))
        self.api_lm_p99 = Gauge(
            "mtpu_api_last_minute_p99",
            "Sliding-window p99 latency in ms by API", ("api",))
        self.api_lm_sheds = Gauge(
            "mtpu_api_last_minute_sheds",
            "Admission-shed 503s in the sliding SLO window by API "
            "(distinct from errors: a shed is deliberate overload "
            "protection, not a server fault)", ("api",))
        # Audit-plane delivery families (observe/audit.py): per-target
        # delivered/shed/retried entry counts.
        self.audit_emitted = Gauge(
            "mtpu_audit_emitted_total",
            "Audit entries delivered to the sink", ("target",))
        self.audit_dropped = Gauge(
            "mtpu_audit_dropped_total",
            "Audit entries shed (bounded queue full or sink dead "
            "after retries)", ("target",))
        self.audit_retries = Gauge(
            "mtpu_audit_retries_total",
            "Audit delivery re-attempts (webhook backoff)", ("target",))
        # Overload-plane families (server/qos.py): admission slots,
        # deadline queue, tenant/bucket throttles, background yield —
        # synced from the fork-shared slab at scrape time.
        self.qos_inflight = Gauge(
            "mtpu_qos_requests_inflight",
            "Admission slots currently held (pool-wide: the slab is "
            "fork-shared)")
        self.qos_queue_depth = Gauge(
            "mtpu_qos_queue_depth",
            "Requests waiting in the admission deadline queue")
        self.qos_pressure = Gauge(
            "mtpu_qos_pressure",
            "Admission occupancy EMA in [0,1] — the signal background "
            "planes yield to")
        self.qos_admitted = Gauge(
            "mtpu_qos_admitted_total",
            "Requests admitted through the overload plane by tenant "
            "class", ("tenant_class",))
        self.qos_shed = Gauge(
            "mtpu_qos_shed_total",
            "Requests shed with 503 SlowDown by tenant class",
            ("tenant_class",))
        self.qos_shed_reason = Gauge(
            "mtpu_qos_shed_reason_total",
            "Admission sheds by cause (queue: bounded queue full; "
            "deadline: MTPU_REQUESTS_DEADLINE_MS expired waiting)",
            ("reason",))
        self.qos_queue_wait = Gauge(
            "mtpu_qos_queue_wait_seconds_total",
            "Summed admission-queue wait of requests that were "
            "eventually admitted")
        self.qos_tenant_throttled = Gauge(
            "mtpu_qos_tenant_throttled_total",
            "Requests refused by per-tenant token buckets (req/s or "
            "bandwidth)")
        self.qos_bucket_throttled = Gauge(
            "mtpu_qos_bucket_throttled_total",
            "Requests refused by per-bucket bandwidth budgets")
        self.qos_bg_yields = Gauge(
            "mtpu_qos_bg_yields_total",
            "Background-plane yields to foreground pressure (shrunk "
            "batch concurrency + paced batches)", ("plane",))
        # The port's own families (PORT_FAMILIES).
        self.kernel_launches = self.kernel_items = None
        if kernels:
            self.kernel_launches = Gauge(
                "mtpu_kernel_launches_total",
                "Kernel launches in this process", ("kernel",))
            self.kernel_items = Gauge(
                "mtpu_kernel_items_total",
                "Kernel work items in this process", ("kernel",))
        self.meta_group_max = Gauge(
            "mtpu_meta_group_items_max",
            "Most publishes in one group commit")
        self.meta_read_keys = Gauge(
            "mtpu_meta_read_keys_total",
            "Metadata lookups the per-drive read dispatches served")
        self.hotcache_ghost_defers = Gauge(
            "mtpu_hotcache_ghost_defers_total",
            "First misses the two-hit filter kept out")
        self.hotcache_arena_in_use = Gauge(
            "mtpu_hotcache_arena_in_use_bytes",
            "Hot-object arena bytes in use, pinned runs included")
        self.notify = {key: Gauge(name, help_) for key, name, help_ in (
            ("sent", "mtpu_notify_events_sent_total",
             "Events handed to notification targets by matching rules"),
            ("delivered", "mtpu_notify_events_delivered_total",
             "Events their target acknowledged (first try or retried)"),
            ("parked", "mtpu_notify_events_parked_total",
             "Events parked in a target's queue store while it was down"),
            ("retried", "mtpu_notify_events_retried_total",
             "Parked events a retry pass delivered"),
            ("dropped", "mtpu_notify_events_dropped_total",
             "Events whose rule names an ARN with no registered target"),
            ("backlog", "mtpu_notify_backlog_events",
             "Events parked in this process's queue stores now"))}
        self.bandwidth = BandwidthMonitor()
        self.last_minute = ApiWindow()

    def observe_api(self, api: str, duration_s: float,
                    error: bool = False, nbytes: int = 0,
                    shed: bool = False) -> None:
        """Feed the sliding SLO window — lock-free, called once per
        request with the span-style API name (api.PutObject, ...).
        `shed` marks an admission-control 503 as its own class: shed
        ≠ server error in the SLO window (deliberate overload
        protection must not page anyone about error budgets)."""
        self.last_minute.observe(api, duration_s, error, nbytes,
                                 shed=shed)

    def update_qos(self, plane) -> None:
        """Refresh overload-plane gauges from the fork-shared slab
        (scrape time, same pattern as update_audit)."""
        if plane is None:
            return
        st = plane.stats()
        self.qos_inflight.set(st["inflight"])
        self.qos_queue_depth.set(st["waiting"])
        self.qos_pressure.set(st["pressure"])
        self.qos_queue_wait.set(st["queue_wait_seconds"])
        self.qos_tenant_throttled.set(st["tenant_throttled"])
        self.qos_bucket_throttled.set(st["bucket_throttled"])
        self.qos_shed_reason.set(st["shed_queue"], reason="queue")
        self.qos_shed_reason.set(st["shed_deadline"], reason="deadline")
        for klass, row in st["classes"].items():
            self.qos_admitted.set(row["admitted"], tenant_class=klass)
            self.qos_shed.set(row["shed"], tenant_class=klass)
        self.qos_bg_yields.set(st["bg_yields"], plane="all")
        for name, n in st["bg_yields_by_plane"].items():
            self.qos_bg_yields.set(n, plane=name)

    def update_audit(self, targets) -> None:
        """Refresh per-target audit delivery gauges (scrape time)."""
        for t in targets:
            s = t.stats() if hasattr(t, "stats") else None
            if s is None:
                continue
            name = s["target"]
            self.audit_emitted.set(s["emitted"], target=name)
            self.audit_dropped.set(s["dropped"], target=name)
            self.audit_retries.set(s["retries"], target=name)

    def observe_request(self, api: str, status: int, duration_s: float,
                        rx: int, tx: int, bucket: str = "") -> None:
        self.api_requests.inc(api=api, status=str(status))
        if status >= 400:
            self.api_errors.inc(code=str(status))
        self.latency.observe(duration_s)
        self.bytes_rx.inc(rx)
        self.bytes_tx.inc(tx)
        if bucket:
            self.bandwidth.record(bucket, rx, tx)

    def update_ilm(self, tier_mgr) -> None:
        """Refresh ILM/tier gauges from TierManager.stats() (scrape
        time, same pattern as the hot-cache block)."""
        if tier_mgr is None:
            return
        st = tier_mgr.stats()
        self.ilm_transitioned.set(st["transitioned"])
        self.ilm_transition_bytes.set(st["transition_bytes"])
        self.ilm_transition_errors.set(st["transition_errors"])
        self.ilm_restored.set(st["restored"])
        self.ilm_restore_bytes.set(st["restore_bytes"])
        self.ilm_restore_expired.set(st["restore_expired"])
        self.ilm_journal_pending.set(st["journal_pending"])
        self.ilm_journal_replayed.set(st["replayed"])
        self.ilm_orphans_reaped.set(st["orphans_reaped"])
        self.tier_read_through.set(st["read_through"])
        self.tier_freed.set(st["freed"])
        for tname, usage in st["tiers"].items():
            self.tier_objects.set(usage["objects"], tier=tname)
            self.tier_bytes.set(usage["bytes"], tier=tname)

    def update_replication(self, repl) -> None:
        """Refresh replication gauges from ReplicationPool.stats()
        (scrape time; the legacy oracle reports its smaller dict and
        the journal-only gauges stay 0)."""
        if repl is None:
            return
        st = repl.stats()
        self.repl_queued.set(st.get("queued", 0))
        self.repl_completed.set(st.get("completed", 0))
        self.repl_failed.set(st.get("failed", 0))
        self.repl_retries.set(st.get("retries", 0))
        self.repl_dropped.set(st.get("dropped", 0))
        self.repl_bytes.set(st.get("bytesReplicated", 0))
        self.repl_proxied.set(st.get("proxiedReads", 0))
        self.repl_journal_pending.set(st.get("journalPending", 0))
        self.repl_journal_replayed.set(st.get("replayed", 0))
        lag = st.get("lagSeconds") or {}
        # a drained target's lag pins to 0 (stale label values would
        # otherwise report the last backlog age forever)
        for tb in getattr(self, "_repl_lag_seen", set()) | set(lag):
            self.repl_lag.set(lag.get(tb, 0.0), target=tb)
        self._repl_lag_seen = set(lag) | getattr(
            self, "_repl_lag_seen", set())
        self.repl_breaker_open.set(len(st.get("breakersOpen") or {}))

    def update_cluster(self, pools, scanner=None, tier_mgr=None) -> None:
        self.update_ilm(tier_mgr)
        cm = getattr(pools, "cache_metrics", None)
        if callable(cm):
            c = cm()
            self.cache_hits.set(c["hits"])
            self.cache_misses.set(c["misses"])
            self.cache_evictions.set(c["evictions"])
            self.cache_usage.set(c["usage_bytes"])
            self.cache_max.set(c["max_bytes"])
        tier = getattr(pools, "hot_tier", None)
        if tier is not None:
            hs = tier.stats()
            self.hotcache_hits.set(hs["hits"])
            self.hotcache_misses.set(hs["misses"])
            self.hotcache_meta_hits.set(hs["meta_hits"])
            self.hotcache_ratio.set(round(hs["hit_ratio"], 6))
            self.hotcache_fills.set(hs["fills"])
            self.hotcache_evictions.set(hs["evictions"])
            self.hotcache_bypassed.set(hs["bypassed"])
            self.hotcache_stale.set(hs["stale_gen"])
            self.hotcache_invalidations.set(hs["invalidations"])
            self.hotcache_entries.set(hs["entries"])
            self.hotcache_bytes.set(hs["cached_bytes"])
            self.hotcache_segment.set(hs["segment_bytes"])
            self.hotcache_ghost_defers.set(hs["ghost_defers"])
            self.hotcache_arena_in_use.set(hs["in_use_bytes"])
        online = offline = 0
        mrf_pending = mrf_healed = mrf_dropped = mrf_retries = 0
        mrf_seen: set[int] = set()
        _STATE = {"ok": 0, "suspect": 1, "offline": 2}
        for pi, pool in enumerate(pools.pools):
            for si, es in enumerate(getattr(pool, "sets", [pool])):
                for di, d in enumerate(es.drives):
                    state = 2
                    if d is None:
                        offline += 1
                    elif hasattr(d, "is_online") and not d.is_online():
                        offline += 1
                    elif hasattr(d, "health_state") \
                            and d.health_state() == "offline":
                        # Breaker-open circuit: physically present but
                        # out of the data path.
                        offline += 1
                    else:
                        online += 1
                        if hasattr(d, "health_state"):
                            state = _STATE.get(d.health_state(), 0)
                        else:
                            state = 0
                    self.drive_state.set(state, pool=str(pi),
                                         set=str(si), drive=str(di))
                mrf = getattr(es, "mrf", None)
                if mrf is not None and id(mrf) not in mrf_seen:
                    # One queue may serve every set of a pool — count
                    # it once.
                    mrf_seen.add(id(mrf))
                    mrf_pending += mrf.pending()
                    mrf_healed += mrf.healed
                    mrf_dropped += mrf.dropped
                    mrf_retries += getattr(mrf, "retries", 0)
        self.drive_online.set(online)
        self.drive_offline.set(offline)
        if hasattr(pools, "pool_status"):
            _DSTATE = {"draining": 0, "paused": 1, "complete": 2,
                       "cancelled": 3, "failed": 4}
            for row in pools.pool_status():
                pl = str(row["pool"])
                self.pool_total_bytes.set(row["total"], pool=pl)
                self.pool_free_bytes.set(row["free"], pool=pl)
                self.pool_draining.set(int(row["draining"]), pool=pl)
                ds = row.get("decommission")
                if ds:
                    self.decom_state.set(
                        _DSTATE.get(ds["state"], 4), pool=pl)
                    self.decom_objects_moved.set(
                        ds["objects_moved"], pool=pl)
                    self.decom_objects_remaining.set(
                        ds["objects_remaining"], pool=pl)
                    self.decom_versions_moved.set(
                        ds["versions_moved"], pool=pl)
                    self.decom_bytes_moved.set(
                        ds["bytes_moved"], pool=pl)
                    self.decom_bytes_per_sec.set(
                        ds["bytes_per_sec"], pool=pl)
                    self.decom_uploads_relocated.set(
                        ds["uploads_relocated"], pool=pl)
        self.mrf_pending.set(mrf_pending)
        self.mrf_healed.set(mrf_healed)
        self.mrf_dropped.set(mrf_dropped)
        self.mrf_retries.set(mrf_retries)
        if scanner is not None:
            usage = scanner.latest_usage()
            if usage is not None:
                for bucket, u in usage.buckets.items():
                    self.bucket_usage.set(u.bytes, bucket=bucket)
                    self.bucket_objects.set(u.objects, bucket=bucket)

    def update_peers(self, clients) -> None:
        """Refresh per-endpoint peer gauges from RPCClient liveness
        (called on scrape with the cluster node's peer clients)."""
        for cli in clients:
            info = cli.peer_info()
            ep = info["endpoint"]
            self.peer_state.set(1 if info["online"] else 0, endpoint=ep)
            self.peer_transitions.set(info["transitions"], endpoint=ep)
            self.peer_last_seen.set(info["last_seen_ago_s"], endpoint=ep)
            self.peer_rpc_timeout.set(info["timeout_s"], endpoint=ep)

    def _sync_datapath(self) -> None:
        from ..background import mrf as _mrf
        from ..engine import erasure_set as _es
        from ..engine import heal as _heal
        from ..ops import bpool as _bpool
        from ..ops import coalesce as _coalesce
        from ..ops import devcache as _devcache
        from ..ops import metalanes as _metalanes
        from ..ops import zerocopy as _zc
        from ..rpc import rest as _rest
        from ..storage import drive as _drive
        from ..storage import health_wrap as _hw
        from ..storage import recovery as _recovery
        snap = DATA_PATH.snapshot()
        self.heal_bytes.set(snap["heal_bytes"])
        self.heal_source_bytes.set(snap["heal_source_bytes"])
        # The pipelined heal's stage seconds are engine/heal.STAGES'
        # (its "compute" is the JAX package's "decode").
        hs = _heal.STAGES.read()
        for stage, key in (("read", "read"), ("decode", "compute"),
                           ("write", "write")):
            self.heal_stage_seconds.set(hs[key], stage=stage)
        self.heal_batches.set(snap["heal_batches"])
        self.heal_batch_occupancy.set(snap["heal_batch_occupancy"])
        self.degraded_reads.set(snap["degraded_reads"])
        self.degraded_bytes.set(snap["degraded_bytes"])
        self.degraded_seconds.set(snap["degraded_seconds"])
        self.healthy_reads.set(snap["healthy_reads"])
        self.healthy_bytes.set(snap["healthy_bytes"])
        for stage, s in snap["healthy_stage_s"].items():
            self.healthy_stage_seconds.set(s, stage=stage)
        self.fastpath_fallbacks.set(snap["fastpath_fallbacks"])
        self.mp_batches.set(snap["mp_batches"])
        self.mp_bytes.set(snap["mp_bytes"])
        for stage, s in snap["mp_stage_s"].items():
            self.mp_stage_seconds.set(s, stage=stage)
        # The coalescer's lanes in this process (a pool worker's own,
        # beside the front end that ships to the owner).
        remote = _coalesce._REMOTE
        co = remote.local if remote is not None else _coalesce._CO
        cst = co.stats() if co is not None else None
        if cst is not None:
            self.co_dispatches.set(cst["dispatches"])
            self.co_items.set(cst["items"])
            self.co_blocks.set(cst["weight"])
            self.co_occupancy.set(cst["occupancy"])
            self.co_wait_seconds.set(cst["wait_s"])
            self.co_batch_faults.set(cst["batch_faults"])
            self.co_member_retries.set(cst["member_retries"])
            for name, row in cst["lanes"].items():
                dev = str(_lane_index(name))
                self.device_lane_dispatches.set(row["dispatches"],
                                                device=dev)
                self.device_lane_occupancy.set(row["occupancy"],
                                               device=dev)
                self.device_lane_queue_wait.set(row["wait_s"], device=dev)
            self.h2d_pipeline_dispatches.set(cst["pipeline_dispatches"])
            self.h2d_overlap_seconds.set(cst["overlap_s"])
            self.h2d_pack_seconds.set(cst["pack_s"])
            self.h2d_upload_seconds.set(cst["h2d_s"])
            self.h2d_resolve_seconds.set(cst["resolve_s"])
        self.co_fallbacks.set(_coalesce.stats()["co_fallbacks"])
        if remote is not None:
            rst = remote.stats()
            self.ipc_submits.set(rst["remote_submits"])
            self.ipc_results.set(rst["remote_results"])
            self.ipc_fallbacks.set(rst["remote_fallbacks"])
            self.ipc_owner_deaths.set(rst["remote_owner_deaths"])
        est = _es.stats()
        for key in ("hedged_reads", "hedge_fired", "hedge_spares",
                    "hedge_wins"):
            getattr(self, key).set(est[key])
        for state, n in _hw.stats()["transitions"].items():
            self.drive_transitions.set(n, state=state)
        rec = _recovery.stats()
        self.recovery_sweeps.set(rec["sweeps"])
        self.recovery_tmp.set(rec["tmp_entries"])
        self.recovery_mp_stage.set(rec["mp_stage"])
        self.mrf_replayed.set(_mrf.stats()["replayed"])
        self.drains.set(snap["drains"])
        self.drain_leftover.set(snap["drain_leftover"])
        self.drain_seconds.set(snap["drain_seconds"])
        rs = _rest.stats()
        self.peer_flaps.set(rs["came_online"], state="online")
        self.peer_flaps.set(rs["went_offline"], state="offline")
        self.rpc_retries.set(rs["retries"])
        self.rpc_deadline_exceeded.set(rs["deadline_exceeded"])
        zs = _zc.stats()
        for key in ("hot_views", "hot_view_bytes", "sendmsg",
                    "sendmsg_bytes", "sendfile", "sendfile_bytes",
                    "fallbacks"):
            getattr(self, f"zerocopy_{key}").set(zs[key])
        ds = _drive.stats()
        self.zerocopy_vectored_writes.set(ds["vectored_writes"])
        self.zerocopy_vectored_write_bytes.set(ds["vectored_write_bytes"])
        ml = _metalanes.counters()
        pubs, fsyncs = ds["meta_publishes"], ds["meta_fsyncs"]
        commits, items = ds["meta_group_commits"], ds["meta_group_items"]
        reqs = est["meta_read_requests"]
        self.meta_publishes.set(pubs)
        self.meta_fsyncs.set(fsyncs)
        self.meta_fsyncs_per_object.set(
            round(fsyncs / pubs if pubs else 0.0, 6))
        self.meta_group_commits.set(commits)
        self.meta_group_items.set(items)
        self.meta_group_max.set(ds["meta_group_max"])
        self.meta_batch_occupancy.set(
            round(items / commits if commits else 0.0, 6))
        self.meta_journal_replays.set(ds["meta_journal_replays"])
        self.meta_read_requests.set(reqs)
        self.meta_read_rounds.set(ml["read_rounds"])
        self.meta_read_keys.set(ml["read_keys"])
        self.meta_read_fanouts.set(
            round(ml["read_rounds"] / reqs if reqs else 0.0, 6))
        self.meta_trim_hits.set(ml["trim_hits"])
        self.meta_trim_fallbacks.set(ml["trim_fallbacks"])
        self.meta_lane_dispatches.set(ml["lane_dispatches"])
        self.meta_inline_ops.set(ml["inline_ops"])
        # Aligned-buffer pool: scrape-only, never forces the shared
        # segment into existence (bpool.stats() is None until first use).
        bsnap = _bpool.stats()
        if bsnap is not None:
            self.bpool_gets.set(bsnap["gets"])
            self.bpool_fallbacks.set(bsnap["fallbacks"])
            self.bpool_released.set(bsnap["released"])
            self.bpool_leak_reclaims.set(bsnap["leak_reclaims"])
            self.bpool_bytes.set(bsnap["pool_bytes"])
            self.bpool_in_use.set(bsnap["in_use_bytes"])
        # Device-resident shard cache + H2D boundary ledger: scrape-only
        # pulls, same pattern as bpool (None until first use).
        dsnap = _devcache.stats()
        if dsnap is not None:
            self.devcache_hits.set(dsnap["hits"])
            self.devcache_misses.set(dsnap["misses"])
            self.devcache_ratio.set(round(dsnap["hit_ratio"], 6))
            self.devcache_fills.set(dsnap["fills"])
            self.devcache_evictions.set(dsnap["evictions"])
            self.devcache_invalidations.set(dsnap["invalidations"])
            self.devcache_stale_drops.set(dsnap["stale_drops"])
            self.devcache_rejects.set(dsnap["rejects"])
            self.devcache_entries.set(dsnap["entries"])
            self.devcache_resident.set(dsnap["resident_bytes"])
            self.devcache_capacity.set(dsnap["capacity_bytes"])
        hsnap = _devcache.h2d_stats()
        self.h2d_bytes.set(hsnap["h2d_bytes"])
        self.h2d_dispatches.set(hsnap["h2d_dispatches"])
        for dev, row in hsnap["lanes"].items():
            self.h2d_lane_bytes.set(row["h2d_bytes"], device=str(dev))
            self.h2d_lane_dispatches.set(row["h2d_dispatches"],
                                         device=str(dev))
        if self.kernel_launches is not None:
            from ..ops import (erasure_cuda, fused, highwayhash_cuda,
                               mxhash_torch)
            for k, v in (("gf_matmul", erasure_cuda.LAUNCHES),
                         ("hh256", highwayhash_cuda.LAUNCHES),
                         ("mxh256", mxhash_torch.LAUNCHES)):
                self.kernel_launches.set(v, kernel=k)
            for k, v in fused.ITEMS.items():
                self.kernel_items.set(v, kernel=k)

    def update_notify(self, counts: dict) -> None:
        """Refresh the notification families from the process's event
        counters and queue-store backlog (server/server.notify_counters;
        scrape time)."""
        for key, fam in self.notify.items():
            fam.set(counts[key])

    def _sync_spans(self) -> None:
        # Imported lazily: span.py is the one observe module allowed to
        # stay import-light (it sits on every request's hot path).
        from .span import BUCKETS_MS, TRACER
        snap = TRACER.snapshot()
        for api, a in snap["apis"].items():
            self.trace_api_count.set(a["count"], api=api)
            self.trace_api_errors.set(a["errors"], api=api)
            for q in ("p50", "p90", "p99"):
                self.trace_api_latency.set(a[f"{q}_ms"], api=api,
                                           quantile=q)
            for stage, st in a["stages"].items():
                self.trace_stage_count.set(st["count"], api=api,
                                           stage=stage)
                self.trace_stage_ms.set(st["total_ms"], api=api,
                                        stage=stage)
                cum = 0
                for i, bound in enumerate(BUCKETS_MS):
                    cum += st["buckets"][i]
                    le = ("+Inf" if bound == float("inf")
                          else f"{bound:g}")
                    self.trace_stage_hist.set(cum, api=api, stage=stage,
                                              le=le)

    def _sync_last_minute(self) -> None:
        for api, row in self.last_minute.snapshot().items():
            self.api_lm_count.set(row["count"], api=api)
            self.api_lm_errors.set(row["errors"], api=api)
            self.api_lm_sheds.set(row["sheds"], api=api)
            self.api_lm_p50.set(row["p50_ms"], api=api)
            self.api_lm_p99.set(row["p99_ms"], api=api)

    def families(self) -> list:
        """Every exported metric family, in definition order — the
        enumerable registry the render loop and the boot self-test
        (ops/selftest.metrics_registry_self_test) both walk, so a
        family can never exist without being rendered and checked."""
        out = []
        for m in self.__dict__.values():
            if isinstance(m, (Counter, Histogram)):
                out.append(m)
            elif isinstance(m, dict):
                out.extend(v for v in m.values()
                           if isinstance(v, (Counter, Histogram)))
        return out

    def render(self) -> str:
        self._sync_datapath()
        self._sync_spans()
        self._sync_last_minute()
        out: list[str] = []
        for m in self.families():
            m.render(out)
        return "\n".join(out) + "\n"


def label_sample(line: str, key: str, value: str) -> str:
    """Inject one label into a Prometheus sample line
    (`name{a="b"} v` or `name v`)."""
    head, _, val = line.rpartition(" ")
    if head.endswith("}"):
        return f'{head[:-1]},{key}="{value}"}} {val}'
    return f'{head}{{{key}="{value}"}} {val}'


def merge_prom(sections: list[tuple[str, str]]) -> str:
    """Merge per-node Prometheus renders into one valid exposition:
    HELP/TYPE once per family (first seen wins), every sample line
    relabeled with node="host:port", samples grouped under their
    family.  Input sections are (node, text) pairs as produced by
    S3Server.local_metrics_text on each node."""
    meta: dict[str, list[str | None]] = {}    # family -> [help, type]
    rows: dict[str, list[str]] = {}
    order: list[str] = []
    for node, text in sections:
        current = None
        for line in text.splitlines():
            if not line.strip():
                continue
            if line.startswith(("# HELP ", "# TYPE ")):
                fam = line.split(None, 3)[2]
                if fam not in rows:
                    rows[fam] = []
                    meta[fam] = [None, None]
                    order.append(fam)
                slot = 0 if line.startswith("# HELP ") else 1
                if meta[fam][slot] is None:
                    meta[fam][slot] = line
                current = fam
                continue
            if line.startswith("#"):
                continue
            if current is None:
                # Bare sample with no preceding comment: group under
                # its own metric name.
                current = line.split("{", 1)[0].split()[0]
                if current not in rows:
                    rows[current] = []
                    meta[current] = [None, None]
                    order.append(current)
            rows[current].append(label_sample(line, "node", node))
    out: list[str] = []
    for fam in order:
        for comment in meta[fam]:
            if comment is not None:
                out.append(comment)
        out.extend(rows[fam])
    return "\n".join(out) + "\n"
