"""Pre-fork worker pool: N HTTP server processes and one device owner.

Counterpart of minio_tpu/server/workers.py.  One server process serves
its requests under one GIL: four clients PUT no faster than one.  The
pool runs the S3 vertical in N processes:

  supervisor (this module: stdlib and numpy only, never torch)
    |- device owner   runs the startup self-tests, then every kernel
    |                 of the pool: its DispatchCoalescer packs the
    |                 batches of all workers per card, and it serves
    |                 the shared-memory dispatch plane
    |                 (ops/ipc_dispatch.py)
    |- worker 0       full S3 vertical; also the recovery owner: the
    |                 boot recovery sweep (on its first spawn only), MRF
    |                 orphan-journal adoption, the data scanner and the
    |                 decommission movers (resumed on every spawn)
    |- worker 1..N-1  full S3 vertical

Every worker binds the same (host, port) with SO_REUSEPORT, and the
kernel spreads accepted connections over them: no proxy hop, no fd
passing.  Shard batches cross to the owner through a preallocated
ShmArena and ShmRing descriptors; nothing bigger than 64 bytes is
queued.

Contracts:

- CUDA is never initialised in a process that forks.  The supervisor
  imports no torch (nor anything that does) and builds the shared plane;
  each child imports torch after its fork.  A worker's sets are on the
  card, but the worker opens a CUDA context only when it computes an
  item itself (a fallback); its device shard cache is off
  (MTPU_DEVCACHE=0), since the cache's rows would live in the worker's
  context.
- Boot order: the owner first; it runs the self-tests on the boot's
  device and registers only when they pass.  A failing self-test ends
  the boot with a non-zero exit.  Then the workers: they import
  together, but worker 0 alone opens the drives until it serves
  (format.json, the recovery sweep, MRF adoption: writes the others
  must observe); the JAX package forks the others only then.
- SIGTERM or SIGINT on the supervisor fans SIGTERM out to the workers;
  each drains (503 on new requests, inflight ones complete, MRF
  checkpoints) and exits 0; the owner is retired last, so in-drain
  requests keep their dispatch plane; the supervisor exits 0.  A second
  signal SIGKILLs everything.
- A worker that dies is respawned after MTPU_RESPAWN_DELAY_S with its
  `mtpu_worker_respawns_total` counter bumped.  The respawn neither
  sweeps (the tmp dir holds the live workers' staging) nor replays: it
  removes its predecessor's metadata journal segments, whose items were
  never acknowledged, before it serves (storage/drive.py
  `retire_meta_segments`).  A dead owner is marked
  down at once (its pending handles fail within MTPU_OWNER_STALE_S and
  the engine recomputes them on the worker's device), then respawned
  under a new generation; workers route to it again once it beats.  An
  owner whose heartbeat goes stale is killed and respawned the same way.
  A respawned owner that dies before it registers (a failing self-test)
  ends the pool with a non-zero exit instead of being respawned again.
- A respawned worker adopts the arena slots its predecessor held (the
  plane's ledger) and frees each when its answer comes or its owner
  generation is gone; request ids carry the incarnation, so no answer
  to the predecessor resolves one of its own requests.
- Each child sets PR_SET_PDEATHSIG(SIGKILL): a kill -9 on the
  supervisor leaves no worker holding the port.

The hot-object tier (engine/hotcache.py) is built by the supervisor
before the first fork (`WorkerPlane.hotcache`, None under
MTPU_HOTCACHE=0) and attached by every worker: one warm copy of the hot
set for the pool, worker A's fill is worker B's hit, and a write through
any worker bumps the shared generation every worker checks.  Each worker
counts its hits and misses in its slab (`mtpu_worker_hotcache_*`).

The admission plane's slab (server/qos.py) is built the same way
(`WorkerPlane.qos`): one requests-max cap and one pressure signal for
the pool.  Each worker counts its occupancy in its own row of the slab
(`mtpu_qos_worker_*`), and the supervisor clears a dead worker's row
when it reaps it, so slots held or awaited by a killed worker come back
before its respawn serves.  The namespace lock's stripe table
(cluster/nslock.py) is made before the fork too: two workers writing
one key exclude each other.  Every fork-shared lock of the pool (the
tier's, the arenas', the slab's, the stripes') is an ops/shm_lock
robust mutex: a worker killed inside one leaves no other blocked.

The pool topology (server/topology.py): a worker that serves admin
pool/add or a decommission action writes pool-topology.json and bumps
the shared topology generation; every worker polls it in its idle loop
and attaches the new pools, adopts the draining set and reloads the
multipart relocation maps, and a worker spawned later boots the pools
the file names.  A drain's mover runs in worker 0 alone: another worker
records the admin's request in the drain's journal, and worker 0 folds
the journals into its movers on each generation and every 2 s
(background/decom.reconcile); its every spawn resumes the active drains,
so a drain survives the death of the worker that ran it.  The data
scanner runs in worker 0 (MTPU_SCANNER); the other workers mark the
buckets they write in a fork-shared table (background/usage.SharedMarks,
built before the fork), so worker 0's next cycle rescans them, and read
the usage it persisted.

Bucket configs and the server configuration: a worker that stores one
(a `?versioning`, `?notification`, `?replication`... PUT or DELETE, an
admin `config` set, an admin `tier` add or remove) bumps the shared
config generation, and every worker rereads the configuration, drops
its cached bucket configs, registers the notification targets a set
enabled, reloads the notification rules and the persisted tiers and
rewires replication at its next look (`mtpu_worker_config_generation`
shows it).  The tier journal is one file for the pool: appends and
compactions hold its flock, and no worker reaps the copy of a
transition another live worker runs (bucket/tier.py).  Each worker builds
the configuration's notification targets over one queue store for the
pool (`<MTPU_NOTIFY_STORE_DIR>/<kind>/`): its tickets sort in pool-wide
arrival order and one worker's retry loop, the holder of the store's
sender lock, drains it (bucket/notify.py), so a key's events reach the
target in order whichever workers served them.  Each worker publishes
its event counters in its slab (`mtpu_worker_notify_*`).

`MTPU_WORKERS=0` (the default) never enters this module: one process
remains the oracle.
"""

from __future__ import annotations

import mmap
import os
import signal
import socket
import sys
import threading
import time

import numpy as np

from ..ops.ipc_knobs import owner_stale_s
from ..ops.ipc_ring import ShmRing
from ..ops.shm_arena import ShmArena, default_arena_bytes

#: the kernels whose launches and items the owner and each worker publish
KERNELS = ("gf_matmul", "hh256", "mxh256")

#: the notification counters each worker publishes (server/server.py
#: notify_counters)
NOTIFY_COUNTERS = ("sent", "delivered", "parked", "retried", "dropped",
                   "backlog")

#: records in the request ring and in each worker's response ring
RING_CAPACITY = 512

#: seconds the supervisor waits for the owner's self-tests and worker 0's
#: boot before it gives up (the JAX pool's default)
BOOT_TIMEOUT_S = 120.0

#: shared control block: int64 slots, one writer per slot.  Global slots:
_G = {name: i for i, name in enumerate((
    "owner_gen", "owner_pid", "owner_beat_ns", "co_dispatches", "co_items",
    "co_pending", "co_pipelined", "co_pack_ns", "co_staged_bytes",
    "owner_cuda", "topology_gen", "config_gen",
    *(f"launches_{k}" for k in KERNELS),
    *(f"items_{k}" for k in KERNELS)))}
_GHDR = len(_G)
#: per-worker slab
_W = {name: i for i, name in enumerate((
    "pid", "beat_ns", "ready", "draining", "respawns", "requests",
    "inflight", "ipc_fallbacks", "co_fallbacks", "remote_submits", "cuda",
    "hotcache_hits", "hotcache_misses", "config_gen", "config_writes",
    "topology_gen",
    *(f"notify_{k}" for k in NOTIFY_COUNTERS),
    *(f"launches_{k}" for k in KERNELS),
    *(f"items_{k}" for k in KERNELS)))}
_WSLOTS = len(_W)
#: serialises this process's read-modify-write of its own slab slots
_SLAB_MU = threading.Lock()


def nworkers_env() -> int:
    try:
        return max(0, int(os.environ.get("MTPU_WORKERS", "0") or 0))
    except ValueError:
        return 0


def _respawn_delay_s() -> float:
    try:
        return max(0.0,
                   float(os.environ.get("MTPU_RESPAWN_DELAY_S", "0.5")))
    except ValueError:
        return 0.5


def _now_ns() -> int:
    return time.monotonic_ns()


def _set_pdeathsig() -> None:
    """Die with the supervisor: PR_SET_PDEATHSIG(SIGKILL).  A kill -9
    on the parent must not leave this child holding the port."""
    try:
        import ctypes
        libc = ctypes.CDLL(None, use_errno=True)
        libc.prctl(1, signal.SIGKILL)       # PR_SET_PDEATHSIG == 1
    except Exception:  # noqa: BLE001 — non-Linux: supervised exit only
        pass


class SharedState:
    """The cross-process control block: owner generation, heartbeat and
    counters, and per-worker liveness, respawn, request and dispatch
    slabs.  One anonymous shared mapping, created before any fork; every
    slot has one writer, so reads take no lock."""

    def __init__(self, nworkers: int):
        self.nworkers = int(nworkers)
        self._mm = mmap.mmap(-1, (_GHDR + self.nworkers * _WSLOTS) * 8)
        self._a = np.frombuffer(self._mm, dtype=np.int64)

    def _w(self, idx: int) -> int:
        return _GHDR + int(idx) * _WSLOTS

    # owner ------------------------------------------------------------------

    def bump_owner_gen(self) -> int:
        self._a[_G["owner_gen"]] += 1
        return int(self._a[_G["owner_gen"]])

    def owner_gen(self) -> int:
        return int(self._a[_G["owner_gen"]])

    def owner_pid(self) -> int:
        return int(self._a[_G["owner_pid"]])

    def owner_register(self, pid: int) -> None:
        self._a[_G["owner_beat_ns"]] = _now_ns()
        self._a[_G["owner_pid"]] = pid

    def owner_down(self) -> None:
        """The supervisor saw the owner die: down now, not a heartbeat
        period later; its counters go with it (the next generation
        counts from 0)."""
        keep = self._a[[_G["topology_gen"], _G["config_gen"]]].copy()
        self._a[_G["owner_gen"] + 1:_GHDR] = 0
        self._a[[_G["topology_gen"], _G["config_gen"]]] = keep

    # topology ---------------------------------------------------------------

    def bump_topology_gen(self) -> int:
        """The pool topology's epoch: bumped by the worker that served a
        pool/add or a decommission action, after pool-topology.json was
        written (server/topology.py)."""
        with _SLAB_MU:
            self._a[_G["topology_gen"]] += 1
            return int(self._a[_G["topology_gen"]])

    def topology_gen(self) -> int:
        return int(self._a[_G["topology_gen"]])

    def topology_applied(self, idx: int, gen: int) -> None:
        """Worker `idx` has folded the pool topology of generation `gen`
        in (its pools, its draining set)."""
        self._a[self._w(idx) + _W["topology_gen"]] = gen

    def bump_config_gen(self) -> int:
        """The bucket configs' epoch: bumped by the worker that wrote or
        deleted one (a replication, object-lock or lifecycle config, a
        remote target), after the store."""
        with _SLAB_MU:
            self._a[_G["config_gen"]] += 1
            return int(self._a[_G["config_gen"]])

    def config_gen(self) -> int:
        return int(self._a[_G["config_gen"]])

    def note_config_write(self, idx: int) -> int:
        """Worker `idx` stored a bucket config or the server config: the
        pool's config generation moves, and the worker's write count."""
        with _SLAB_MU:
            self._a[self._w(idx) + _W["config_writes"]] += 1
        return self.bump_config_gen()

    def config_applied(self, idx: int, gen: int) -> None:
        """Worker `idx` has reloaded the bucket configs of generation
        `gen`."""
        self._a[self._w(idx) + _W["config_gen"]] = gen

    def owner_beat(self, co_stats: dict | None = None,
                   kernels: dict | None = None, cuda: bool = False) -> None:
        a = self._a
        if co_stats:
            a[_G["co_dispatches"]] = int(co_stats.get("dispatches", 0))
            a[_G["co_items"]] = int(co_stats.get("items", 0))
            a[_G["co_pending"]] = int(co_stats.get("pending_items", 0))
            a[_G["co_pipelined"]] = int(co_stats.get(
                "pipeline_dispatches", 0))
            a[_G["co_pack_ns"]] = int(co_stats.get("pack_s", 0.0) * 1e9)
            a[_G["co_staged_bytes"]] = int(co_stats.get("h2d_bytes", 0))
        for name, v in (kernels or {}).items():
            a[_G[name]] = int(v)
        a[_G["owner_cuda"]] = int(cuda)
        a[_G["owner_beat_ns"]] = _now_ns()

    def owner_ok(self, stale_s: float) -> bool:
        if not self._a[_G["owner_pid"]]:
            return False
        return (_now_ns() - int(self._a[_G["owner_beat_ns"]])
                < int(stale_s * 1e9))

    def owner_info(self) -> dict:
        a = self._a
        d = int(a[_G["co_dispatches"]])
        return {
            "role": "owner", "pid": int(a[_G["owner_pid"]]),
            "generation": int(a[_G["owner_gen"]]),
            "up": self.owner_ok(owner_stale_s()),
            "cuda": bool(a[_G["owner_cuda"]]),
            "co_dispatches": d, "co_items": int(a[_G["co_items"]]),
            "co_pending_items": int(a[_G["co_pending"]]),
            "co_occupancy": (int(a[_G["co_items"]]) / d) if d else 0.0,
            "co_pipelined": int(a[_G["co_pipelined"]]),
            "co_pack_s": int(a[_G["co_pack_ns"]]) / 1e9,
            "co_staged_bytes": int(a[_G["co_staged_bytes"]]),
            **{n: int(a[_G[n]]) for n in _G
               if n.startswith(("launches_", "items_"))},
        }

    # workers ----------------------------------------------------------------

    def worker_pid(self, idx: int) -> int:
        return int(self._a[self._w(idx) + _W["pid"]])

    def worker_register(self, idx: int, pid: int) -> None:
        w = self._w(idx)
        self._a[w + _W["pid"]] = pid
        self._a[w + _W["beat_ns"]] = _now_ns()
        self._a[w + _W["ready"]] = 0
        self._a[w + _W["draining"]] = 0

    def worker_beat(self, idx: int, inflight: int = 0,
                    counters: dict | None = None) -> None:
        w = self._w(idx)
        self._a[w + _W["beat_ns"]] = _now_ns()
        self._a[w + _W["inflight"]] = int(inflight)
        for name, v in (counters or {}).items():
            self._a[w + _W[name]] = int(v)

    def set_ready(self, idx: int) -> None:
        self._a[self._w(idx) + _W["ready"]] = 1

    def is_ready(self, idx: int) -> bool:
        return bool(self._a[self._w(idx) + _W["ready"]])

    def set_draining(self, idx: int) -> None:
        self._a[self._w(idx) + _W["draining"]] = 1

    def bump_respawn(self, idx: int) -> int:
        w = self._w(idx) + _W["respawns"]
        self._a[w] += 1
        return int(self._a[w])

    def respawns(self, idx: int) -> int:
        return int(self._a[self._w(idx) + _W["respawns"]])

    def note_request(self, idx: int) -> None:
        self._a[self._w(idx) + _W["requests"]] += 1

    def note_hotcache(self, idx: int, hit: bool) -> None:
        """This worker's hot-tier hit or miss: the tier is shared, so the
        per-worker counts are what shows worker B hitting worker A's
        fills.  Request threads share the slot: the add takes a lock."""
        with _SLAB_MU:
            self._a[self._w(idx) + _W["hotcache_hits" if hit
                                      else "hotcache_misses"]] += 1

    def worker_rows(self) -> list[dict]:
        stale = int(owner_stale_s() * 1e9)
        now = _now_ns()
        rows = []
        for i in range(self.nworkers):
            w = self._w(i)
            row = {"worker": i}
            row.update({n: int(self._a[w + j]) for n, j in _W.items()})
            row["up"] = bool(row["pid"]) and now - row.pop("beat_ns") < stale
            for n in ("ready", "draining", "cuda"):
                row[n] = bool(row[n])
            rows.append(row)
        return rows


class WorkerPlane:
    """Everything the pool shares, created by the supervisor before any
    fork: the control block, the shard arena, the request ring into the
    owner, one response ring per worker, and per worker slot the ledger
    of the arena slots it holds (`inflight`, rows of request id, offset,
    length and generation; id 0 is a free row), which a respawned worker
    adopts.  Also the duck type ops/ipc_dispatch.py talks to (arena,
    req_ring, resp_rings, inflight, state, owner_ok, owner_gen).
    `hotcache` is the pool-shared hot tier (engine/hotcache.maybe_tier,
    None under MTPU_HOTCACHE=0); `qos` the admission slab
    (server/qos.get_plane, one row per worker)."""

    def __init__(self, nworkers: int, arena_bytes: int | None = None,
                 ring_capacity: int = RING_CAPACITY):
        self.nworkers = int(nworkers)
        self.state = SharedState(self.nworkers)
        self.arena = ShmArena(arena_bytes or default_arena_bytes())
        self.req_ring = ShmRing(ring_capacity)
        self.resp_rings = [ShmRing(ring_capacity)
                           for _ in range(self.nworkers)]
        # A slot holds at least one arena slot: nslots rows never run out.
        rows = self.arena.nslots
        self._ledger_mm = mmap.mmap(-1, max(1, self.nworkers) * rows * 32)
        self.inflight = np.frombuffer(self._ledger_mm, dtype=np.int64)[
            :self.nworkers * rows * 4].reshape(self.nworkers, rows, 4)
        # The tier's segment must exist before the first fork so every
        # worker inherits the same mapping (engine/hotcache.py imports
        # no torch).
        from ..engine.hotcache import maybe_tier
        self.hotcache = maybe_tier()
        # The admission slab and the namespace lock's stripes likewise:
        # get_plane() and shared_stripes() install the module singletons
        # every forked worker's S3Server and ErasureSets pick up.
        from ..cluster.nslock import shared_stripes
        from . import qos as _qos
        self.qos = _qos.get_plane(nworkers=self.nworkers)
        shared_stripes()
        # The dirty-bucket marks every worker makes and worker 0's
        # scanner reads (background/usage.py imports no torch).
        from ..background.usage import SharedMarks
        self.dirty_marks = SharedMarks()

    def owner_ok(self) -> bool:
        return self.state.owner_ok(owner_stale_s())

    def owner_gen(self) -> int:
        return self.state.owner_gen()

    def render_prom(self) -> str:
        """Prometheus families of the pool, served by every worker at
        /minio/v2/metrics/node: the slabs live in shared memory, so
        whichever worker a scrape lands on exports the pool's view."""
        out = []

        def fam(name, help_, rows):
            out.append(f"# HELP {name} {help_}")
            out.append(f"# TYPE {name} gauge")
            for labels, v in rows:
                lab = ",".join(f'{k}="{v2}"' for k, v2 in labels.items())
                out.append(f"{name}{{{lab}}} {v}" if lab else f"{name} {v}")

        rows = self.state.worker_rows()

        def per_worker(name, help_, field):
            fam(name, help_,
                [({"worker": r["worker"]}, int(r[field])) for r in rows])

        per_worker("mtpu_worker_up", "Worker heartbeat is fresh", "up")
        per_worker("mtpu_worker_pid", "Worker process id", "pid")
        per_worker("mtpu_worker_ready", "Worker serves its port", "ready")
        per_worker("mtpu_worker_draining", "Worker is draining", "draining")
        per_worker("mtpu_worker_respawns_total",
                   "Times the supervisor respawned this worker slot",
                   "respawns")
        per_worker("mtpu_worker_requests_total",
                   "HTTP requests handled by this worker", "requests")
        per_worker("mtpu_worker_inflight_requests",
                   "Requests currently inflight in this worker", "inflight")
        per_worker("mtpu_worker_remote_submits_total",
                   "Items this worker sent to the device owner",
                   "remote_submits")
        per_worker("mtpu_worker_ipc_fallbacks_total",
                   "Owner-bound items this worker computed itself "
                   "(arena or ring full, owner down)", "ipc_fallbacks")
        per_worker("mtpu_worker_co_fallbacks_total",
                   "Failed handles this worker recomputed directly",
                   "co_fallbacks")
        per_worker("mtpu_worker_cuda_context",
                   "This worker has initialised CUDA", "cuda")
        for key, help_ in (
                ("sent", "Events this worker handed to notification "
                         "targets"),
                ("delivered", "Events this worker's targets "
                              "acknowledged"),
                ("parked", "Events this worker parked while a target "
                           "was down"),
                ("retried", "Parked events this worker's retry passes "
                            "delivered"),
                ("dropped", "Events this worker dropped: their rule "
                            "names an ARN with no target")):
            per_worker(f"mtpu_worker_notify_events_{key}_total", help_,
                       f"notify_{key}")
        per_worker("mtpu_worker_notify_backlog_events",
                   "Events parked in this worker's queue stores now",
                   "notify_backlog")
        fam("mtpu_topology_generation",
            "Pool adds and drain actions through the pool's workers",
            [({}, self.state.topology_gen())])
        per_worker("mtpu_worker_topology_generation",
                   "The topology generation this worker has folded in",
                   "topology_gen")
        fam("mtpu_config_generation",
            "Bucket-config and server-config writes through the pool's "
            "workers",
            [({}, self.state.config_gen())])
        per_worker("mtpu_worker_config_generation",
                   "The config generation this worker has reloaded",
                   "config_gen")
        per_worker("mtpu_worker_config_writes_total",
                   "Bucket-config and server-config writes this worker "
                   "served", "config_writes")
        # Per-worker view of the shared tier (its own counters are the
        # mtpu_hotcache_* families).
        per_worker("mtpu_worker_hotcache_hits_total",
                   "Hot-object cache hits served by this worker",
                   "hotcache_hits")
        per_worker("mtpu_worker_hotcache_misses_total",
                   "Hot-object cache misses seen by this worker",
                   "hotcache_misses")
        qrows = self.qos.worker_rows()
        fam("mtpu_qos_worker_inflight",
            "Admission slots held by this worker's requests",
            [({"worker": i}, r[0]) for i, r in enumerate(qrows)])
        fam("mtpu_qos_worker_waiting",
            "This worker's requests in the admission deadline queue",
            [({"worker": i}, r[1]) for i, r in enumerate(qrows)])
        for what in ("launches", "items"):
            fam(f"mtpu_worker_kernel_{what}_total",
                f"Kernel {what} in this worker",
                [({"worker": r["worker"], "kernel": k}, r[f"{what}_{k}"])
                 for r in rows for k in KERNELS])
        oi = self.state.owner_info()
        fam("mtpu_owner_up", "Device-owner heartbeat is fresh",
            [({}, int(oi["up"]))])
        fam("mtpu_owner_pid", "Device-owner process id", [({}, oi["pid"])])
        fam("mtpu_owner_generation", "Device-owner respawn generation",
            [({}, oi["generation"])])
        fam("mtpu_owner_cuda_context", "The owner has initialised CUDA",
            [({}, int(oi["cuda"]))])
        fam("mtpu_owner_coalesce_dispatches_total",
            "Owner-side coalesced dispatches (this generation)",
            [({}, oi["co_dispatches"])])
        fam("mtpu_owner_coalesce_items_total",
            "Items in owner-side dispatches (this generation)",
            [({}, oi["co_items"])])
        fam("mtpu_owner_coalesce_occupancy",
            "Mean items per owner-side coalesced dispatch",
            [({}, round(oi["co_occupancy"], 4))])
        fam("mtpu_owner_coalesce_pending_items",
            "Items queued in the owner's coalescer",
            [({}, oi["co_pending_items"])])
        fam("mtpu_owner_lane_pipelined_dispatches_total",
            "Owner dispatches staged through the pinned buffers",
            [({}, oi["co_pipelined"])])
        fam("mtpu_owner_lane_pack_seconds_total",
            "Seconds the owner's lanes spent packing staged batches",
            [({}, oi["co_pack_s"])])
        fam("mtpu_owner_lane_staged_bytes_total",
            "Bytes the owner's lanes packed and copied to the card",
            [({}, oi["co_staged_bytes"])])
        for what in ("launches", "items"):
            fam(f"mtpu_owner_kernel_{what}_total",
                f"Kernel {what} in the device owner (this generation)",
                [({"kernel": k}, oi[f"{what}_{k}"]) for k in KERNELS])
        a = self.arena.stats()
        fam("mtpu_shm_arena_bytes", "Dispatch arena capacity",
            [({}, a["arena_bytes"])])
        fam("mtpu_shm_arena_in_use_bytes", "Dispatch arena occupancy",
            [({}, a["in_use_bytes"])])
        fam("mtpu_shm_arena_high_water_bytes",
            "Dispatch arena high-water occupancy",
            [({}, a["high_water_bytes"])])
        fam("mtpu_shm_arena_alloc_waits_total",
            "Arena allocations that had to wait (backpressure)",
            [({}, a["alloc_waits"])])
        fam("mtpu_shm_arena_alloc_timeouts_total",
            "Arena allocations that timed out (caller computed locally)",
            [({}, a["alloc_timeouts"])])
        fam("mtpu_ipc_ring_depth", "Dispatch ring queue depth",
            [({"ring": "request"}, self.req_ring.depth())]
            + [({"ring": f"response{i}"}, r.depth())
               for i, r in enumerate(self.resp_rings)])
        return "\n".join(out) + "\n"


# -- child process mains ------------------------------------------------------

#: set by the provisional child signal handler when a TERM/INT lands
#: during boot, before the child's real handler exists (the handler
#: inherited from the supervisor would swallow the drain fan-out).
_early_stop = {"hit": False}


def _provisional_sig(signum, frame):
    _early_stop["hit"] = True


def _child_entry(fn, *a) -> None:
    """Run a forked child's main; any escape is a crash, not a return
    into the supervisor's stack."""
    signal.signal(signal.SIGTERM, _provisional_sig)
    signal.signal(signal.SIGINT, _provisional_sig)
    try:
        rc = fn(*a)
    except SystemExit as e:
        rc = int(e.code or 0)
    except BaseException:  # noqa: BLE001 — show the child's death
        import traceback
        traceback.print_exc()
        rc = 1
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(rc & 0xFF)


def _stop_event() -> threading.Event:
    stop = threading.Event()

    def _sig(signum, frame):
        # Idempotent: the supervisor re-sends TERM while stopping, and
        # owns the force path.
        stop.set()
    signal.signal(signal.SIGTERM, _sig)
    signal.signal(signal.SIGINT, _sig)
    if _early_stop["hit"]:       # TERM landed during the boot
        stop.set()
    return stop


def _kernel_counters() -> dict:
    """This process's kernel launches and work items, by slot name."""
    from ..ops import erasure_cuda, fused, highwayhash_cuda, mxhash_torch
    out = {"launches_gf_matmul": erasure_cuda.LAUNCHES,
           "launches_hh256": highwayhash_cuda.LAUNCHES,
           "launches_mxh256": mxhash_torch.LAUNCHES}
    out.update({f"items_{k}": v for k, v in fused.ITEMS.items()})
    return out


def _owner_main(plane: WorkerPlane, device) -> int:
    _set_pdeathsig()
    # The owner is the remote end: it never submits remotely.
    os.environ["MTPU_IPC_DISPATCH"] = "0"
    stop = _stop_event()
    import torch

    from ..ops import coalesce, ipc_dispatch
    from . import boot

    # The kernels that serve are this process's: they pass the
    # self-tests before the first descriptor is read.
    print(f"{boot.self_tests(device)} [device owner, generation "
          f"{plane.owner_gen()}]", flush=True)
    co = coalesce.get()
    threads = ipc_dispatch.serve_owner(plane, stop, co)

    def beat():
        plane.state.owner_beat(co.stats(), _kernel_counters(),
                               torch.cuda.is_initialized())
    # The counters (the self-tests' launches among them) are out before
    # the owner is up.  Then the heartbeat on the main thread: workers
    # route to the owner only while it is fresh; the supervisor kills an
    # owner that stops beating.
    beat()
    plane.state.owner_register(os.getpid())
    while not stop.wait(0.1):
        beat()
    for t in threads:
        t.join(timeout=5)
    co.close()
    return 0


def _worker_main(plane: WorkerPlane, idx: int, cfg: dict,
                 after_w0: bool = False) -> int:
    _set_pdeathsig()
    # MRF: one journal per worker; worker 0 adopts the orphans.
    os.environ["MTPU_WORKER_ID"] = str(idx)
    os.environ["MTPU_WORKERS_TOTAL"] = str(plane.nworkers)
    # The device shard cache keeps rows on the card in the process that
    # read them: a worker would open a context for it.
    os.environ["MTPU_DEVCACHE"] = "0"
    # A respawn: the slot still names the dead predecessor, whose
    # metadata journal segments this worker retires before it serves.
    respawn = plane.state.respawns(idx) > 0
    predecessor = plane.state.worker_pid(idx) if respawn else 0
    plane.state.worker_register(idx, os.getpid())
    # This worker's admission slots are counted in its own row, which
    # the supervisor cleared when it reaped a predecessor.
    plane.qos.bind_row(idx)

    import torch

    from ..background import decom
    from ..background.mrf import attach_mrf
    from ..background.scanner import scanner_from_env
    from ..background.usage import DirtyTracker
    from ..bucket.replication import ReplicationPool
    from ..iam.iam import IAMSys
    from ..ops import coalesce
    from ..ops import ipc_dispatch as ipc
    from . import boot
    from . import topology as topo
    from .__main__ import (LEFT_OUT, adopt_pools, config_line,
                           replication_line, tier_manager)
    from .server import S3Server, notify_counters
    from .sigv4 import Credentials

    # Every set this process builds marks the pool-shared table.
    DirtyTracker.shared().attach_shared(plane.dirty_marks)

    # The engine's call sites keep calling coalesce.get(): the device
    # kinds go to the owner, the rest stay on this worker's lanes.  Made
    # first, so a respawned worker adopts the slots its predecessor held
    # (their answers may already wait in its response ring).
    remote = ipc.RemoteCoalescer(plane, idx)

    # At the pool's boot the other workers import alongside worker 0 but
    # touch the drives only once it serves (format.json, the sweep and
    # MRF adoption are its writes to observe).
    while after_w0 and not plane.state.is_ready(0):
        if _early_stop["hit"]:
            return 0
        time.sleep(0.05)
    # The recovery sweep runs once per pool boot, on worker 0's first
    # spawn, before any worker serves.  A respawned worker 0 must not
    # sweep: the tmp dir then holds the staging of PUTs and part uploads
    # the live workers are running.
    pools, wrapped, swept = boot.object_layer(
        cfg["pool_paths"], cfg["set_drive_count"], cfg["device"],
        sweep=idx == 0 and not respawn, retire_pid=predecessor)
    if idx == 0 and not respawn:
        print(boot.sweep_line(swept), flush=True)
    if predecessor:
        print(f"minio_tpu_torch: worker {idx} retired "
              f"{swept['retired_segments']} metadata journal segments of "
              f"its predecessor (pid {predecessor})", flush=True)
    mrf_queues: list = []
    scanner = replication = None
    try:
        mrf_queues = attach_mrf(pools)
        if plane.hotcache is not None:
            # The segment this worker inherited; its hits and misses
            # also land in this worker's slab.
            from ..engine.hotcache import attach_pools as attach_hotcache
            if attach_hotcache(pools, plane.hotcache) is not None:
                plane.hotcache.on_lookup = (
                    lambda hit, _i=idx: plane.state.note_hotcache(_i, hit))
        coalesce.attach_remote(remote)
        # The pools pool-topology.json adds to the flags (and their
        # draining set); worker 0 resumes the active drains and scans.
        topo_seen = plane.state.topology_gen()
        if idx == 0:
            print(f"{adopt_pools(pools)} [worker 0]", flush=True)
            scanner = scanner_from_env(pools)
        else:
            topo.adopt_topology(pools)
        plane.state.topology_applied(idx, topo_seen)
        # This worker's own journal (repl-journal.w<idx>.jsonl), its
        # predecessor's replayed; worker 0 adopts the orphans on every
        # spawn.
        replication = ReplicationPool(pools)
        print(f"{replication_line(replication)} [worker {idx}]",
              flush=True)
        # One tier journal and one tier registry for the pool: each
        # worker's manager replays what no live process owns, and a tier
        # one worker registers reaches the others through the config
        # generation.
        tier_mgr, line = tier_manager(pools)
        if line:
            print(f"{line} [worker {idx}]", flush=True)
        tier_mgr.on_change = lambda: plane.state.note_config_write(idx)
        iam = IAMSys(pools)
        srv = S3Server(pools, Credentials(*cfg["creds"]), host=cfg["host"],
                       port=cfg["port"], certs=cfg["certs"], iam=iam,
                       reuse_port=True, worker_plane=plane,
                       worker_id=idx, scanner=scanner,
                       replication=replication, tier_mgr=tier_mgr).start()
        stop = _stop_event()
        # A bucket config or server config this worker stores reaches
        # the others' caches, notification rules and replication wiring
        # at their next look at the generation.
        cfg_seen = plane.state.config_gen()
        plane.state.config_applied(idx, cfg_seen)
        srv.handlers.meta.on_change = (
            lambda _b, _k: plane.state.note_config_write(idx))
        srv.handlers.config_sys.on_write = (
            lambda: plane.state.note_config_write(idx))

        def _beat():
            while True:
                st = remote.stats()
                plane.state.worker_beat(idx, inflight=srv._inflight,
                                        counters={
                    "ipc_fallbacks": st["remote_fallbacks"],
                    "co_fallbacks": coalesce.stats()["co_fallbacks"],
                    "remote_submits": st["remote_submits"],
                    "cuda": torch.cuda.is_initialized(),
                    **{f"notify_{k}": v
                       for k, v in notify_counters(srv.notify).items()},
                    **_kernel_counters()})
                time.sleep(0.1)
        threading.Thread(target=_beat, name="mtpu-worker-beat",
                         daemon=True).start()

        plane.state.set_ready(idx)
        if idx == 0:
            print(f"minio_tpu_torch worker pool serving on {srv.endpoint} "
                  f"({plane.nworkers} workers, SO_REUSEPORT; sets on "
                  f"{pools.pools[0].sets[0].device})", flush=True)
            print(f"minio_tpu_torch: not started: {LEFT_OUT}", flush=True)
        print(f"{config_line(srv)} [worker {idx}]", flush=True)
        next_fold = time.monotonic() + 2.0
        while not stop.wait(0.25):
            cgen = plane.state.config_gen()
            if cgen != cfg_seen:
                cfg_seen = cgen
                try:
                    srv.reload_bucket_configs()
                except Exception as e:  # noqa: BLE001 — keep serving
                    print(f"minio_tpu_torch: worker {idx}: bucket "
                          f"configs: {e}", file=sys.stderr, flush=True)
                plane.state.config_applied(idx, cgen)
            gen = plane.state.topology_gen()
            due = time.monotonic() >= next_fold
            if gen == topo_seen and not due:
                continue
            try:
                if gen != topo_seen:
                    # Another worker changed the pools or a drain.
                    topo_seen = gen
                    topo.adopt_topology(pools)
                    plane.state.topology_applied(idx, gen)
                elif pools.draining:
                    # A drain relocates uploads as it goes; a part PUT
                    # of the old id can land on any worker.
                    topo.refresh_relocations(pools)
                if idx == 0:
                    for line in decom.reconcile(pools):
                        print(f"minio_tpu_torch: worker 0: decommission "
                              f"{line}", flush=True)
            except Exception as e:  # noqa: BLE001 — keep serving
                print(f"minio_tpu_torch: worker {idx}: topology: {e}",
                      file=sys.stderr, flush=True)
            if due:
                next_fold = time.monotonic() + 2.0
        plane.state.set_draining(idx)
        srv.drain()
        srv.shutdown()
        st = remote.stats()
        print(f"minio_tpu_torch: worker {idx}: {st['remote_submits']} "
              f"items sent to the device owner, {st['remote_fallbacks']} "
              f"computed here (owner down or arena full), "
              f"{coalesce.stats()['co_fallbacks']} recomputed after a "
              f"failed handle", flush=True)
    finally:
        if scanner is not None:
            scanner.stop()
        if replication is not None:
            replication.stop()
        for q in mrf_queues:
            q.stop()
        coalesce.detach_remote()
        for d in wrapped:
            d.close()
        pools.close()
    return 0


# -- supervisor ---------------------------------------------------------------

def _reserve_port(host: str, port: int) -> tuple[socket.socket, int]:
    """Bind a REUSEPORT placeholder so `--port 0` resolves to one
    ephemeral port every worker can share; kept open (never listening)
    for the pool's lifetime so nobody else takes the port between worker
    respawns."""
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    try:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
    except (AttributeError, OSError):
        s.close()
        raise RuntimeError(
            "MTPU_WORKERS>0 requires SO_REUSEPORT support") from None
    s.bind((host, port))
    return s, s.getsockname()[1]


def _fork(fn, *a) -> int:
    pid = os.fork()
    if pid == 0:
        _child_entry(fn, *a)        # never returns
    return pid


def _boot_wait(children: dict, ready, what: str, stopping: dict,
               deadline: float) -> int | None:
    """Wait for `what` to report ready.  None when it did; if any child
    dies first, or on a signal or the deadline, the pool is torn down
    and the exit code is returned."""
    while not ready():
        got, st = os.waitpid(-1, os.WNOHANG)
        rc = None
        if got:
            rc = os.waitstatus_to_exitcode(st)
            role, idx = children.pop(got, ("?", -1))
            who = "device owner" if role == "owner" else f"worker {idx}"
            print(f"minio_tpu_torch: {who} died during boot (rc={rc})",
                  file=sys.stderr, flush=True)
            rc = rc if rc > 0 else 1
        elif stopping["flag"] or time.monotonic() > deadline:
            print(f"minio_tpu_torch: boot stopped waiting for {what}",
                  file=sys.stderr, flush=True)
            rc = 1
        if rc is not None:
            _killall(children, signal.SIGKILL)
            for pid in list(children):
                _reap(pid)
            return rc
        time.sleep(0.05)
    return None


def run_pool(nworkers: int, pool_paths: list[list[str]],
             creds: tuple[str, str], host: str, port: int,
             set_drive_count: int | None, certs: tuple[str, str] | None,
             device=None) -> int:
    """Supervise the pool until signalled.  `creds` is the root (access
    key, secret key) pair and `device` the boot's device spec (None: the
    card; "cpu" for tests).  The supervisor stays light: all heavy state
    is built in the forked children, after the shared plane exists."""
    import faulthandler
    faulthandler.register(signal.SIGUSR2, all_threads=True)
    plane = WorkerPlane(nworkers)
    reserve, port = _reserve_port(host, port)
    cfg = {"pool_paths": pool_paths, "creds": tuple(creds), "host": host,
           "port": port, "set_drive_count": set_drive_count,
           "certs": certs, "device": device}

    stopping = {"flag": False, "force": False}

    def _sig(signum, frame):
        if stopping["flag"]:
            stopping["force"] = True
            return
        stopping["flag"] = True
    signal.signal(signal.SIGTERM, _sig)
    signal.signal(signal.SIGINT, _sig)

    children: dict[int, tuple[str, int]] = {}   # pid -> (role, idx)
    deadline = time.monotonic() + BOOT_TIMEOUT_S

    plane.state.bump_owner_gen()
    owner = _fork(_owner_main, plane, device)
    children[owner] = ("owner", -1)
    rc = _boot_wait(children, lambda: plane.state.owner_pid() == owner,
                    "the device owner", stopping, deadline)
    if rc is not None:
        return rc
    # Worker 0 opens the drives first: it creates or adopts format.json,
    # runs the recovery sweep and MRF adoption, writes the others must
    # observe; they wait for it after their imports.
    w0 = _fork(_worker_main, plane, 0, cfg)
    children[w0] = ("worker", 0)
    for i in range(1, nworkers):
        children[_fork(_worker_main, plane, i, cfg, True)] = ("worker", i)
    rc = _boot_wait(children, lambda: plane.state.is_ready(0),
                    "worker 0", stopping, deadline)
    if rc is not None:
        return rc

    termed = 0.0
    owner_termed = False
    rc_final = 0
    stale_killed = 0
    while children:
        if stopping["force"]:
            _killall(children, signal.SIGKILL)
            for pid in list(children):
                _reap(pid)
            return 130
        if stopping["flag"] and time.monotonic() - termed > 1.0:
            # Drain fan-out: workers first; the owner keeps the dispatch
            # plane alive while their inflight requests finish.  Re-sent
            # every second: a child mid-boot parks an early TERM in its
            # provisional handler.
            termed = time.monotonic()
            for pid, (role, _) in children.items():
                if role == "worker":
                    _kill(pid, signal.SIGTERM)
        if termed and not owner_termed and not any(
                role == "worker" for role, _ in children.values()):
            owner_termed = True
            for pid, (role, _) in children.items():
                if role == "owner":
                    _kill(pid, signal.SIGTERM)
        if not stopping["flag"]:
            pid = plane.state.owner_pid()
            if pid and pid != stale_killed and not plane.owner_ok():
                # Registered but silent: a wedged owner must not come
                # back and answer slots its workers have given up.
                stale_killed = pid
                print(f"minio_tpu_torch: device owner {pid} stopped "
                      f"beating; killing it", file=sys.stderr, flush=True)
                _kill(pid, signal.SIGKILL)
        try:
            pid, st = os.waitpid(-1, os.WNOHANG)
        except ChildProcessError:
            break
        if pid == 0:
            time.sleep(0.1)
            continue
        role, idx = children.pop(pid, ("?", -1))
        rc = os.waitstatus_to_exitcode(st)
        if role == "worker":
            # The dead worker's admission slots (requests it held or
            # queued) go back now, before any respawn serves.
            held, waiting = plane.qos.clear_row(idx)
            if held or waiting:
                print(f"minio_tpu_torch: worker {idx} died holding "
                      f"{held} admission slots ({waiting} waiting); "
                      f"returned to the pool", file=sys.stderr, flush=True)
        if role == "owner":
            served = plane.state.owner_pid() == pid
            plane.state.owner_down()
            if not served and not stopping["flag"]:
                # A respawned owner that never registered failed its
                # self-tests (or its boot): the pool ends, as at boot,
                # rather than respawn it without end.
                print(f"minio_tpu_torch: device owner of generation "
                      f"{plane.owner_gen()} died before it served "
                      f"(rc={rc}); ending the pool", file=sys.stderr,
                      flush=True)
                stopping["flag"] = True
                rc_final = rc if rc > 0 else 1
                continue
        if stopping["flag"]:
            if role == "worker" and rc not in (0, 143):
                rc_final = rc_final or (rc if rc > 0 else 1)
            continue
        delay = _respawn_delay_s()
        if delay:
            time.sleep(delay)
        if role == "owner":
            gen = plane.state.bump_owner_gen()
            print(f"minio_tpu_torch: device owner died (rc={rc}); "
                  f"respawning as generation {gen}", file=sys.stderr,
                  flush=True)
            children[_fork(_owner_main, plane, device)] = ("owner", -1)
        elif role == "worker":
            n = plane.state.bump_respawn(idx)
            print(f"minio_tpu_torch: worker {idx} died (rc={rc}); "
                  f"respawn #{n}", file=sys.stderr, flush=True)
            children[_fork(_worker_main, plane, idx, cfg)] = \
                ("worker", idx)
    try:
        reserve.close()
    except OSError:
        pass
    return rc_final


def _kill(pid: int, sig: int) -> None:
    try:
        os.kill(pid, sig)
    except (ProcessLookupError, PermissionError):
        pass


def _killall(children: dict, sig: int) -> None:
    for pid in children:
        _kill(pid, sig)


def _reap(pid: int) -> None:
    try:
        os.waitpid(pid, 0)
    except (ChildProcessError, InterruptedError):
        pass


__all__ = ["SharedState", "WorkerPlane", "nworkers_env", "run_pool"]
