"""Standalone boot: `python -m minio_tpu_torch.server --drives /data{1...12}`.

The single-node part of minio_tpu/server/__main__.py (the serverMain
role, cmd/server-main.go:441), in its order:

1. the startup self-tests (ops/selftest.py) on every card, before
   anything binds: a failing one refuses to serve;
2. the recovery sweep of every local drive (storage/recovery.py):
   staging, trash and multipart `stage-*` files a dead process left;
3. the drive health wrap (storage/health_wrap.wrap_drives): per-API
   stats and the circuit breaker;
4. the object layer (pools -> sets -> drives) on the CUDA card, and an
   MRF heal queue per pool journaled to its first drive
   (background/mrf.attach_mrf);
5. the hot-object tier (engine/hotcache.attach_pools, MTPU_HOTCACHE,
   default on): one private segment here, one segment built before the
   fork and shared by every worker in the pool;
6. the pool topology: the pools pool-topology.json names beyond the
   --drives flags are attached, its draining pools adopted
   (server/topology.py), and the drains the journals left active are
   resumed (background/decom.resume_decommissions);
7. the data scanner (background/scanner.py; MTPU_SCANNER=0 starts none,
   MTPU_SCANNER_INTERVAL, MTPU_SCANNER_DEEP_EVERY), which applies the
   buckets' lifecycle;
8. the replication pool (bucket/replication.py): its journal replayed
   and, in one process or worker 0, the orphaned journals adopted; the
   buckets' persisted replication configs are wired to it once the
   front door binds the object layer;
9. the tier plane (bucket/tier.py): the persisted tiers reload and the
   tier journal replays before traffic, so a kill -9 mid-transition
   resolves to the whole hot version or a valid stub and tier object
   here (a line says what the replay did when it did anything);
10. IAM, loaded from the object layer, and the S3 front door with its
   notification system: the targets of the configuration's enabled
   `notify_*` subsystems (parking under MTPU_NOTIFY_STORE_DIR while
   their service is down) and every bucket's persisted rules.

With MTPU_WORKERS=N (server/workers.py) the boot forks instead: one
device owner, which runs the self-tests and then every kernel of the
pool, and N HTTP workers on one port (SO_REUSEPORT), each booting steps
2-10 (the sweep, the resumed drains and the scanner in worker 0 only;
each worker its own replication pool and journal, and its own
notification queue stores; one tier journal and tier registry for all)
with its coalescer routed to the owner through shared memory.  The
branch is taken before anything loads torch.

It serves until SIGTERM or SIGINT, then drains, stops the scanner, the
replication pool, the MRF queues and the breakers' probers, and exits
0.  A second signal
forces the exit.  Root credentials come from MTPU_ROOT_USER /
MTPU_ROOT_PASSWORD (the reference's MINIO_ROOT_USER convention), defaulting to
minioadmin/minioadmin; the other identities are IAM's, managed through
the admin API and kept in the object layer.

Each --drives flag is one pool; within a flag, each space-separated
ellipsis group is one pool too (`--drives '/a{1...4} /b{1...4}'`),
plain paths without ellipses make one pool together.  The sets run on
the card (`--device cpu` runs them, and the self-tests, on the host, for
tests); without CUDA and without that flag the boot raises.

URL endpoints (`--drives 'http://127.0.0.1:9001/d{1...4}
http://127.0.0.1:9002/d{1...4}'`, every node given the same list and its
own --port) boot one node of a cluster (server/cluster.py): the
self-tests on this node's card, the front door with the RPC planes,
the format wait (MTPU_BOOT_TIMEOUT seconds, default 120), the peers'
verify, then the object layer over local and remote drives with a dsync
namespace lock, and the node's scanner.  MTPU_WORKERS is ignored there
(one process per node), https endpoints need --certs-dir and
--certs-dir needs https endpoints,
and no hot tier is attached.  A service restart (admin) boots the node
again; SIGTERM drains and exits 0.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import threading

#: What the JAX package's boot starts and this one does not, with the
#: ROADMAP.md Queue A item each waits for.
LEFT_OUT = "bucket DNS (item 9c)"


def expand_ellipses(pattern: str) -> list[str]:
    """Expand `/tmp/d{1...4}` patterns
    (cf. cmd/endpoint-ellipses.go:341)."""
    from ..topology.endpoints import expand_one, has_ellipses
    if has_ellipses(pattern):
        return expand_one(pattern)
    return pattern.split()


def parse_pool_paths(drive_groups: list[list[str]]) -> list[list[str]] | None:
    """Expand --drives groups into per-pool path lists; None on a
    mixed ellipsis/plain group (the caller exits 2)."""
    from ..topology.endpoints import has_ellipses
    pool_paths: list[list[str]] = []
    for group in drive_groups:
        if len(group) > 1 and any(has_ellipses(a) for a in group):
            if not all(has_ellipses(a) for a in group):
                print("--drives: cannot mix ellipsis pool patterns "
                      f"with plain paths in one group: {group}",
                      file=sys.stderr)
                return None
            pool_paths.extend(expand_ellipses(a) for a in group)
        else:
            pool_paths.append(
                [p for a in group for p in expand_ellipses(a)])
    return pool_paths


def install_signal_handlers(stop: threading.Event) -> None:
    """SIGTERM and SIGINT both start a graceful drain (cmd/signals.go
    treats them alike); a SECOND signal forces the exit."""
    def _sig(signum, frame):
        if stop.is_set():
            try:
                os.write(2, b"minio_tpu_torch: second signal, forcing "
                            b"exit\n")
            except OSError:
                pass
            os._exit(130 if signum == signal.SIGINT else 143)
        stop.set()
    signal.signal(signal.SIGTERM, _sig)
    signal.signal(signal.SIGINT, _sig)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="minio_tpu_torch.server")
    ap.add_argument("--drives", required=True, action="append",
                    help="drive paths, ellipses ok: /tmp/d{1...4}; "
                         "repeat the flag to add a pool")
    ap.add_argument("--port", type=int, default=9000)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--set-drive-count", type=int, default=None)
    ap.add_argument("--certs-dir",
                    default=os.environ.get("MTPU_CERTS_DIR", ""),
                    help="dir with public.crt/private.key -> serve HTTPS")
    ap.add_argument("--device", choices=("cpu",), default=None,
                    help="run the sets on the host (tests); by default "
                         "they run on the CUDA card")
    args = ap.parse_args(argv)

    certs = None
    if args.certs_dir:
        cert = os.path.join(args.certs_dir, "public.crt")
        key = os.path.join(args.certs_dir, "private.key")
        if not (os.path.exists(cert) and os.path.exists(key)):
            print(f"--certs-dir: missing {cert} or {key}",
                  file=sys.stderr)
            return 2
        certs = (cert, key)
    drive_groups = [g.split() for g in args.drives]
    endpoint_args = [a for g in drive_groups for a in g]
    creds = (os.environ.get("MTPU_ROOT_USER", "minioadmin"),
             os.environ.get("MTPU_ROOT_PASSWORD", "minioadmin"))
    from .workers import nworkers_env
    nworkers = nworkers_env()
    if any("://" in a for a in endpoint_args):
        if nworkers:
            print("minio_tpu_torch: MTPU_WORKERS ignored in cluster mode "
                  "(one process per node)", file=sys.stderr, flush=True)
        return cluster_main(args, drive_groups, endpoint_args, creds, certs)
    pool_paths = parse_pool_paths(drive_groups)
    if pool_paths is None:
        return 2
    # The pre-fork worker pool (server/workers.py): MTPU_WORKERS=N forks
    # one device owner and N SO_REUSEPORT HTTP workers.  The branch sits
    # before any import that loads torch: CUDA must never be initialised
    # in a process that forks, so the supervisor stays light and each
    # child builds its own stack.
    if nworkers:
        from .workers import run_pool
        return run_pool(nworkers, pool_paths, creds, args.host, args.port,
                        args.set_drive_count, certs, args.device)

    from ..background.mrf import attach_mrf
    from ..background.scanner import scanner_from_env
    from ..bucket.replication import ReplicationPool
    from ..iam.iam import IAMSys
    from . import boot
    from .server import S3Server
    from .sigv4 import Credentials

    # Startup self-tests before anything binds (hard-fail, as
    # cmd/erasure-coding.go:158 and cmd/bitrot.go:214 do).
    print(boot.self_tests(args.device), flush=True)

    pools, wrapped, swept = boot.object_layer(
        pool_paths, args.set_drive_count, args.device)
    pool_sets = pools.pools
    print(boot.sweep_line(swept), flush=True)
    stop = threading.Event()
    install_signal_handlers(stop)
    mrf_queues: list = []
    scanner = replication = None
    try:
        # MRF heal queues: a write that missed a breaker-offline drive
        # heals back to full width once the drive answers again.
        mrf_queues = attach_mrf(pools)
        replayed = sum(q.replayed for q in mrf_queues)
        if replayed:
            print(f"minio_tpu_torch: MRF journal: replayed {replayed} "
                  "pending heals", flush=True)
        # The RAM hot-object tier: one private segment in one process
        # (the pool builds its segment before the fork instead).
        from ..engine.hotcache import attach_pools as attach_hotcache
        if attach_hotcache(pools) is not None:
            print("minio_tpu_torch: hot-object cache: "
                  f"{pools.hot_tier.stats()['segment_bytes'] >> 20} MiB "
                  "segment attached", flush=True)
        print(adopt_pools(pools), flush=True)
        scanner = scanner_from_env(pools)
        replication = ReplicationPool(pools)
        print(replication_line(replication), flush=True)
        tier_mgr, line = tier_manager(pools)
        if line:
            print(line, flush=True)
        iam = IAMSys(pools)
        srv = S3Server(pools, Credentials(*creds), host=args.host,
                       port=args.port, certs=certs, iam=iam,
                       scanner=scanner, replication=replication,
                       tier_mgr=tier_mgr).start()
        desc = ", ".join(f"pool{i}: {len(p)} drives "
                         f"set={pool_sets[i].set_drive_count}"
                         for i, p in enumerate(pool_paths))
        device = pool_sets[0].sets[0].device
        print(f"minio_tpu_torch server on {srv.endpoint} ({desc}; sets on "
              f"{device})", flush=True)
        print(f"minio_tpu_torch: not started: {LEFT_OUT}", flush=True)
        print(config_line(srv), flush=True)
        while not stop.wait(timeout=1.0):
            pass
        # Graceful exit: 503 to new requests, finish inflight ones, then
        # drop the listener; the MRF queues checkpoint their journals.
        srv.drain()
        srv.shutdown()
    finally:
        if scanner is not None:
            scanner.stop()
        if replication is not None:
            replication.stop()
        for q in mrf_queues:
            q.stop()
        for d in wrapped:
            d.close()
        pools.close()
    return 0


def config_line(srv) -> str:
    """The line the boot prints for its configuration: the KMS, whether
    PUTs compress, and the notification targets it built."""
    h = srv.handlers
    targets = ", ".join(sorted(srv.notify.targets)) or "none"
    kms = f"{type(h.kms).__name__} ({h.kms.key_id})" if h.kms is not None \
        else "none (SSE-S3 refused; set MTPU_KMS_SECRET_KEY)"
    return (f"minio_tpu_torch: kms: {kms}; compression: "
            f"{'on' if h._compressing() else 'off'}; notification targets: "
            f"{targets}")


def tier_manager(pools):
    """Step 9 of the boot: the tier manager (persisted tiers reloaded,
    the journal replayed) and the line the boot prints for it, or ""
    when the replay had nothing to do."""
    from ..bucket.tier import TierManager
    tm = TierManager(pools)
    line = ""
    if tm.counters.get("replayed"):
        line = (f"minio_tpu_torch: tier journal: replayed "
                f"{tm.counters['replayed']} record(s) "
                f"({tm.counters['orphans_reaped']} orphan(s) reaped), "
                f"{tm.journal.pending()} pending")
    return tm, line


def replication_line(rp) -> str:
    """The line the boot prints for its replication pool."""
    return (f"minio_tpu_torch: replication journal {rp._jpath}: "
            f"replayed {rp.replayed} pending task(s), adopted "
            f"{rp.adopted} orphaned journal(s)")


def adopt_pools(pools) -> str:
    """Step 6 of the boot (the recovery owner's): fold pool-topology.json
    in and resume the drains its journals left active; returns the line
    the boot prints."""
    from ..background.decom import resume_decommissions
    from .topology import adopt_topology
    added = adopt_topology(pools)
    drains = [f"pool {d.pool_idx} {d.state}"
              for d in resume_decommissions(pools)]
    return (f"minio_tpu_torch: topology: {len(pools.pools)} pools "
            f"({added} from pool-topology.json), draining "
            f"{sorted(pools.draining)}; decommissions: "
            f"{', '.join(drains) or 'none'}")


def cluster_main(args, drive_groups: list[list[str]],
                 endpoint_args: list[str], creds: tuple[str, str],
                 certs) -> int:
    """One node of a cluster (cf. the serverMain distributed path,
    cmd/server-main.go:441): the self-tests on this node's device, then
    boot_cluster_node, then serve until a signal; a service restart
    boots the node again (format adopt and peer verify run again)."""
    if certs is not None and not all(a.startswith("https://")
                                     for a in endpoint_args):
        # TLS without https endpoints would serve the planes over TLS
        # while the peers dial plaintext: fail, never downgrade.
        print("--certs-dir requires https:// cluster endpoints",
              file=sys.stderr)
        return 2
    if certs is None and any(a.startswith("https://")
                             for a in endpoint_args):
        print("https:// endpoints require --certs-dir", file=sys.stderr)
        return 2
    from . import boot
    from .cluster import boot_cluster_node
    from .server import S3Server
    from .sigv4 import Credentials

    print(boot.self_tests(args.device), flush=True)
    root = Credentials(*creds)

    def factory(node):
        srv = S3Server(None, root, host=args.host, port=args.port,
                       certs=certs, rpc_router=node.router).start()
        print(f"minio_tpu_torch cluster node on {srv.endpoint} "
              f"(first={node.is_first}, {len(node.local_drives)} local / "
              f"{len(node.endpoints)} total drives, "
              f"set={node.set_drive_count}): waiting for the cluster",
              flush=True)
        return srv

    stop = threading.Event()
    install_signal_handlers(stop)
    while True:
        try:
            node, srv, pools = boot_cluster_node(
                drive_groups if len(drive_groups) > 1 else endpoint_args,
                args.host, args.port, root,
                set_drive_count=args.set_drive_count,
                server_factory=factory, certs_dir=args.certs_dir,
                timeout=float(os.environ.get("MTPU_BOOT_TIMEOUT", "120")),
                device=args.device)
        except Exception as e:  # noqa: BLE001 — the boot's verdict
            print(f"minio_tpu_torch: cluster boot failed: {e}",
                  file=sys.stderr, flush=True)
            return 1
        device = pools.pools[0].sets[0].device
        print(f"minio_tpu_torch cluster node ready on {srv.endpoint} "
              f"(deployment ok; sets on {device})", flush=True)
        print(boot.sweep_line(node.swept), flush=True)
        print(f"minio_tpu_torch: not started: {LEFT_OUT}", flush=True)
        print(config_line(srv), flush=True)
        while not stop.wait(timeout=1.0):
            if srv.service_event:
                break
        restart = srv.service_event == "restart"
        srv.drain()
        srv.shutdown()
        if srv.scanner is not None:
            srv.scanner.stop()
        if srv.replication is not None:
            srv.replication.stop()
        node.close()
        pools.close()
        if not restart or stop.is_set():
            return 0
        print("minio_tpu_torch: service restart requested", flush=True)


if __name__ == "__main__":
    sys.exit(main())
