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
5. IAM, loaded from the object layer, and the S3 front door.

It serves until SIGTERM or SIGINT, then drains, stops the MRF queues
and the breakers' probers, and exits 0.  A second signal forces the
exit.  Root credentials come from MTPU_ROOT_USER / MTPU_ROOT_PASSWORD
(the reference's MINIO_ROOT_USER convention), defaulting to
minioadmin/minioadmin; the other identities are IAM's, managed through
the admin API and kept in the object layer.

Each --drives flag is one pool; within a flag, each space-separated
ellipsis group is one pool too (`--drives '/a{1...4} /b{1...4}'`),
plain paths without ellipses make one pool together.  The sets run on
the card (`--device cpu` runs them, and the self-tests, on the host, for
tests); without CUDA and without that flag the boot raises.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import threading
import time

#: What the JAX package's boot starts and this one does not, with the
#: ROADMAP.md Queue A item each waits for.
LEFT_OUT = ("cluster boot, pool topology, decommission and the scanner "
            "(item 9); hot cache and QoS (item 7); the pre-fork worker "
            "pool (item 6); notifications, replication and tiering "
            "(item 10)")


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
    pool_paths = parse_pool_paths([g.split() for g in args.drives])
    if pool_paths is None:
        return 2

    from ..background.mrf import attach_mrf
    from ..engine.pools import ServerPools
    from ..engine.sets import ErasureSets
    from ..iam.iam import IAMSys
    from ..ops import erasure_cuda, fused, mxhash_torch
    from ..ops.selftest import run_startup_self_tests
    from ..storage.drive import LocalDrive
    from ..storage.health_wrap import wrap_drives
    from ..storage.recovery import boot_recovery_sweep
    from .server import S3Server
    from .sigv4 import Credentials

    # Startup self-tests before anything binds (hard-fail, as
    # cmd/erasure-coding.go:158 and cmd/bitrot.go:214 do).
    items0 = dict(fused.ITEMS)
    launches0 = (erasure_cuda.LAUNCHES, mxhash_torch.LAUNCHES)
    t0 = time.perf_counter()
    run_startup_self_tests(args.device)
    items = {k: v - items0[k] for k, v in fused.ITEMS.items()}
    print(f"minio_tpu_torch: self-tests passed in "
          f"{(time.perf_counter() - t0) * 1e3:.3f} ms (items "
          f"gf_matmul={items['gf_matmul']} mxh256={items['mxh256']}; "
          f"launches gf_matmul={erasure_cuda.LAUNCHES - launches0[0]} "
          f"mxh256={mxhash_torch.LAUNCHES - launches0[1]})", flush=True)

    creds = Credentials(os.environ.get("MTPU_ROOT_USER", "minioadmin"),
                        os.environ.get("MTPU_ROOT_PASSWORD", "minioadmin"))
    pool_sets: list[ErasureSets] = []
    wrapped: list = []
    swept = {"drives": 0, "tmp_entries": 0, "mp_stage": 0}
    try:
        for paths in pool_paths:
            local = [LocalDrive(p) for p in paths]
            # The recovery sweep before the engine takes traffic: the
            # previous epoch's staging, trash and multipart stage files
            # (cmd/prepare-storage.go role).
            rec = boot_recovery_sweep(local)
            for key in swept:
                swept[key] += rec[key]
            drives = wrap_drives(local)
            wrapped.extend(drives)
            pool_sets.append(ErasureSets(
                drives, set_drive_count=args.set_drive_count or len(drives),
                deployment_id=(pool_sets[0].deployment_id
                               if pool_sets else None),
                device=args.device))
        pools = ServerPools(pool_sets)
    except BaseException:
        for p in pool_sets:
            p.close()
        for d in wrapped:
            d.close()
        raise
    print(f"minio_tpu_torch: recovery sweep: {swept['tmp_entries']} stale "
          f"tmp entries, {swept['mp_stage']} orphaned multipart staging "
          f"files across {swept['drives']} drives", flush=True)
    stop = threading.Event()
    install_signal_handlers(stop)
    mrf_queues: list = []
    try:
        # MRF heal queues: a write that missed a breaker-offline drive
        # heals back to full width once the drive answers again.
        mrf_queues = attach_mrf(pools)
        replayed = sum(q.replayed for q in mrf_queues)
        if replayed:
            print(f"minio_tpu_torch: MRF journal: replayed {replayed} "
                  "pending heals", flush=True)
        iam = IAMSys(pools)
        srv = S3Server(pools, creds, host=args.host, port=args.port,
                       certs=certs, iam=iam).start()
        desc = ", ".join(f"pool{i}: {len(p)} drives "
                         f"set={pool_sets[i].set_drive_count}"
                         for i, p in enumerate(pool_paths))
        device = pool_sets[0].sets[0].device
        print(f"minio_tpu_torch server on {srv.endpoint} ({desc}; sets on "
              f"{device})", flush=True)
        print(f"minio_tpu_torch: not started: {LEFT_OUT}", flush=True)
        while not stop.wait(timeout=1.0):
            pass
        # Graceful exit: 503 to new requests, finish inflight ones, then
        # drop the listener; the MRF queues checkpoint their journals.
        srv.drain()
        srv.shutdown()
    finally:
        for q in mrf_queues:
            q.stop()
        for d in wrapped:
            d.close()
        pools.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
