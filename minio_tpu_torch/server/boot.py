"""Boot steps shared by the standalone server (server/__main__.py) and the
pre-fork pool's processes (server/workers.py).

Both functions import the engine inside their bodies: the pool's
supervisor imports this module's callers before it forks, and must not
load torch.
"""

from __future__ import annotations

import time


def self_tests(device) -> str:
    """Run the startup self-tests (ops/selftest.py) on `device` (None:
    every card) and return the line the boot prints: their ms with the
    items and launches they took.  A failing test raises SelfTestError,
    and the boot refuses to serve."""
    from ..ops import erasure_cuda, fused, mxhash_torch
    from ..ops.selftest import run_startup_self_tests

    items0 = dict(fused.ITEMS)
    launches0 = (erasure_cuda.LAUNCHES, mxhash_torch.LAUNCHES)
    t0 = time.perf_counter()
    run_startup_self_tests(device)
    items = {k: v - items0[k] for k, v in fused.ITEMS.items()}
    return (f"minio_tpu_torch: self-tests passed in "
            f"{(time.perf_counter() - t0) * 1e3:.3f} ms (items "
            f"gf_matmul={items['gf_matmul']} mxh256={items['mxh256']}; "
            f"launches gf_matmul={erasure_cuda.LAUNCHES - launches0[0]} "
            f"mxh256={mxhash_torch.LAUNCHES - launches0[1]})")


def object_layer(pool_paths: list[list[str]], set_drive_count, device,
                 sweep: bool = True, retire_pid: int = 0):
    """The object layer over local drives: the recovery sweep of every
    drive (when `sweep`), the removal of process `retire_pid`'s metadata
    journal segments (a respawned pool worker's dead predecessor), the
    health wrap, one ErasureSets per pool and the ServerPools over them.
    Returns (pools, wrapped drives, the sweep's counts with the segments
    retired); on a failure everything built so far is closed."""
    from ..engine.pools import ServerPools
    from ..engine.sets import ErasureSets
    from ..storage.drive import LocalDrive
    from ..storage.health_wrap import wrap_drives
    from ..storage.recovery import boot_recovery_sweep

    pool_sets: list = []
    wrapped: list = []
    swept = {"drives": 0, "tmp_entries": 0, "mp_stage": 0,
             "meta_journal": 0, "retired_segments": 0}
    try:
        for paths in pool_paths:
            local = [LocalDrive(p) for p in paths]
            if retire_pid:
                swept["retired_segments"] += sum(
                    d.retire_meta_segments(retire_pid) for d in local)
            if sweep:
                # The previous epoch's staging, trash and multipart stage
                # files, before the engine takes traffic
                # (cmd/prepare-storage.go role).
                rec = boot_recovery_sweep(local)
                for key in rec:
                    swept[key] += rec[key]
            drives = wrap_drives(local)
            wrapped.extend(drives)
            pool_sets.append(ErasureSets(
                drives, set_drive_count=set_drive_count or len(drives),
                deployment_id=(pool_sets[0].deployment_id
                               if pool_sets else None),
                device=device))
        pools = ServerPools(pool_sets)
    except BaseException:
        for p in pool_sets:
            p.close()
        for d in wrapped:
            d.close()
        raise
    return pools, wrapped, swept


def sweep_line(swept: dict) -> str:
    return (f"minio_tpu_torch: recovery sweep: {swept['tmp_entries']} stale "
            f"tmp entries, {swept['mp_stage']} orphaned multipart staging "
            f"files across {swept['drives']} drives; "
            f"{swept['meta_journal']} xl.meta entries replayed from the "
            f"metadata journal")
