"""Boot-time recovery sweep orchestration.

Counterpart of minio_tpu/storage/recovery.py, the
formatErasureCleanupTmpLocalEndpoints role (cmd/prepare-storage.go):
before a freshly booted server takes traffic, every *local* drive sweeps
the debris a dead process left behind: staged tmp writes that never
published, trash renames that never finished, orphaned multipart
``stage-*`` files; first, the xl.meta blobs of metadata journal
segments a kill left (replayed in commit order, never over a newer
xl.meta).  The per-drive mechanics live in
`LocalDrive.sweep_stale`; this module fans the sweep across a drive
list (health wrappers pass the call through; anything without a sweep
is skipped) and counts it in `stats()` (the JAX package records the
same counts into DATA_PATH).

This is an explicit boot step, NOT a LocalDrive.__init__ side effect:
tests and tools construct drives over live trees all the time, and a
constructor that deleted tmp state would race the engine that owns it.
"""

from __future__ import annotations

import threading

_STATS_MU = threading.Lock()
_STATS = {"sweeps": 0, "tmp_entries": 0, "mp_stage": 0, "meta_journal": 0}


def stats() -> dict:
    """Drives swept and what they held, over the process."""
    with _STATS_MU:
        return dict(_STATS)


def boot_recovery_sweep(drives) -> dict:
    """Sweep every local drive in `drives`; returns aggregate counts.

    Accepts raw LocalDrives or health-wrapped ones (attribute
    passthrough reaches sweep_stale); anything without a sweep (None
    gaps) is skipped, and a drive whose sweep fails does not block the
    boot.
    """
    totals = {"drives": 0, "tmp_entries": 0, "mp_stage": 0,
              "meta_journal": 0}
    for d in drives:
        sweep = getattr(d, "sweep_stale", None)
        if sweep is None:
            continue
        try:
            counts = sweep()
        except OSError:
            continue            # a dead drive must not block boot
        totals["drives"] += 1
        for key in ("tmp_entries", "mp_stage", "meta_journal"):
            totals[key] += counts.get(key, 0)
        with _STATS_MU:
            _STATS["sweeps"] += 1
            _STATS["tmp_entries"] += counts.get("tmp_entries", 0)
            _STATS["mp_stage"] += counts.get("mp_stage", 0)
            _STATS["meta_journal"] += counts.get("meta_journal", 0)
    return totals
