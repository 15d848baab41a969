"""The pool topology: persisted, and carried to every process of a pool.

Counterpart of minio_tpu/server/topology.py.  A pool added at run time
(admin pool/add) and a drain's state must reach every process that holds
a ServerPools: each pre-fork worker (server/workers.py) builds its own
object layer, and a worker respawned later must come back with the pools
of now, not those of the boot's --drives.

The worker that served the change writes `pool-topology.json` (the JAX
package's format: each pool's drive paths and set size, and the
draining pools) to the first pool's first local drive (tmp, fsync,
replace) and bumps the pool's topology generation; every worker polls
the generation in its idle loop and folds the file in (`adopt_topology`):
it attaches the pools it lacks, adopts the draining set, and reloads the
multipart relocation maps from the drain journals.  A one-process boot
reads the same file, so a restart with stale flags keeps every pool that
was added.

`build_pool` builds a pool as the boot does (recovery sweep, health
wrap, format) on the device the deployment's sets run on.
"""

from __future__ import annotations

import json
import os

from ..storage.drive import SYS_VOL

TOPOLOGY_FILE = "pool-topology.json"


def _first_root(pool) -> str | None:
    for es in pool.sets:
        for d in es.drives:
            root = getattr(d, "root", None)
            if d is not None and root:
                return root
    return None


def topology_path_from_root(root: str) -> str:
    return os.path.join(root, SYS_VOL, TOPOLOGY_FILE)


def topology_path(pools) -> str | None:
    root = _first_root(pools.pools[0])
    return topology_path_from_root(root) if root else None


def pool_paths_of(pool) -> list[str]:
    return [d.root for es in pool.sets for d in es.drives
            if d is not None and getattr(d, "root", None)]


def save_topology(pools) -> None:
    """Persist the pool list and the draining set.  Best effort: a failed
    write leaves the next restart with the boot's flags."""
    path = topology_path(pools)
    if not path:
        return
    doc = {
        "pools": [{"paths": pool_paths_of(p),
                   "set_drive_count": p.set_drive_count}
                  for p in pools.pools],
        "draining": sorted(pools.draining),
    }
    tmp = path + ".tmp"
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(doc, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except OSError:
        pass


def load_topology_from_root(root: str) -> dict | None:
    try:
        with open(topology_path_from_root(root), "r",
                  encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(doc, dict) or not doc.get("pools"):
        return None
    return doc


def device_spec(pools):
    """The device spec the deployment's sets were built with: None (the
    card, each set on its own) or "cpu"."""
    return "cpu" if pools.pools[0].sets[0].device.type == "cpu" else None


def build_pool(paths: list[str], set_drive_count: int | None,
               deployment_id: str | None, device=None, *,
               sweep: bool = False):
    """One pool's stack as the boot builds it: the recovery sweep (only
    where one process may sweep), the health wrap, the format.  On a
    failure the wrapped drives are closed."""
    from ..engine.sets import ErasureSets
    from ..storage.drive import LocalDrive
    from ..storage.health_wrap import wrap_drives
    local = [LocalDrive(p) for p in paths]
    if sweep:
        from ..storage.recovery import boot_recovery_sweep
        boot_recovery_sweep(local)
    drives = wrap_drives(local)
    try:
        return ErasureSets(drives,
                           set_drive_count=set_drive_count or len(local),
                           deployment_id=deployment_id, device=device)
    except BaseException:
        for d in drives:
            d.close()
        raise


def refresh_relocations(pools) -> None:
    """Reload the multipart relocation maps from the drain journals: a
    part PUT on a worker that runs no mover must still resolve the
    client's old upload id."""
    from ..background import decom
    for path in decom.find_journals(pools).values():
        pools.upload_relocations.update(decom.replay_journal(path)["mp"])


def attach_built_pool(pools, spec: dict, *, sweep: bool = False,
                      check=None) -> int:
    """Build the pool `spec` names (a pool-topology.json entry), run
    `check(es)` on it (the admin's self-test), attach it and give it an
    MRF queue, which ServerPools.close() stops; returns its index."""
    from ..background.mrf import attach_mrf
    es = build_pool(spec["paths"], spec.get("set_drive_count"),
                    pools.deployment_id, device_spec(pools), sweep=sweep)
    try:
        if check is not None:
            check(es)
        idx = pools.add_pool(es)
    except BaseException:
        es.close()
        for s in es.sets:
            for d in s.drives:
                d.close()
        raise
    pools.mrf_queues.extend(attach_mrf(es))
    return idx


def adopt_topology(pools) -> int:
    """Fold the persisted topology into a live ServerPools: attach the
    pools beyond its list, adopt the draining set, reload the relocation
    maps.  Returns how many pools it attached."""
    root = _first_root(pools.pools[0])
    if not root:
        return 0
    doc = load_topology_from_root(root)
    if doc is None:
        return 0
    added = 0
    for spec in doc["pools"][len(pools.pools):]:
        attach_built_pool(pools, spec)
        added += 1
    from ..background import decom
    draining = {int(i) for i in doc.get("draining", [])
                if 0 <= int(i) < len(pools.pools)}
    # The file is the floor across processes; a mover here may be ahead
    # of it, and is never un-drained by it.  The file is written best
    # effort, the drain journals durably: a drain a journal holds active
    # keeps its pool out of placement whatever the file says (a worker
    # whose save failed must not un-drain itself at its next look).
    draining |= decom.active_drains(pools)
    pools.draining |= draining
    for idx in list(pools.draining - draining):
        d = pools.decommissions.get(idx)
        if d is None or getattr(d, "state", "") == "cancelled":
            pools.draining.discard(idx)
    refresh_relocations(pools)
    return added
