"""Copy of minio_tpu/storage/format.py: the port keeps its own, so that it imports
nothing of the JAX package.

Cluster format bootstrap — the format.json equivalent.

Each drive carries ``.mtpu.sys/format.json`` binding it into the topology:
deployment id, its own drive id, and the full sets layout (cf.
formatErasureV3, cmd/format-erasure.go:111). On startup the
topology layer loads formats from all drives, creates them on fresh drives,
and verifies every drive sits where the layout says it should
(cf. waitForFormatErasure, cmd/prepare-storage.go:298).
"""

from __future__ import annotations

import json
import uuid

from .drive import FORMAT_FILE, SYS_VOL, LocalDrive
from .errors import ErrDiskNotFound, ErrFileCorrupt, ErrFileNotFound

FORMAT_VERSION = 1
DIST_ALGO = "SIPMOD+PARITY"  # cf. formatErasureVersionV3DistributionAlgoV3


def new_format(deployment_id: str, sets: list[list[str]], this: str) -> dict:
    return {
        "version": FORMAT_VERSION,
        "format": "xl",
        "id": deployment_id,
        "xl": {
            "version": 3,
            "this": this,
            "sets": sets,
            "distributionAlgo": DIST_ALGO,
        },
    }


def load_format(drive: LocalDrive) -> dict | None:
    """Read a drive's format.json; None if the drive is unformatted."""
    try:
        buf = drive.read_all(SYS_VOL, FORMAT_FILE)
    except ErrFileNotFound:
        return None
    try:
        fmt = json.loads(buf.decode("utf-8"))
    except (ValueError, UnicodeDecodeError) as e:
        raise ErrFileCorrupt(f"format.json: {e}") from e
    if fmt.get("format") != "xl" or "xl" not in fmt:
        raise ErrFileCorrupt("format.json: not an xl format")
    return fmt


def save_format(drive: LocalDrive, fmt: dict) -> None:
    drive.write_all(SYS_VOL, FORMAT_FILE,
                    json.dumps(fmt, indent=1).encode("utf-8"))
    drive.disk_id = fmt["xl"]["this"]


def init_format_sets(drives: list[list[LocalDrive]],
                     deployment_id: str | None = None) -> dict:
    """Format a fresh deployment: drives[s][d] -> set s, position d.

    Returns the reference format (with "this" cleared). Existing formatted
    drives are verified against their recorded position instead.

    Unreachable drives (read error, dead peer) are tolerated when a
    QUORUM of drives carries a consistent format — a restarting node
    must not be blocked by one dead peer (waitForFormatErasure's
    quorum, cmd/prepare-storage.go:298). A FRESH format still requires
    every drive reachable, exactly like the reference's "Waiting for
    all other servers to be online" loop — formatting around an
    unreachable partition could mint two deployments.
    """
    deployment_id = deployment_id or str(uuid.uuid4())
    _UNREACHABLE = object()

    def probe(d):
        if d is None:
            return None
        try:
            return load_format(d)
        except ErrFileCorrupt:
            raise
        except Exception:  # noqa: BLE001  (ErrDiskNotFound, transport)
            return _UNREACHABLE

    existing = [[probe(d) for d in row] for row in drives]
    flat = [f for row in existing for f in row]
    ref = next((f for f in flat if f not in (None, _UNREACHABLE)), None)
    if ref is None:
        if any(f is _UNREACHABLE for f in flat):
            raise ErrDiskNotFound(
                "fresh format needs every drive online "
                f"({sum(1 for f in flat if f is _UNREACHABLE)} "
                "unreachable)")
        sets = [[str(uuid.uuid4()) for _ in row] for row in drives]
        for s, row in enumerate(drives):
            for d, drive in enumerate(row):
                fmt = new_format(deployment_id, sets, sets[s][d])
                save_format(drive, fmt)
        out = new_format(deployment_id, sets, "")
        return out

    # Partially/fully formatted: adopt the reference layout, heal fresh
    # drives into their slots (cf. formatErasureFixLosingDisks). The
    # quorum gate guards against trusting a layout only a MINORITY
    # claims while other drives are unreachable (they might hold the
    # real one). When every drive answered there is nothing hidden:
    # a crashed fresh format (ref on 2 of 8, rest blank) must heal to
    # completion, not wedge behind a majority it can never reach.
    formatted = sum(1 for f in flat if f not in (None, _UNREACHABLE))
    unreachable = sum(1 for f in flat if f is _UNREACHABLE)
    if unreachable and formatted < len(flat) // 2 + 1:
        raise ErrDiskNotFound(
            f"format quorum not reached: {formatted}/{len(flat)} "
            f"drives carry a format ({unreachable} unreachable)")
    sets = ref["xl"]["sets"]
    deployment_id = ref["id"]
    for s, row in enumerate(drives):
        for d, drive in enumerate(row):
            if drive is None:
                continue
            fmt = existing[s][d]
            if fmt is _UNREACHABLE:
                continue           # dead peer: heal when it returns
            if fmt is None:
                # Unformatted drive in a formatted cluster: heal
                # format (best effort — it may have just gone down).
                try:
                    save_format(drive,
                                new_format(deployment_id, sets,
                                           sets[s][d]))
                except Exception:  # noqa: BLE001
                    pass
                continue
            if fmt["id"] != deployment_id:
                raise ErrFileCorrupt(
                    f"drive {drive.root}: deployment id mismatch")
            this = fmt["xl"]["this"]
            if this != sets[s][d]:
                raise ErrFileCorrupt(
                    f"drive {drive.root}: drive id {this} not at expected "
                    f"position set={s} disk={d}")
            drive.disk_id = this
    return new_format(deployment_id, sets, "")


def quorum_formatted(formats: list[dict | None]) -> bool:
    ok = sum(1 for f in formats if f)
    return ok >= len(formats) // 2 + 1
