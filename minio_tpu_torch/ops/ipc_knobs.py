"""Knobs of the cross-process dispatch plane (ops/ipc_dispatch.py), read
per call from the environment.

They live apart from ipc_dispatch because the pool's supervisor
(server/workers.py) reads them too and must stay light: this module
imports neither torch nor ops/coalesce.py, so nothing the supervisor
loads before it forks touches CUDA.
"""

from __future__ import annotations

import os


def mode() -> str:
    """MTPU_IPC_DISPATCH: `auto` (default) routes the device kinds to the
    owner when the submitting set is on a CUDA card, `all` routes every
    registered kind whatever the device (the CPU tests), `0` never."""
    v = os.environ.get("MTPU_IPC_DISPATCH", "auto").strip().lower()
    return v if v in ("auto", "all", "0") else "auto"


def alloc_timeout_s() -> float:
    """MTPU_IPC_ALLOC_TIMEOUT_S: how long a worker waits for arena space
    before it computes the item itself (default 2)."""
    try:
        return max(0.05,
                   float(os.environ.get("MTPU_IPC_ALLOC_TIMEOUT_S", "2")))
    except ValueError:
        return 2.0


def owner_stale_s() -> float:
    """MTPU_OWNER_STALE_S: an owner heartbeat older than this is a dead
    owner (default 2)."""
    try:
        return max(0.2, float(os.environ.get("MTPU_OWNER_STALE_S", "2")))
    except ValueError:
        return 2.0

