"""Crash-point injection (MTPU_CRASH), the port's copy of
minio_tpu/utils/crashpoints.py.

A kill -9 harness needs a process to die at named points inside a
durability window, which a SIGKILL from outside cannot hit on purpose.
The code under test calls `crash_point("name")` there, and the
environment arms the points:

    MTPU_CRASH=point            die on the first hit of `point`
    MTPU_CRASH=point:3          die on the 3rd hit (process-wide count)
    MTPU_CRASH=p1:2,p2          several points, the first one reached wins

Death is `os._exit(137)`: no atexit, no finally block, no flush, the
nearest a process comes to kill -9 from the inside (137 reads like a
SIGKILL in a harness's log).  With nothing armed (every normal boot) a
crash point is one falsy dict check.

The port arms the decommission mover's four points (background/
decom.py), the tier's four (bucket/tier.py) and replication's four
(bucket/replication.py).  The drive's
and the engine's points of the JAX registry wait for the crash matrix
(ROADMAP.md Queue A item 11); naming one raises, as any unknown point
does.
"""

from __future__ import annotations

import os
import threading

#: the instrumented points, in each path's order
POINTS = (
    "decom.pre_verify",          # mover: before the destination probe
    "decom.post_copy",           # mover: copy published, source intact
    "decom.pre_delete",          # mover: dest verified, source not deleted
    "decom.checkpoint",          # mover: source gone, journal not appended
    "ilm.pre_stub",              # transition: intent journaled, no copy
    "ilm.post_copy",             # transition: tier copy durable, hot intact
    "ilm.pre_delete",            # free journaled, tier object not deleted
    "ilm.checkpoint",            # stub published, journal 'done' not appended
    "repl.enqueue",              # replication: intent journaled, not runnable
    "repl.pre_copy",             # replication: task taken, nothing copied
    "repl.post_copy",            # replication: copy landed, not counted
    "repl.status",               # replication: counted, source not stamped
)

_mu = threading.Lock()
_armed: dict[str, int] = {}      # point -> hits left before death
hits: dict[str, int] = {}        # point -> hits seen (diagnostics)


def _parse(spec: str) -> dict[str, int]:
    armed: dict[str, int] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, nth = part.partition(":")
        if name not in POINTS:
            # A mistyped point would arm nothing, and a harness would
            # wait for a death that cannot come: refuse at boot.
            raise ValueError(
                f"MTPU_CRASH: unknown crash point {name!r} "
                f"(known: {', '.join(POINTS)})")
        try:
            n = int(nth) if nth else 1
        except ValueError:
            n = 1
        armed[name] = max(1, n)
    return armed


def arm(spec: str) -> None:
    """(Re)arm from a spec string: the environment's, or a test's."""
    global _armed
    with _mu:
        _armed = _parse(spec)
        hits.clear()


def reset() -> None:
    global _armed
    with _mu:
        _armed = {}
        hits.clear()


def crash_point(name: str) -> None:
    """Die here if armed; one falsy check when nothing is."""
    if not _armed:
        return
    with _mu:
        left = _armed.get(name)
        if left is None:
            return
        hits[name] = hits.get(name, 0) + 1
        if left > 1:
            _armed[name] = left - 1
            return
    try:
        os.write(2, f"MTPU_CRASH: dying at {name}\n".encode())
    except OSError:
        pass
    os._exit(137)


_spec = os.environ.get("MTPU_CRASH", "")
if _spec:
    arm(_spec)
