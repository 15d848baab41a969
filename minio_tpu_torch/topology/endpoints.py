"""Endpoint ellipsis expansion: the part of minio_tpu/topology/endpoints.py
the standalone boot reads (`--drives /data{1...12}`; cf.
createServerEndpoints, cmd/endpoint-ellipses.go:341).  Set sizing for
host-qualified cluster endpoints waits for the cluster boot (ROADMAP.md
Queue A item 9).
"""

from __future__ import annotations

import itertools
import re

_ELLIPSIS = re.compile(r"\{(\d+)\.\.\.(\d+)\}")


class TopologyError(ValueError):
    pass


def has_ellipses(*args: str) -> bool:
    return any(_ELLIPSIS.search(a) for a in args)


def expand_one(arg: str) -> list[str]:
    """Expand every {a...b} range in one argument (cartesian, in order).

    Numeric widths are preserved: {01...04} -> 01, 02, 03, 04.
    """
    spans = list(_ELLIPSIS.finditer(arg))
    if not spans:
        return [arg]
    ranges = []
    for mt in spans:
        a, b = mt.group(1), mt.group(2)
        lo, hi = int(a), int(b)
        if lo > hi:
            raise TopologyError(f"invalid range {mt.group(0)} in {arg!r}")
        width = len(a) if a.startswith("0") else 0
        ranges.append([str(v).zfill(width) for v in range(lo, hi + 1)])
    out = []
    for combo in itertools.product(*ranges):
        s, last = [], 0
        for mt, val in zip(spans, combo):
            s.append(arg[last:mt.start()])
            s.append(val)
            last = mt.end()
        s.append(arg[last:])
        out.append("".join(s))
    return out


def expand_endpoints(args: list[str]) -> list[list[str]]:
    """Expand each CLI arg into its ordered drive list (one list per arg)."""
    return [expand_one(a) for a in args]
