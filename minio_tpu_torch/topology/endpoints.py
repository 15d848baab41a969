"""Endpoint ellipsis expansion and erasure-set sizing.

Counterpart of minio_tpu/topology/endpoints.py.  The reference expands
``http://host{1...16}/disk{1...64}`` patterns into an ordered drive list
and chooses a set size by GCD so that every node adds the same number of
drives to every set (cf. createServerEndpoints,
cmd/endpoint-ellipses.go:341, and docs/distributed/DESIGN.md).  The
standalone boot reads local paths (`--drives /data{1...12}`); the
cluster boot (server/cluster.py) reads host-qualified URLs
(`Endpoint`, `parse_cluster_pools`), whose sets are laid out host-aware.
"""

from __future__ import annotations

import itertools
import math
import re

# Valid erasure-set drive counts (docs/distributed/DESIGN.md:40-44).
SET_SIZES = list(range(4, 17))

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


def _possible_set_counts(total: int, sizes: list[int]) -> list[int]:
    return [s for s in sizes if total % s == 0]


def choose_set_drive_count(arg_counts: list[int],
                           custom: int | None = None,
                           sizes: list[int] | None = None) -> int:
    """Pick the erasure-set drive count for a deployment.

    Mirrors getSetIndexes (reference cmd/endpoint-ellipses.go:178):
    the set size must divide every argument's drive count (symmetry), and
    the largest valid size <= GCD is preferred. A custom count (env
    MINIO_ERASURE_SET_DRIVE_COUNT in the reference) must itself be valid.
    """
    sizes = sizes or SET_SIZES
    if not arg_counts or any(c <= 0 for c in arg_counts):
        raise TopologyError("no drives")
    g = arg_counts[0]
    for c in arg_counts[1:]:
        g = math.gcd(g, c)
    valid = [s for s in sizes if s <= g and g % s == 0]
    if custom is not None:
        if custom not in sizes or g % custom != 0:
            raise TopologyError(
                f"custom set drive count {custom} incompatible with "
                f"drive counts {arg_counts}")
        return custom
    if not valid:
        raise TopologyError(
            f"no valid erasure-set size for drive counts {arg_counts} "
            f"(gcd {g}); valid sizes: {sizes}")
    return max(valid)


_LOCAL_NAMES: set[str] | None = None


def _local_names() -> set[str]:
    """Names/addresses this machine answers to (hostname, FQDN, and
    their resolved addresses) — cached; best-effort under no DNS."""
    global _LOCAL_NAMES
    if _LOCAL_NAMES is None:
        import socket
        names = {"127.0.0.1", "localhost", "::1"}
        for get in (socket.gethostname, socket.getfqdn):
            try:
                name = get()
            except OSError:
                continue
            if name:
                names.add(name)
                try:
                    for info in socket.getaddrinfo(name, None):
                        names.add(info[4][0])
                except OSError:
                    pass
        _LOCAL_NAMES = names
    return _LOCAL_NAMES


class Endpoint:
    """One drive endpoint: a bare local path, or a host-qualified URL
    ``http://host:port/path`` naming the node that serves the drive
    (cf. Endpoint, reference cmd/endpoint.go:54)."""

    __slots__ = ("scheme", "host", "port", "path")

    def __init__(self, raw: str):
        if "://" in raw:
            import urllib.parse
            u = urllib.parse.urlsplit(raw)
            if u.scheme not in ("http", "https"):
                raise TopologyError(f"bad endpoint scheme {raw!r}")
            if not u.hostname or not u.port:
                raise TopologyError(
                    f"endpoint {raw!r} needs explicit host:port")
            if not u.path or u.path == "/":
                raise TopologyError(f"endpoint {raw!r} has no path")
            self.scheme = u.scheme
            self.host = u.hostname
            self.port = int(u.port)
            self.path = u.path
        else:
            self.scheme = ""
            self.host = ""
            self.port = 0
            self.path = raw

    @property
    def is_url(self) -> bool:
        return bool(self.scheme)

    @property
    def node(self) -> tuple[str, int]:
        return (self.host, self.port)

    def is_local(self, my_host: str, my_port: int) -> bool:
        """Does this process serve this drive? The port must match; the
        host matches literally, as a loopback alias, or — when the
        server binds a wildcard/loopback default — as any name or
        address this machine answers to (the reference resolves
        interface IPs the same way, cmd/endpoint.go:241), so
        `--drives http://host{1...3}/...` works with the default
        --host on every node."""
        if not self.is_url:
            return True
        if self.port != my_port:
            return False
        loop = ("127.0.0.1", "localhost", "::1")
        if self.host in loop and my_host in loop + ("0.0.0.0", ""):
            return True
        if self.host == my_host:
            return True
        if my_host in loop + ("0.0.0.0", ""):
            return self.host in _local_names()
        return False

    def __repr__(self):
        if self.is_url:
            return f"{self.scheme}://{self.host}:{self.port}{self.path}"
        return self.path

    def __eq__(self, other):
        return repr(self) == repr(other)

    def __hash__(self):
        return hash(repr(self))


def parse_cluster_pools(groups: list[list[str]],
                        custom_set_count: int | None = None):
    """Expand CLI endpoint-arg GROUPS into POOLS: each group is one
    pool (the reference's zone-per-arg rule, cmd/endpoint-ellipses.go:
    341 — here a group is one --drives flag, so multi-node pools whose
    nodes listen on different ports remain expressible).

    -> (pools, nodes) where pools is a list of (endpoints,
    set_drive_count) per group and `nodes` the union (host, port) list
    in first-appearance order — node 0 (owner of pool 0's first
    endpoint) is the format leader for the whole deployment."""
    pools = []
    nodes: list[tuple[str, int]] = []
    for group in groups:
        eps, size, arg_nodes = parse_cluster_endpoints(group,
                                                       custom_set_count)
        pools.append((eps, size))
        for n in arg_nodes:
            if n not in nodes:
                nodes.append(n)
    kinds = {bool(eps and eps[0].is_url) for eps, _ in pools}
    if len(kinds) > 1:
        raise TopologyError("cannot mix URL and local-path pools")
    return pools, nodes


def parse_cluster_endpoints(args: list[str],
                            custom_set_count: int | None = None):
    """Expand + parse CLI endpoint args into the cluster layout.

    -> (endpoints, set_drive_count, nodes) where `endpoints` is the
    ordered global drive list, and `nodes` the unique (host, port)
    list in first-appearance order (node 0 = format leader,
    cf. firstDisk in cmd/prepare-storage.go:298).

    URL mode lays sets out HOST-AWARE: every node contributes
    set_drive_count / n_nodes drives to every set (the symmetric
    distribution of docs/distributed/DESIGN.md + getSetIndexes'
    symmetry rule, cmd/endpoint-ellipses.go:178) — so losing one node
    costs every set the same shard count, bounded by parity, instead
    of wiping some sets whole."""
    per_arg = expand_endpoints(args)
    eps = [Endpoint(e) for lst in per_arg for e in lst]
    kinds = {ep.is_url for ep in eps}
    if len(kinds) > 1:
        raise TopologyError("cannot mix URL and local-path endpoints")
    if not eps[0].is_url:
        counts = [len(x) for x in per_arg]
        size = choose_set_drive_count(counts, custom_set_count)
        return eps, size, []

    nodes: list[tuple[str, int]] = []
    by_node: dict[tuple[str, int], list[Endpoint]] = {}
    for ep in eps:
        if ep.node not in by_node:
            nodes.append(ep.node)
        by_node.setdefault(ep.node, []).append(ep)
    per_node = [len(by_node[n]) for n in nodes]
    if len(set(per_node)) != 1:
        raise TopologyError(
            f"asymmetric deployment: drives per node {per_node}")
    n_nodes, total = len(nodes), len(eps)
    valid = [s for s in SET_SIZES
             if total % s == 0 and s % n_nodes == 0]
    if custom_set_count is not None:
        if total % custom_set_count != 0 \
                or custom_set_count % n_nodes != 0 \
                or custom_set_count not in SET_SIZES:
            raise TopologyError(
                f"custom set drive count {custom_set_count} "
                f"incompatible with {total} drives on {n_nodes} nodes")
        size = custom_set_count
    elif valid:
        size = max(valid)
    else:
        raise TopologyError(
            f"no valid erasure-set size for {total} drives on "
            f"{n_nodes} nodes; valid sizes: {SET_SIZES}")
    # Interleave: set s takes drives [s*q:(s+1)*q] from every node.
    q = size // n_nodes
    n_sets = total // size
    ordered: list[Endpoint] = []
    for s in range(n_sets):
        for node in nodes:
            ordered.extend(by_node[node][s * q:(s + 1) * q])
    return ordered, size, nodes


def layout_pool(args: list[str], custom_set_count: int | None = None,
                sizes: list[int] | None = None) -> list[list[str]]:
    """Full pool layout: expand ellipses and slice into sets.

    Drives are interleaved across args the way the reference distributes
    them (for multi-host symmetry each set draws equally from each arg when
    counts allow; we use the simple contiguous slicing the reference applies
    to the flattened ordered list)."""
    per_arg = expand_endpoints(args)
    counts = [len(x) for x in per_arg]
    size = choose_set_drive_count(counts, custom_set_count, sizes)
    flat = [e for lst in per_arg for e in lst]
    return [flat[i:i + size] for i in range(0, len(flat), size)]
