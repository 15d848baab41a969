"""Copy of minio_tpu/rpc/peer_rpc.py: the port keeps its own, so that it
imports nothing of the JAX package.

Peer RPC + NotificationSys: cluster-wide control-plane fan-out.

The peer-REST plane (reference cmd/peer-rest-server.go,
cmd/peer-rest-client.go) carried 42 control methods; here the same roles
ride the shared RPC core: config/IAM reload signals, bucket-metadata
invalidation, health/server info, trace subscription, profiling.
NotificationSys (cf. cmd/notification.go:50) fans a call out to every
peer in parallel and collects per-peer results — the control-plane
analogue of the storage plane's quorum fan-out.

The observability verbs of the same plane (`register_obs_rpc`:
peer.metrics_text, peer.healthinfo) answer a node's whole metrics render
and health document, which the admin `metrics/cluster` and `healthinfo`
endpoints fan out to.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor

from .rest import DEFAULT_PLANE_VERSIONS, RPCClient

#: Peer (control) plane wire version (cf. peerRESTVersion,
#: cmd/peer-rest-common.go:21).  v3: added the observability verbs
#: (peer.metrics_text, peer.healthinfo) — bump-on-wire-change.
PEER_RPC_VERSION = "v3"
DEFAULT_PLANE_VERSIONS["peer"] = PEER_RPC_VERSION


class PeerRegistry:
    """Per-node handler table the peer server dispatches into."""

    def __init__(self):
        self._reload_hooks: dict[str, callable] = {}
        self.trace_buffer: list[dict] = []
        self.started = time.time()
        self._profiler = None

    # -- profiling (the per-node side of cluster-wide profiling,
    # cf. StartProfilingHandler fan-out, cmd/admin-handlers.go:491) ----------

    def profile_start(self) -> bool:
        import cProfile
        if self._profiler is not None:
            return False
        self._profiler = cProfile.Profile()
        self._profiler.enable()
        return True

    def profile_dump(self) -> str:
        """Stop and render this node's profile ('' when none ran)."""
        import io
        import pstats
        prof, self._profiler = self._profiler, None
        if prof is None:
            return ""
        prof.disable()
        buf = io.StringIO()
        pstats.Stats(prof, stream=buf).sort_stats(
            "cumulative").print_stats(50)
        return buf.getvalue()

    def on_reload(self, subsystem: str, fn) -> None:
        self._reload_hooks[subsystem] = fn

    def reload(self, subsystem: str) -> bool:
        fn = self._reload_hooks.get(subsystem)
        if fn is None:
            return False
        fn()
        return True

    def server_info(self) -> dict:
        return {"uptime_s": round(time.time() - self.started, 1),
                "version": "minio-tpu-dev"}


def register_peer_rpc(server, registry: PeerRegistry) -> None:
    server.register_plane("peer", PEER_RPC_VERSION)
    server.register("peer.reload",
                    lambda p: registry.reload(p.get("subsystem", "")))
    server.register("peer.server_info", lambda p: registry.server_info())
    server.register("peer.trace_tail",
                    lambda p: registry.trace_buffer[-int(p.get("n", 100)):])
    server.register("peer.profile_start",
                    lambda p: registry.profile_start())
    server.register("peer.profile_dump",
                    lambda p: {"text": registry.profile_dump()})


def register_obs_rpc(server, s3_server) -> None:
    """Observability verbs: whole-node metric/health snapshots the
    admin aggregate endpoints fan out to (cf. the peer REST metrics
    channel, cmd/peer-rest-server.go GetMetricsHandler + the HealthInfo
    collection in cmd/admin-handlers.go).  Mounted separately from
    register_peer_rpc because they need the S3Server back-reference —
    only available after boot_cluster_node built it."""
    server.register("peer.metrics_text",
                    lambda p: {"text": s3_server.local_metrics_text()})
    server.register("peer.healthinfo",
                    lambda p: {"info": s3_server.local_healthinfo()})


class NotificationSys:
    """Broadcasts control-plane calls to all peers in parallel."""

    def __init__(self, peers: list[RPCClient]):
        self.peers = peers
        self._pool = ThreadPoolExecutor(max_workers=max(len(peers), 1) or 1)

    def _fan_out(self, method: str, payload: dict) -> list:
        def one(cli):
            try:
                return cli.call(method, payload), None
            except Exception as e:  # noqa: BLE001 — a dead peer is a result
                return None, e
        return list(self._pool.map(one, self.peers))

    def reload_subsystem(self, subsystem: str) -> int:
        """Tell every peer to reload (IAM, bucket metadata, config...);
        returns how many acknowledged."""
        res = self._fan_out("peer.reload", {"subsystem": subsystem})
        return sum(1 for r, e in res if e is None and r)

    def server_info(self) -> list[dict | None]:
        return [r for r, _ in self._fan_out("peer.server_info", {})]

    def trace_tail(self, n: int = 100) -> list[dict]:
        out = []
        for r, e in self._fan_out("peer.trace_tail", {"n": n}):
            if e is None and r:
                out.extend(r)
        return out


def verify_cluster_config(peers: list[RPCClient], token_check: dict) -> list:
    """Bootstrap handshake: every peer must agree on deployment basics
    before serving (cf. verifyServerSystemConfig,
    cmd/bootstrap-peer-server.go). Returns the list of mismatched peers.
    """
    bad = []
    for cli in peers:
        try:
            info = cli.call("peer.bootstrap_verify", token_check)
            if not info.get("ok"):
                bad.append((cli, info))
        except Exception as e:  # noqa: BLE001 — a dead peer is a result
            bad.append((cli, e))
    return bad


def register_bootstrap_rpc(server, expected: dict) -> None:
    server.register_plane("peer", PEER_RPC_VERSION)

    def verify(payload: dict) -> dict:
        mismatches = {k: (v, payload.get(k))
                      for k, v in expected.items() if payload.get(k) != v}
        return {"ok": not mismatches,
                "mismatches": {k: list(map(str, v))
                               for k, v in mismatches.items()}}
    server.register("peer.bootstrap_verify", verify)
