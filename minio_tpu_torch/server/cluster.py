"""Multi-node cluster boot: URL endpoints -> a serving node.

Counterpart of minio_tpu/server/cluster.py (the serverMain distributed
path, cmd/server-main.go:441, cmd/prepare-storage.go:298 and
cmd/bootstrap-peer-server.go).  Every node is launched with the same
endpoint list (`http://host{1...N}:port/drive{1...M}`) and its own
address; it

1. starts its front door first, S3 and every RPC plane on one port,
   routed by path (cmd/routers.go:27-39), so that peers reach its
   storage plane while it waits; S3 requests get 503 until step 4;
2. waits for the format: the first node (the owner of endpoint 0)
   formats the whole deployment, its local drives directly and the
   remote ones through the storage plane, while every other node polls
   until the format lands on its own drives;
3. verifies the cluster config with every peer (deployment id, layout
   digest, root access key; verifyServerSystemConfig);
4. builds the mixed local/remote erasure sets on its device, with a
   dsync namespace lock over one locker per node, and binds the object
   layer, its MRF queues, its data scanner (background/scanner.py, as on
   every node of the JAX package; MTPU_SCANNER=0 starts none), its
   notification system (bucket/notify.py) and IAM.  IAM's mutations,
   every bucket config write (versioning, notification, replication,
   object lock...) and every server config write broadcast a reload to
   the peers over the peer plane (`iam`, `bucket-metadata`, `config`)
   before the write answers, so the next request any node serves sees
   it; a reload first drops the node's cached listings and elections of
   the meta bucket.  The JAX boot wires none of these broadcasts.

The RPC bearer token is derived from the root credentials, so nodes
booted with the same MTPU_ROOT_USER / MTPU_ROOT_PASSWORD authenticate to
each other and nothing else does.

A node's own drives are health-wrapped where they live, so the breaker
trips on the node that owns a sick drive; each remote drive gets a
client-side wrapper of its own too (a partitioned peer trips it here, so
reads go to parity spares and writes feed MRF without every request
first paying a transport timeout).  A wrapped remote drive still reports
as RemoteDrive, so the local-only paths (vectored staging, the metadata
lanes' batched calls, the sendfile plan) leave it on the solo calls.

The boot mounts the peer plane's observability verbs
(`register_obs_rpc`: peer.metrics_text, peer.healthinfo) once the
server exists: the admin `metrics/cluster` and `healthinfo` endpoints
fan out to them.
"""

from __future__ import annotations

import hashlib
import hmac
import os
import ssl
import time

from ..cluster.local_locker import LocalLocker
from ..cluster.nslock import NSLockMap
from ..rpc.lock_rpc import RemoteLocker, register_lock_rpc
from ..rpc.peer_rpc import (NotificationSys, PeerRegistry,
                            register_bootstrap_rpc, register_obs_rpc,
                            register_peer_rpc,
                            verify_cluster_config)
from ..rpc.rest import RPCClient, RPCRouter, RPCVersionMismatch
from ..rpc.storage_rpc import RemoteDrive, register_storage_rpc
from ..storage.drive import LocalDrive
from ..storage.errors import ErrFileAccessDenied, StorageError
from ..storage.format import init_format_sets, load_format
from ..storage.health_wrap import HealthWrappedDrive, wrap_drives
from ..storage.recovery import boot_recovery_sweep
from ..topology.endpoints import Endpoint, parse_cluster_pools


class ClusterBootError(RuntimeError):
    pass


def internode_token(secret_key: str) -> str:
    """The bearer token of the RPC planes, from the root secret."""
    return hmac.new(secret_key.encode(), b"mtpu-internode",
                    hashlib.sha256).hexdigest()


def layout_digest(pools: list[tuple[list[Endpoint], int]]) -> str:
    """Every node must agree on the pool and drive order: a node booted
    with a reordered endpoint list would place shards elsewhere."""
    h = hashlib.sha256()
    for eps, size in pools:
        for ep in eps:
            h.update(repr(ep).encode())
            h.update(b"\x00")
        h.update(str(size).encode())
        h.update(b"\x01")
    return h.hexdigest()


class ClusterNode:
    """One server process's view of the deployment.  `device` is where
    its sets run and its storage plane verifies (None = the CUDA card)."""

    def __init__(self, endpoint_args: list, my_host: str, my_port: int,
                 creds, set_drive_count: int | None = None,
                 certs_dir: str = "", device=None):
        self.creds = creds
        self.device = device
        self.token = internode_token(creds.secret_key)
        # A flat list of args is one pool spanning its nodes (each arg
        # one node's drive pattern); a list of groups is one pool each.
        if endpoint_args and isinstance(endpoint_args[0], str):
            pool_groups = [list(endpoint_args)]
        else:
            pool_groups = [list(g) for g in endpoint_args]
        pools, nodes = parse_cluster_pools(pool_groups, set_drive_count)
        self.pools = pools
        eps = [ep for pool_eps, _ in pools for ep in pool_eps]
        # https endpoints: peers are dialed over TLS and trusted through
        # the deployment's certificate in the shared certs dir.
        self.tls_context = None
        if eps and eps[0].scheme == "https":
            ctx = ssl.create_default_context()
            ca = os.path.join(certs_dir, "public.crt") if certs_dir else ""
            if ca and os.path.exists(ca):
                ctx.load_verify_locations(ca)
            ctx.check_hostname = False
            self.tls_context = ctx
        self.endpoints = eps
        self.set_drive_count = pools[0][1]
        self.nodes = nodes
        self.my_host, self.my_port = my_host, my_port
        mine = [ep.is_local(my_host, my_port) for ep in eps]
        if not any(mine):
            raise ClusterBootError(
                f"none of the endpoints are local to {my_host}:{my_port}")
        self.my_node = next(ep.node for ep, m in zip(eps, mine) if m)
        self.is_first = mine[0]
        # drive_idx on the storage plane is the drive's position in its
        # serving node's list, which every node derives alike.
        self.node_locals: dict[tuple[str, int], list[Endpoint]] = {}
        for ep in eps:
            self.node_locals.setdefault(ep.node, []).append(ep)
        self.local_drives = wrap_drives(
            [LocalDrive(ep.path) for ep, m in zip(eps, mine) if m])
        # Each node sweeps its own drives (the previous epoch's staging,
        # trash and multipart stage files) before it takes traffic.
        self.swept = boot_recovery_sweep(self.local_drives)
        self.peer_clients: dict[tuple[str, int], RPCClient] = {
            node: RPCClient(f"{node[0]}:{node[1]}", self.token,
                            check_interval=1.0,
                            tls_context=self.tls_context)
            for node in nodes if node != self.my_node}
        self.router = RPCRouter(self.token)
        register_storage_rpc(self.router, self.local_drives, device)
        self.locker = LocalLocker()
        register_lock_rpc(self.router, self.locker)
        self.peer_registry = PeerRegistry()
        register_peer_rpc(self.router, self.peer_registry)
        self.layout_sha = layout_digest(pools)
        # Filled in place once the format gives the deployment id: the
        # verify handler enforces only the keys it knows, so a peer that
        # has not formatted yet is lenient about the id.
        self.bootstrap_expected = {"layout_sha": self.layout_sha,
                                   "access_key": creds.access_key}
        register_bootstrap_rpc(self.router, self.bootstrap_expected)
        self.notification = NotificationSys(
            list(self.peer_clients.values()))
        self.mrf_queues: list = []
        self.nslock = None

    def close(self) -> None:
        """Stop the peers' health loops, the MRF queues and the breakers'
        probers."""
        for cli in self.peer_clients.values():
            cli.close()
        for q in self.mrf_queues:
            q.stop()
        for d in self.local_drives:
            d.close()

    def build_drives(self) -> list:
        """The global drive list in endpoint order: this node's wrapped
        LocalDrives, and a wrapped RemoteDrive for every other node's."""
        out = []
        local_iter = iter(self.local_drives)
        for ep in self.endpoints:
            if ep.is_local(self.my_host, self.my_port):
                out.append(next(local_iter))
            else:
                cli = self.peer_clients[ep.node]
                idx = self.node_locals[ep.node].index(ep)
                out.append(HealthWrappedDrive(
                    RemoteDrive(cli, idx, path=repr(ep))))
        return out

    def peer_info(self) -> list[dict]:
        """Per-peer liveness rows."""
        return [cli.peer_info() for cli in self.peer_clients.values()]

    # -- format ----------------------------------------------------------------

    def _pool_slices(self, drives: list) -> list[list]:
        out, off = [], 0
        for eps, _ in self.pools:
            out.append(drives[off:off + len(eps)])
            off += len(eps)
        return out

    def _format_all_pools(self, drives: list) -> list[dict]:
        """Format or adopt every pool; pool 0 mints the deployment id and
        the others share it."""
        fmts, dep_id = [], None
        for (eps, k), pool_drives in zip(self.pools,
                                         self._pool_slices(drives)):
            rows = [pool_drives[i:i + k]
                    for i in range(0, len(pool_drives), k)]
            fmt = init_format_sets(rows, deployment_id=dep_id)
            dep_id = fmt["id"]
            fmts.append(fmt)
        return fmts

    def wait_format(self, drives: list, timeout: float = 60.0,
                    poll: float = 0.3) -> list[dict]:
        """The format-quorum wait -> one reference format per pool.

        The first node formats the whole deployment once every drive
        answers (a fresh format needs all of them); a formatted one loads
        at quorum, so one dead peer never blocks a restart.  Every other
        node polls its own drives until the first node's format lands on
        one, then adopts it and heals its unformatted drives into their
        recorded slots (cmd/prepare-storage.go:298)."""
        deadline = time.monotonic() + timeout
        last_err: Exception | None = None
        while time.monotonic() < deadline:
            ready = self.is_first
            if not ready:
                for d in self.local_drives:
                    try:
                        if load_format(d) is not None:
                            ready = True
                            break
                    except StorageError as e:
                        last_err = e
            if ready:
                try:
                    return self._format_all_pools(drives)
                except StorageError as e:
                    last_err = e          # peers not all up yet: retry
            time.sleep(poll)
        raise ClusterBootError(
            f"format quorum not reached in {timeout:.0f}s "
            f"(first={self.is_first}): {last_err}")

    def wait_peers_verified(self, deployment_id: str,
                            timeout: float = 60.0,
                            poll: float = 0.3) -> None:
        """Every peer must agree on layout and credentials before this
        node serves.  A config mismatch, a refused token (other root
        credentials) or a plane version mismatch fails at once; a peer
        that does not answer yet is retried until the deadline."""
        self.bootstrap_expected["deployment_id"] = deployment_id
        check = dict(self.bootstrap_expected)
        deadline = time.monotonic() + timeout
        clients = list(self.peer_clients.values())
        while True:
            bad = verify_cluster_config(clients, check)
            hard = [b for b in bad
                    if not isinstance(b[1], Exception)
                    or isinstance(b[1], (ErrFileAccessDenied,
                                         RPCVersionMismatch))]
            if hard:
                who = ", ".join(f"{c.host}:{c.port} {info}"
                                for c, info in hard)
                raise ClusterBootError(f"cluster config mismatch: {who}")
            if not bad:
                return
            if time.monotonic() >= deadline:
                who = ", ".join(f"{c.host}:{c.port}" for c, _ in bad)
                raise ClusterBootError(
                    f"peers unreachable for bootstrap verify: {who}")
            time.sleep(poll)

    # -- object layer ----------------------------------------------------------

    def build_object_layer(self, drives: list, default_parity=None,
                           fmt: list[dict] | None = None):
        """Mixed-drive sets on this node's device with one cluster-wide
        namespace lock: dsync over one locker per node, this one direct
        and the peers' through the lock plane
        (cmd/namespace-lock.go:224).  `fmt` is wait_format's per-pool
        formats, which skips a second scan of the deployment."""
        from ..engine.pools import ServerPools
        from ..engine.sets import ErasureSets
        lockers = [self.locker] + [RemoteLocker(cli)
                                   for cli in self.peer_clients.values()]
        nslock = NSLockMap(lockers=lockers) if self.peer_clients else None
        fmts = fmt if fmt is not None else [None] * len(self.pools)
        pool_sets: list = []
        try:
            for (eps, size), pool_drives, pf in zip(
                    self.pools, self._pool_slices(drives), fmts):
                pool_sets.append(ErasureSets(
                    pool_drives, set_drive_count=size,
                    default_parity=default_parity, nslock=nslock,
                    preloaded_format=pf, device=self.device,
                    deployment_id=(pool_sets[0].deployment_id
                                   if pool_sets else None)))
        except BaseException:
            for s in pool_sets:
                s.close()
            raise
        self.nslock = nslock
        return ServerPools(pool_sets)


def boot_cluster_node(endpoint_args: list, my_host: str, my_port: int,
                      creds, set_drive_count: int | None = None,
                      server_factory=None, timeout: float = 60.0,
                      certs_dir: str = "", device=None):
    """The whole boot -> (node, server, pools).

    server_factory(node) returns a STARTED S3Server with node.router
    mounted and no object layer yet."""
    from ..background.mrf import attach_mrf
    from ..bucket.metadata import META_BUCKET
    from ..iam.iam import IAMSys
    node = ClusterNode(endpoint_args, my_host, my_port, creds,
                       set_drive_count, certs_dir=certs_dir, device=device)
    server = server_factory(node)
    server.cluster_node = node
    # The observability verbs need the server back-reference (they
    # snapshot the whole node through it), so they mount here, not in
    # ClusterNode.__init__.
    register_obs_rpc(node.router, server)
    pools = None
    try:
        drives = node.build_drives()
        fmt = node.wait_format(drives, timeout=timeout)
        node.wait_peers_verified(fmt[0]["id"], timeout=timeout)
        pools = node.build_object_layer(drives, fmt=fmt)
        node.mrf_queues = attach_mrf(pools)
        iam = IAMSys(pools, notify=node.notification)

        def meta_dirty():
            # A peer's write bumped no generation on this node: its
            # cached listings and elections of the meta bucket go first,
            # or a reload would read what it already had.
            for pool in pools.pools:
                for es in pool.sets:
                    es._mark_dirty(META_BUCKET)

        def reload_iam():
            meta_dirty()
            iam.load()

        def reload_configs():
            meta_dirty()
            if server.handlers is not None:     # else bound fresh below
                server.reload_bucket_configs()
        node.peer_registry.on_reload("iam", reload_iam)
        # A bucket config or the server config a peer wrote: the cached
        # configs go, the notification rules reload and replication
        # rewires, as a pool's workers do on a config generation.
        node.peer_registry.on_reload("bucket-metadata", reload_configs)
        node.peer_registry.on_reload("config", reload_configs)
        from ..background.scanner import scanner_from_env
        from ..bucket.replication import ReplicationPool

        def wire(h):
            # This node's writes reach every peer before they answer.
            h.meta.on_change = (
                lambda _b, _k: node.notification.reload_subsystem(
                    "bucket-metadata"))
            h.config_sys.on_write = (
                lambda: node.notification.reload_subsystem("config"))
            if server.tier_mgr is not None:
                # A tier registered here reaches every peer's registry.
                server.tier_mgr.on_change = (
                    lambda: node.notification.reload_subsystem("config"))
        server.bind_object_layer(pools, iam=iam,
                                 scanner=scanner_from_env(pools),
                                 replication=ReplicationPool(pools),
                                 wire=wire)
        return node, server, pools
    except BaseException:
        server.shutdown()
        node.close()
        if pools is not None:
            pools.close()
        raise
