"""Copy of minio_tpu/rpc/lock_rpc.py: the port keeps its own, so that it
imports nothing of the JAX package.

Lock RPC: expose a LocalLocker to peers; RemoteLocker client.

The lock-REST plane (reference cmd/lock-rest-server.go:72-190 and
cmd/lock-rest-client.go): Lock/Unlock/RLock/RUnlock/Refresh/ForceUnlock
handlers over the shared RPC core. RemoteLocker mirrors the LocalLocker
method surface so dsync.DRWMutex takes local and remote lockers
interchangeably.
"""

from __future__ import annotations

from ..cluster.local_locker import LocalLocker
from .rest import DEFAULT_PLANE_VERSIONS, RPCClient

#: Lock plane wire version (cf. lockRESTVersion,
#: cmd/lock-rest-server-common.go:25).
LOCK_RPC_VERSION = "v2"
DEFAULT_PLANE_VERSIONS["lock"] = LOCK_RPC_VERSION

_LOCK_METHODS = ["lock", "unlock", "rlock", "runlock", "refresh"]


def register_lock_rpc(server, locker: LocalLocker) -> None:
    server.register_plane("lock", LOCK_RPC_VERSION)
    def make_handler(method: str):
        def handler(payload: dict):
            return bool(getattr(locker, method)(
                payload["resource"], payload.get("uid", "")))
        return handler

    for m in _LOCK_METHODS:
        server.register(f"lock.{m}", make_handler(m))
    server.register("lock.force_unlock",
                    lambda p: bool(locker.force_unlock(p["resource"])))
    server.register("lock.stats", lambda p: locker.stats())


class RemoteLocker:
    """A peer's locker. Transport failure -> False vote (raise-free), the
    same no-vote semantics the reference's lock client produces for an
    unreachable peer."""

    def __init__(self, client: RPCClient):
        self._client = client

    def _call(self, method: str, resource: str, uid: str = "") -> bool:
        try:
            return bool(self._client.call(
                f"lock.{method}", {"resource": resource, "uid": uid}))
        except Exception:  # noqa: BLE001 — unreachable peer = no vote
            return False

    def lock(self, resource: str, uid: str) -> bool:
        return self._call("lock", resource, uid)

    def unlock(self, resource: str, uid: str) -> bool:
        return self._call("unlock", resource, uid)

    def rlock(self, resource: str, uid: str) -> bool:
        return self._call("rlock", resource, uid)

    def runlock(self, resource: str, uid: str) -> bool:
        return self._call("runlock", resource, uid)

    def refresh(self, resource: str, uid: str) -> bool:
        return self._call("refresh", resource, uid)

    def force_unlock(self, resource: str) -> bool:
        return self._call("force_unlock", resource)
