"""Storage RPC: serve this node's drives to its peers; `RemoteDrive`, a
peer's drive with the LocalDrive surface.

Counterpart of minio_tpu/rpc/storage_rpc.py (the storage-REST plane,
cmd/storage-rest-server.go:1138 and cmd/storage-rest-client.go), at the
same wire version (v3) and with the same method table and payloads, so
that either package's node serves the other's drives.  A method's
payload is `{"drive": index, "args": [...], "kwargs": {...}}`; a
FileInfo rides as `{"__fi__": to_obj(), "vol":, "name":}`, and shard
bytes as msgpack bytes in the body.

The engine fans out to local and remote drives alike: a drive's
position in the stripe matters, not where it is.  A transport failure
surfaces as ErrDiskNotFound, so a dead peer counts as a pulled drive.
The port's local-only and batched calls (`write_file_batches`,
`write_metadata_many`, `read_version_many`, `open_read_fd`,
`read_file_view`) are not on the wire: callers feature-detect them, so
a remote drive takes the solo calls, and no verb was added to v3.

`verify_file` runs on the node that holds the drive, on that node's
device (`register_storage_rpc(..., device=)`).
"""

from __future__ import annotations

import time

from ..storage.errors import ErrDiskNotFound
from ..storage.xlmeta import FileInfo
from .rest import DEFAULT_PLANE_VERSIONS, NetworkError, RPCClient

#: Storage plane wire version: bumped on any change of the method table,
#: the argument encoding or the FileInfo wire shape (the reference's
#: storageRESTVersion, cmd/storage-rest-common.go:21).
STORAGE_RPC_VERSION = "v3"
DEFAULT_PLANE_VERSIONS["storage"] = STORAGE_RPC_VERSION

_DRIVE_METHODS = [
    "make_volume", "list_volumes", "stat_volume", "delete_volume",
    "write_all", "read_all", "delete", "create_file", "append_file",
    "read_file", "rename_file", "file_size", "read_version",
    "write_metadata", "update_metadata", "rename_data", "delete_version",
    "list_dir", "walk_dir", "walk_page", "verify_file", "disk_info",
    "get_disk_id", "list_raw", "clear_tmp", "init_sys_volume",
]

#: Reads, safe to replay on a retryable transport fault.  Everything
#: else fails fast: a lost response looks like a lost request.
_IDEMPOTENT_METHODS = frozenset({
    "read_all", "read_file", "read_version", "stat_volume", "list_dir",
    "walk_dir", "walk_page", "file_size", "disk_info", "get_disk_id",
    "list_volumes", "list_raw", "verify_file",
})

#: How long a remote drive's capacity answer stays fresh: capacity moves
#: slowly, and a dead peer must not stall every caller for its timeout.
_DISK_INFO_TTL_S = 5.0


def _fi_wire(fi: FileInfo) -> dict:
    return {"__fi__": fi.to_obj(), "vol": fi.volume, "name": fi.name}


def _fi_unwire(a):
    if isinstance(a, dict) and "__fi__" in a:
        return FileInfo.from_obj(a["__fi__"], a.get("vol", ""),
                                 a.get("name", ""))
    return a


def register_storage_rpc(server, drives: list, device=None) -> None:
    """Serve `drives`, this node's drives, on an RPCServer or RPCRouter;
    `verify_file` verifies on `device` (None = the CUDA card)."""
    server.register_plane("storage", STORAGE_RPC_VERSION)

    def make_handler(method: str):
        def handler(payload: dict):
            idx = payload.get("drive", 0)
            if not 0 <= idx < len(drives):
                raise ErrDiskNotFound(f"drive {idx}")
            args = [_fi_unwire(a) for a in payload.get("args", [])]
            kwargs = dict(payload.get("kwargs", {}))
            if method == "verify_file":
                kwargs["device"] = device
            result = getattr(drives[idx], method)(*args, **kwargs)
            if isinstance(result, FileInfo):
                return _fi_wire(result)
            if method == "walk_dir":
                return [[name, raw] for name, raw in result]
            if method == "walk_page":
                entries, eof = result
                return [[[name, raw] for name, raw in entries], eof]
            return result
        return handler

    for m in _DRIVE_METHODS:
        server.register(f"storage.{m}", make_handler(m))


class RemoteDrive:
    """A peer's drive with the LocalDrive method surface; `is_online()` is
    the client's health state."""

    def __init__(self, client: RPCClient, drive_idx: int, path: str = ""):
        self._client = client
        self._idx = drive_idx
        self.path = path or f"{client.host}:{client.port}/drive{drive_idx}"
        self.root = self.path
        self._di_cache: tuple | None = None

    def is_online(self) -> bool:
        return self._client.is_online()

    def _call(self, method: str, *args, **kwargs):
        def wire(a):
            if isinstance(a, FileInfo):
                return _fi_wire(a)
            if isinstance(a, (memoryview, bytearray)) or \
                    type(a).__name__ == "ndarray":
                return bytes(a)
            return a
        try:
            result = self._client.call(
                f"storage.{method}",
                {"drive": self._idx, "args": [wire(a) for a in args],
                 "kwargs": kwargs},
                idempotent=method in _IDEMPOTENT_METHODS)
        except NetworkError as e:
            raise ErrDiskNotFound(str(e)) from None
        return _fi_unwire(result)

    def delete_version(self, vol: str, obj: str, version_id: str = "",
                       mark_delete: bool = False,
                       fi: FileInfo | None = None) -> None:
        """Positional on the wire: a FileInfo is encoded among the args
        only (the JAX client put the delete marker's FileInfo in kwargs,
        which msgpack cannot carry)."""
        return self._call("delete_version", vol, obj, version_id,
                          mark_delete, fi)

    def walk_dir(self, vol: str, prefix: str = ""):
        return [(n, raw) for n, raw in self._call("walk_dir", vol, prefix)]

    def walk_page(self, *args, **kwargs):
        entries, eof = self._call("walk_page", *args, **kwargs)
        return [(n, raw) for n, raw in entries], eof

    def disk_info(self) -> dict:
        """The peer's capacity answer, cached for _DISK_INFO_TTL_S; a
        stale answer beats a stalled caller when the peer is gone."""
        now = time.monotonic()
        cached = self._di_cache
        if cached is not None and now - cached[1] < _DISK_INFO_TTL_S:
            return cached[0]
        try:
            info = self._call("disk_info")
        except ErrDiskNotFound:
            if cached is not None:
                return cached[0]
            raise
        self._di_cache = (info, now)
        return info


def _add_method(name: str):
    def method(self, *args, **kwargs):
        return self._call(name, *args, **kwargs)
    method.__name__ = name
    setattr(RemoteDrive, name, method)


for _m in _DRIVE_METHODS:
    if not hasattr(RemoteDrive, _m):
        _add_method(_m)
del _m
