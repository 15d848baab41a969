"""Zero-copy IO on the host (the port of minio_tpu/ops/zerocopy.py).

The MTPU_ZEROCOPY switch, default on; MTPU_ZEROCOPY=0 is the
byte-identical copying oracle, under which every caller keeps its
copying path.  Behind it:

- the pooled PUT ingest ring (utils/streams.batched_chunks) and the
  vectored staged-shard writes (storage/drive.LocalDrive.
  write_file_batches);
- the send half, here: `send_gather` carries a response's header block
  and any number of body segments (bytes, memoryviews, views of the hot
  tier's shared arena) in one `socket.sendmsg`, with IOV_MAX chunking
  and a partial-send continuation, so segments are never joined in
  userspace; `send_file` sends verified on-disk shard runs with
  `os.sendfile` (page cache -> socket, the k=1 layout where a data shard
  is the plaintext between bitrot frames), degrading to pread + sendall
  when the kernel refuses mid-stream.  `FilePlan` carries the open fd
  the verify pass read through, so the bytes sent are the bytes
  verified.

Both sends map EPIPE/ECONNRESET back to BrokenPipeError /
ConnectionResetError, so the server's quiet client-disconnect handling
covers the new syscalls.  `stats()` counts the sends, their bytes,
the hot tier's zero-copy views and the writer's fallbacks; the metrics
registry (observe/metrics.py) renders these counts as its
mtpu_zerocopy_* families, and keeps no counter of its own for them.

This module uses the standard library only.
"""

from __future__ import annotations

import errno
import os
import select
import threading

#: Linux UIO_MAXIOV is 1024; stay under it with headroom so a
#: many-segment response chunks instead of bouncing with EMSGSIZE.
IOV_MAX = 512

#: sendfile per-call cap: a slow client cannot pin one syscall forever
#: (the kernel blocks until the socket buffer drains).
SENDFILE_CHUNK = 8 << 20

_STATS_MU = threading.Lock()
_STATS = {"sendmsg": 0, "sendmsg_bytes": 0, "sendfile": 0,
          "sendfile_bytes": 0, "hot_views": 0, "hot_view_bytes": 0,
          "fallbacks": 0}


def zerocopy_enabled() -> bool:
    """Default ON; =0 is the byte-identical copying oracle.  Read per
    call, so tests flip it live."""
    return os.environ.get("MTPU_ZEROCOPY", "1") != "0"


def stats() -> dict:
    """This process's zero-copy counters: responses sent by sendmsg and
    by sendfile with their body bytes, hot-tier hits served as arena
    views, and verified plans the writer materialised instead (TLS,
    chunked framing, or the oracle)."""
    with _STATS_MU:
        return dict(_STATS)


def record(kind: str, nbytes: int = 0) -> None:
    """Count one `kind` event ("sendmsg", "sendfile", "hot_views",
    "fallbacks") of `nbytes` body bytes."""
    with _STATS_MU:
        _STATS[kind] += 1
        if kind != "fallbacks":
            key = "hot_view_bytes" if kind == "hot_views" \
                else f"{kind}_bytes"
            _STATS[key] += int(nbytes)


def _map_disconnect(e: OSError):
    """sendmsg/sendfile surface client disconnects as plain OSErrors;
    re-raise the two the server's quiet handling already catches."""
    if e.errno == errno.EPIPE or e.errno == errno.ESHUTDOWN:
        raise BrokenPipeError(e.errno, e.strerror or "broken pipe") from e
    if e.errno == errno.ECONNRESET:
        raise ConnectionResetError(e.errno,
                                   e.strerror or "connection reset") from e
    raise e


def send_gather(sock, segments) -> int:
    """Vectored send of `segments` (any buffer-protocol objects) by
    sendmsg: IOV_MAX chunking and partial-send continuation.  Returns
    the bytes sent; raises BrokenPipeError/ConnectionResetError when
    the client went away."""
    iov = [memoryview(s).cast("B") for s in segments if len(s)]
    total = 0
    while iov:
        try:
            n = sock.sendmsg(iov[:IOV_MAX])
        except OSError as e:
            _map_disconnect(e)
        if n <= 0:
            raise BrokenPipeError(errno.EPIPE, "zero-length send")
        total += n
        # Continuation: drop fully-sent segments, slice the partial one.
        while iov and n >= len(iov[0]):
            n -= len(iov[0])
            iov.pop(0)
        if n:
            iov[0] = iov[0][n:]
    return total


def send_file(sock, fd: int, runs) -> int:
    """sendfile each (file offset, length) run of `fd` to `sock`.

    When the kernel refuses (EINVAL, ENOSYS, EOVERFLOW, ENOTSOCK: an
    exotic file system or a socket that is no stream) the rest of the
    run goes by pread + sendall, so a response whose headers are on the
    wire always completes.  Returns the payload bytes sent."""
    total = 0
    for off, ln in runs:
        sent = 0
        while sent < ln:
            want = min(ln - sent, SENDFILE_CHUNK)
            try:
                n = os.sendfile(sock.fileno(), fd, off + sent, want)
            except OSError as e:
                if e.errno in (errno.EAGAIN, errno.EWOULDBLOCK):
                    # Raw sendfile bypasses the socket object's timeout:
                    # a full send buffer surfaces as EAGAIN.  Wait for
                    # writability under that timeout, then retry.
                    _wait_writable(sock)
                    continue
                if e.errno in (errno.EINVAL, errno.ENOSYS,
                               errno.EOVERFLOW, errno.ENOTSOCK):
                    _pread_send(sock, fd, off + sent, ln - sent)
                    sent = ln
                    break
                _map_disconnect(e)
            if n == 0:
                raise BrokenPipeError(errno.EPIPE, "sendfile hit EOF short")
            sent += n
        total += sent
    return total


def _wait_writable(sock) -> None:
    """Block until `sock` takes more bytes, under its own timeout (the
    wait socket.send would have done)."""
    _, w, _ = select.select((), (sock,), (), sock.gettimeout())
    if not w:
        raise TimeoutError("timed out waiting for socket writability")


def _pread_send(sock, fd: int, off: int, ln: int) -> None:
    """Userspace fallback for one run (sendfile refused)."""
    sent = 0
    while sent < ln:
        chunk = os.pread(fd, min(ln - sent, SENDFILE_CHUNK), off + sent)
        if not chunk:
            raise BrokenPipeError(errno.EPIPE, "file truncated mid-send")
        try:
            sock.sendall(chunk)
        except OSError as e:
            _map_disconnect(e)
        sent += len(chunk)


class FilePlan:
    """One part's verified, kernel-sendable byte runs.

    Carries an OPEN fd, the one the verify pass read through, so the
    bytes sendfile ships are the bytes that were verified: a racing
    delete only unlinks the name.  The server closes it after the send;
    __del__ is the backstop for a response that never reached the
    writer.
    """

    __slots__ = ("fd", "runs", "nbytes")

    def __init__(self, fd: int, runs, nbytes: int):
        self.fd = fd
        self.runs = runs
        self.nbytes = nbytes

    def close(self) -> None:
        fd, self.fd = self.fd, -1
        if fd >= 0:
            try:
                os.close(fd)
            except OSError:
                pass

    def read_all(self) -> bytes:
        """The plan's bytes through userspace (the oracle and TLS
        writers, and tests): pread every run in order."""
        out = bytearray()
        for off, ln in self.runs:
            got = 0
            while got < ln:
                chunk = os.pread(self.fd, ln - got, off + got)
                if not chunk:
                    raise OSError(errno.EIO, "file truncated under plan")
                out += chunk
                got += len(chunk)
        return bytes(out)

    def __del__(self):
        self.close()
