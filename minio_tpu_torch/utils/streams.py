"""Body streaming helpers (the part of minio_tpu/utils/streams.py the
port calls): the per-stream ETag digest (PipelinedMD5), reader
detection, batch chunking with the pooled ingest ring, the single-part
and multipart ETags, and the bounded readers a request body flows
through from the socket to the erasure encoder (cf. hash.Reader,
internal/hash/reader.go:63, and the HTTP chunked decoding of the
reference): bodies stream in bounded pieces, their hashes checked at EOF
instead of after buffering the whole object.  Every reader has
`readinto`, so a body lands in the ingest ring's buffers without a
bytes object per piece.

The JAX package's native MD5 lanes (utils/digestlanes.py over
native/digest.cc) get no port: the port loads nothing from native/, so
PipelinedMD5 is the hashlib path whatever MTPU_NATIVE_DIGEST says."""

from __future__ import annotations

import collections
import hashlib
import threading
from concurrent.futures import ThreadPoolExecutor

#: Dedicated digest workers for PipelinedMD5, shared by every stream of
#: the process.  They must NOT share an engine pool: a digest step
#: resubmits its stream's next piece, and a pool that also runs the
#: PUTs feeding those streams could fill with callers waiting on steps
#: queued behind them (the isolation argument of
#: ErasureSet._iter_pool).
_MD5_POOL: ThreadPoolExecutor | None = None
_MD5_POOL_LOCK = threading.Lock()


def _md5_pool() -> ThreadPoolExecutor:
    global _MD5_POOL
    with _MD5_POOL_LOCK:
        if _MD5_POOL is None:
            _MD5_POOL = ThreadPoolExecutor(max_workers=4,
                                           thread_name_prefix="mtpu-md5")
        return _MD5_POOL


class PipelinedMD5:
    """MD5 streamed off the caller's thread, so the S3 ETag digest
    overlaps encode and write instead of running before them.  Same
    bytes in the same order, so the hex digest is hashlib.md5(body)'s.

    Streams share a process-wide pool of 4 piece by piece: a digest
    step takes one queued piece of its stream, hashes it (hashlib
    releases the GIL) and, when more are queued, resubmits the stream
    behind the pool's other work.  A stream holds a worker only while
    one of its pieces is hashed, so any number of concurrent PUTs and
    parts interleave on the 4 workers, and one with nothing queued
    (waiting on its socket, or abandoned by a failed PUT) holds none.
    The JAX package gives each stream a worker for its whole life
    (and a 60 s idle backstop for a stream that is never closed); a
    fifth stream there waits for a whole earlier PUT.

    update() first waits for the stream's previous piece: one streamed
    piece in flight per stream, so a fast socket cannot pile a body up
    in host memory ahead of a slow digest.  feed() queues a whole
    in-memory body at once (views, no copies: it is in memory already).
    update()/hexdigest() mirror hashlib's; close() is the abandon path
    (the PUT failed before the ETag was needed): it drops what is
    queued."""

    def __init__(self):
        self._h = hashlib.md5()
        self._lock = threading.Lock()
        self._pieces: collections.deque = collections.deque()
        self._idle = threading.Event()
        self._idle.set()
        self._err: BaseException | None = None

    def _step(self) -> None:
        while True:
            with self._lock:
                if not self._pieces:
                    self._idle.set()
                    return
                piece = self._pieces.popleft()
            try:
                self._h.update(piece)
            except BaseException as e:  # noqa: BLE001 — to hexdigest
                with self._lock:
                    self._err = e
                    self._pieces.clear()
                    self._idle.set()
                return
            with self._lock:
                if not self._pieces:
                    self._idle.set()
                    return
            try:
                _md5_pool().submit(self._step)
                return
            except RuntimeError:
                continue    # the pool shuts down with the interpreter

    def _push(self, pieces) -> None:
        with self._lock:
            self._pieces.extend(pieces)
            if self._idle.is_set() and self._pieces:
                self._idle.clear()
                try:
                    _md5_pool().submit(self._step)
                except BaseException:
                    self._pieces.clear()
                    self._idle.set()
                    raise

    def update(self, piece) -> None:
        self._idle.wait()
        # Writable views are VOLATILE: the pooled ingest ring
        # (batched_chunks) recycles its buffers after a few pulls, and
        # returns them to the pool when the body ends, possibly before
        # this piece is hashed; stabilise them with one copy here.
        # Immutable pieces (bytes, read-only views of a bytes body)
        # stay zero-copy.
        if isinstance(piece, memoryview) and not piece.readonly:
            piece = bytes(piece)
        self._push((piece,))

    def feed(self, data, chunk_len: int = 1 << 20) -> None:
        """Queue a whole in-memory body as chunk-sized views (no
        copies): the bytes-path shape, queue everything, then encode
        while the workers digest it piece by piece."""
        mv = memoryview(data)
        self._push(mv[off:off + chunk_len]
                   for off in range(0, len(mv), chunk_len))

    def close(self) -> None:
        with self._lock:
            self._pieces.clear()

    def hexdigest(self) -> str:
        self._idle.wait()
        if self._err is not None:
            raise self._err
        return self._h.hexdigest()


class StreamError(IOError):
    """Malformed or truncated request body; maps to a 400-class S3
    error at the HTTP layer (IncompleteBody), not a 500."""


def is_reader(x) -> bool:
    """Anything with .read(n) that is not already bytes-like."""
    return (not isinstance(x, (bytes, bytearray, memoryview))
            and hasattr(x, "read"))


def ensure_bytes(x) -> bytes:
    """Drain a reader (or copy bytes-like data) into bytes."""
    if isinstance(x, (bytes, bytearray, memoryview)):
        return bytes(x)
    out = bytearray()
    while True:
        piece = x.read(1 << 20)
        if not piece:
            return bytes(out)
        out += piece


def _readinto_via_read(read, b) -> int:
    """readinto for a source that only has read(): one bounded read
    copied into the caller's buffer.  May return fewer bytes than
    len(b); returns 0 only at EOF (the read() contract of every reader
    in this module)."""
    mv = b if isinstance(b, memoryview) else memoryview(b)
    piece = read(len(mv))
    n = len(piece)
    if n:
        mv[:n] = piece
    return n


def _src_readinto(src, b) -> int:
    """`src.readinto(b)` when the source has it, else one read() copied
    in."""
    ri = getattr(src, "readinto", None)
    return (ri(b) if ri is not None
            else _readinto_via_read(src.read, b)) or 0


class BytesReader:
    """bytes -> reader."""

    def __init__(self, data: bytes):
        self._mv = memoryview(data)
        self._pos = 0

    def read(self, n: int = -1) -> bytes:
        if n is None or n < 0:
            n = len(self._mv) - self._pos
        out = self._mv[self._pos:self._pos + n]
        self._pos += len(out)
        return bytes(out)

    def readinto(self, b) -> int:
        mv = b if isinstance(b, memoryview) else memoryview(b)
        n = min(len(mv), len(self._mv) - self._pos)
        if n:
            mv[:n] = self._mv[self._pos:self._pos + n]
            self._pos += n
        return n


class LimitedReader:
    """Reads exactly `limit` bytes from `raw` then reports EOF; a short
    source raises StreamError (truncated body)."""

    def __init__(self, raw, limit: int):
        self._raw = raw
        self._left = limit

    def read(self, n: int = -1) -> bytes:
        if self._left <= 0:
            return b""
        if n is None or n < 0:
            n = self._left
        piece = self._raw.read(min(n, self._left))
        if not piece and self._left:
            raise StreamError(f"body truncated ({self._left} bytes short)")
        self._left -= len(piece)
        return piece

    def readinto(self, b) -> int:
        if self._left <= 0:
            return 0
        mv = b if isinstance(b, memoryview) else memoryview(b)
        want = min(len(mv), self._left)
        if not want:
            return 0
        n = _src_readinto(self._raw, mv[:want])
        if not n and self._left:
            raise StreamError(f"body truncated ({self._left} bytes short)")
        self._left -= n
        return n


class ExactLengthReader:
    """Pass-through reader that holds the stream to EXACTLY `want`
    decoded bytes: a client-declared decoded length (aws-chunked
    x-amz-decoded-content-length) is only trustworthy for size checks if
    something verifies it."""

    def __init__(self, src, want: int, exc=None):
        self._src = src
        self._want = want
        self._seen = 0
        self._exc = exc or (lambda msg: StreamError(msg))

    def read(self, n: int = -1) -> bytes:
        piece = self._src.read(n)
        self._seen += len(piece)
        if self._seen > self._want:
            raise self._exc(
                f"body longer than declared ({self._seen} > {self._want})")
        if not piece and self._seen != self._want:
            raise self._exc(
                f"body shorter than declared ({self._seen} < {self._want})")
        return piece

    def readinto(self, b) -> int:
        if not len(b):
            return 0
        n = _src_readinto(self._src, b)
        self._seen += n
        if self._seen > self._want:
            raise self._exc(
                f"body longer than declared ({self._seen} > {self._want})")
        if not n and self._seen != self._want:
            raise self._exc(
                f"body shorter than declared ({self._seen} < {self._want})")
        return n


class MaxSizeReader:
    """Pass-through reader that raises `exc` once more than `cap` bytes
    have flowed: bounds bodies whose length is not declared up front
    (Transfer-Encoding: chunked)."""

    def __init__(self, src, cap: int, exc=None):
        self._src = src
        self._cap = cap
        self._seen = 0
        self._exc = exc or (lambda msg: StreamError(msg))

    def read(self, n: int = -1) -> bytes:
        piece = self._src.read(n)
        self._seen += len(piece)
        if self._seen > self._cap:
            raise self._exc(f"body exceeds {self._cap} bytes")
        return piece

    def readinto(self, b) -> int:
        if not len(b):
            return 0
        n = _src_readinto(self._src, b)
        self._seen += n
        if self._seen > self._cap:
            raise self._exc(f"body exceeds {self._cap} bytes")
        return n


class HashVerifyReader:
    """Pass-through reader that checks the stream's SHA-256 at EOF (the
    hash.Reader role, internal/hash/reader.go:63); `exc` is what a
    mismatch raises."""

    def __init__(self, src, want_sha256_hex: str, exc=IOError):
        self._src = src
        self._want = want_sha256_hex
        self._h = hashlib.sha256()
        self._exc = exc
        self._done = False

    def read(self, n: int = -1) -> bytes:
        piece = self._src.read(n)
        if piece:
            self._h.update(piece)
        elif not self._done:
            self._done = True
            if self._h.hexdigest() != self._want:
                raise self._exc("content sha256 mismatch")
        return piece

    def readinto(self, b) -> int:
        if not len(b):
            return 0
        mv = b if isinstance(b, memoryview) else memoryview(b)
        n = _src_readinto(self._src, mv)
        if n:
            # hashlib consumes synchronously: safe on a pooled view.
            self._h.update(mv[:n])
        elif not self._done:
            self._done = True
            if self._h.hexdigest() != self._want:
                raise self._exc("content sha256 mismatch")
        return n


class HTTPChunkedReader:
    """Streaming decoder for HTTP/1.1 chunked transfer encoding (not
    aws-chunked: that is server/sigv4.StreamingSigV4Reader's job)."""

    def __init__(self, rfile):
        self._rf = rfile
        self._chunk_left = 0
        self._eof = False

    def _next_chunk(self) -> None:
        line = self._rf.readline().strip()
        try:
            self._chunk_left = int(line.split(b";")[0], 16)
        except ValueError:
            raise StreamError(f"bad chunk size line {line[:32]!r}") \
                from None
        if self._chunk_left == 0:
            # consume optional trailers up to the blank terminator line
            while True:
                line = self._rf.readline()
                if line in (b"\r\n", b"\n", b""):
                    break
            self._eof = True

    def read(self, n: int = -1) -> bytes:
        if self._eof:
            return b""
        out = bytearray()
        while n < 0 or len(out) < n:
            if self._chunk_left == 0:
                self._next_chunk()
                if self._eof:
                    break
            want = self._chunk_left if n < 0 \
                else min(self._chunk_left, n - len(out))
            piece = self._rf.read(want)
            if not piece:
                raise StreamError("truncated chunked body")
            out += piece
            self._chunk_left -= len(piece)
            if self._chunk_left == 0:
                self._rf.read(2)         # chunk CRLF
        return bytes(out)


def etag(data) -> str:
    """S3 ETag of a single-part body: the hex MD5."""
    return hashlib.md5(data).hexdigest()


def multipart_etag(part_etags: list[str]) -> str:
    """S3 ETag of a multipart object: the MD5 of the concatenated binary
    part MD5s, then "-" and the number of parts."""
    md5s = b"".join(bytes.fromhex(e) for e in part_etags)
    return f"{hashlib.md5(md5s).hexdigest()}-{len(part_etags)}"


#: Pooled ingest ring depth: a yielded view stays valid for
#: _RING_DEPTH - 1 further pulls.  The encode pipeline holds at most
#: one batch pending (chunk i is consumed while chunk i+1 is read), so
#: 2 would do; 4 leaves margin for a prefetching stage pipeline.
_RING_DEPTH = 4


def _fill_from(stream, view) -> int:
    """Fill writable memoryview `view` from `stream`; returns the bytes
    filled (< len(view) only at EOF).  With readinto in the reader chain
    the socket's bytes land straight in the caller's buffer; otherwise
    read() pieces are copied in (still one destination buffer, no
    bytearray re-assembly)."""
    filled, total = 0, len(view)
    ri = getattr(stream, "readinto", None)
    if ri is not None:
        while filled < total:
            n = ri(view[filled:])
            if not n:
                break
            filled += n
        return filled
    while filled < total:
        piece = stream.read(total - filled)
        if not piece:
            break
        lp = len(piece)
        view[filled:filled + lp] = piece
        filled += lp
    return filled


def _pooled_chunks(head, stream, chunk_len: int):
    """Streaming chunker over a ring of page-aligned buffer-pool leases
    (the PUT-ingest half of MTPU_ZEROCOPY): each chunk is filled in
    place through readinto instead of bytes pieces and a final bytes()
    copy.  Yields writable memoryviews, valid until _RING_DEPTH - 1
    further pulls; a consumer that defers (PipelinedMD5) copies a
    volatile view on its side."""
    from ..ops import bpool
    pool = bpool.default_pool()
    slots: list = [None] * _RING_DEPTH
    try:
        carry = memoryview(head)
        i = 0
        while True:
            slot = i % _RING_DEPTH
            if slots[slot] is None:
                slots[slot] = pool.get(chunk_len)
            view = memoryview(slots[slot].view)
            pre = min(len(carry), chunk_len)
            if pre:
                view[:pre] = carry[:pre]
                carry = carry[pre:]
            filled = pre
            if filled < chunk_len:
                filled += _fill_from(stream, view[pre:])
            if filled < chunk_len:
                yield view[:filled], True    # final chunk (may be empty)
                return
            yield view, False
            i += 1
    finally:
        for lease in slots:
            if lease is not None:
                lease.release()


def batched_chunks(head, stream, chunk_len: int):
    """Yield (chunk, is_last) with every chunk exactly chunk_len bytes
    except the final one (which may be empty when the total length is an
    exact multiple).  `head` is bytes already consumed from `stream`;
    with `stream` None the chunks are zero-copy views of `head`.  A
    stream goes through the pooled ingest ring when zero-copy is on
    (MTPU_ZEROCOPY, default on); =0 is the bytearray oracle."""
    if stream is None:
        mv = memoryview(head)
        pos = 0
        while len(mv) - pos > chunk_len:
            yield mv[pos:pos + chunk_len], False
            pos += chunk_len
        yield mv[pos:], True
        return
    from ..ops import zerocopy
    if zerocopy.zerocopy_enabled():
        yield from _pooled_chunks(head, stream, chunk_len)
        return
    buf = bytearray(head)
    eof = False
    while True:
        while not eof and len(buf) < chunk_len:
            piece = stream.read(chunk_len - len(buf))
            if not piece:
                eof = True
            else:
                buf += piece
        if eof and len(buf) <= chunk_len:
            yield bytes(buf), True       # final chunk (may be empty)
            return
        yield bytes(buf[:chunk_len]), False
        del buf[:chunk_len]
