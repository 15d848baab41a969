"""Body streaming helpers (the part of minio_tpu/utils/streams.py the
port calls): reader detection, batch chunking, the single-part and
multipart ETags, and the bounded readers a request body flows through
from the socket to the erasure encoder (cf. hash.Reader,
internal/hash/reader.go:63, and the HTTP chunked decoding of the
reference): bodies stream in bounded pieces, their hashes checked at EOF
instead of after buffering the whole object."""

from __future__ import annotations

import hashlib


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


def batched_chunks(head, stream, chunk_len: int):
    """Yield (chunk, is_last) with every chunk exactly chunk_len bytes
    except the final one (which may be empty when the total length is an
    exact multiple).  `head` is bytes already consumed from `stream`;
    with `stream` None the chunks are zero-copy views of `head`."""
    if stream is None:
        mv = memoryview(head)
        pos = 0
        while len(mv) - pos > chunk_len:
            yield mv[pos:pos + chunk_len], False
            pos += chunk_len
        yield mv[pos:], True
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
