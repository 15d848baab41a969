"""Body streaming helpers: the part of minio_tpu/utils/streams.py the
erasure data path and multipart call (reader detection, batch chunking,
the single-part and multipart ETags)."""

from __future__ import annotations

import hashlib


def is_reader(x) -> bool:
    """Anything with .read(n) that is not already bytes-like."""
    return (not isinstance(x, (bytes, bytearray, memoryview))
            and hasattr(x, "read"))


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
