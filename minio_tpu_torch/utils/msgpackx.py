"""Copy of minio_tpu/utils/msgpackx.py: the port keeps its own, so that it imports
nothing of the JAX package.

Minimal self-contained MessagePack codec.

The reference serializes xl.meta and every RPC datatype with tinylib/msgp
(reference cmd/xl-storage-format-v2.go, cmd/storage-datatypes.go).
SURVEY.md §2.12 notes the wire format is ours to choose — we keep msgpack
(compact, binary-safe inline data, self-describing) but implement the subset
we need in ~200 lines rather than depending on an external package: nil,
bool, int/uint (all widths), float64, str, bin, array, map.

Encoding choices: dict keys are encoded in insertion order; ints use the
smallest encoding; bytes always use bin formats (never str).
"""

from __future__ import annotations

import struct


class MsgpackError(ValueError):
    pass


def packb(obj) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


# The C extension, when present, is wire-identical for our subset and
# ~20x faster — xl.meta pack/unpack sits on the per-drive PUT/GET hot
# path (the reference generates msgp codecs for the same reason). The
# pure-Python codec above stays as the portable fallback and the
# format's executable spec.
try:
    import msgpack as _cmsgpack

    def packb(obj) -> bytes:  # noqa: F811
        try:
            return _cmsgpack.packb(obj, use_bin_type=True)
        except Exception as e:  # noqa: BLE001
            raise MsgpackError(str(e)) from None

    def _c_unpackb(data):
        try:
            return _cmsgpack.unpackb(
                bytes(data), raw=False, strict_map_key=False)
        except Exception as e:  # noqa: BLE001
            raise MsgpackError(str(e)) from None
except ImportError:
    _cmsgpack = None
    _c_unpackb = None


def _pack(obj, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        n = len(b)
        if n < 32:
            out.append(0xA0 | n)
        elif n < 0x100:
            out += bytes((0xD9, n))
        elif n < 0x10000:
            out.append(0xDA)
            out += struct.pack(">H", n)
        else:
            out.append(0xDB)
            out += struct.pack(">I", n)
        out += b
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        n = len(b)
        if n < 0x100:
            out += bytes((0xC4, n))
        elif n < 0x10000:
            out.append(0xC5)
            out += struct.pack(">H", n)
        else:
            out.append(0xC6)
            out += struct.pack(">I", n)
        out += b
    elif isinstance(obj, (list, tuple)):
        n = len(obj)
        if n < 16:
            out.append(0x90 | n)
        elif n < 0x10000:
            out.append(0xDC)
            out += struct.pack(">H", n)
        else:
            out.append(0xDD)
            out += struct.pack(">I", n)
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        n = len(obj)
        if n < 16:
            out.append(0x80 | n)
        elif n < 0x10000:
            out.append(0xDE)
            out += struct.pack(">H", n)
        else:
            out.append(0xDF)
            out += struct.pack(">I", n)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise MsgpackError(f"cannot pack type {type(obj).__name__}")


def _pack_int(v: int, out: bytearray) -> None:
    if 0 <= v < 0x80:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif 0 <= v:
        if v < 0x100:
            out += bytes((0xCC, v))
        elif v < 0x10000:
            out.append(0xCD)
            out += struct.pack(">H", v)
        elif v < 0x100000000:
            out.append(0xCE)
            out += struct.pack(">I", v)
        elif v < 0x10000000000000000:
            out.append(0xCF)
            out += struct.pack(">Q", v)
        else:
            raise MsgpackError("int too large")
    else:
        if v >= -0x80:
            out.append(0xD0)
            out += struct.pack(">b", v)
        elif v >= -0x8000:
            out.append(0xD1)
            out += struct.pack(">h", v)
        elif v >= -0x80000000:
            out.append(0xD2)
            out += struct.pack(">i", v)
        elif v >= -0x8000000000000000:
            out.append(0xD3)
            out += struct.pack(">q", v)
        else:
            raise MsgpackError("int too small")


class _Unpacker:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def _take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise MsgpackError("truncated msgpack data")
        b = self.buf[self.pos:self.pos + n]
        self.pos += n
        return b

    def unpack(self):
        c = self._take(1)[0]
        if c < 0x80:
            return c
        if c >= 0xE0:
            return c - 0x100
        if 0x80 <= c <= 0x8F:
            return self._map(c & 0x0F)
        if 0x90 <= c <= 0x9F:
            return self._array(c & 0x0F)
        if 0xA0 <= c <= 0xBF:
            return self._take(c & 0x1F).decode("utf-8")
        if c == 0xC0:
            return None
        if c == 0xC2:
            return False
        if c == 0xC3:
            return True
        if c == 0xC4:
            return bytes(self._take(self._take(1)[0]))
        if c == 0xC5:
            return bytes(self._take(struct.unpack(">H", self._take(2))[0]))
        if c == 0xC6:
            return bytes(self._take(struct.unpack(">I", self._take(4))[0]))
        if c == 0xCA:
            return struct.unpack(">f", self._take(4))[0]
        if c == 0xCB:
            return struct.unpack(">d", self._take(8))[0]
        if c == 0xCC:
            return self._take(1)[0]
        if c == 0xCD:
            return struct.unpack(">H", self._take(2))[0]
        if c == 0xCE:
            return struct.unpack(">I", self._take(4))[0]
        if c == 0xCF:
            return struct.unpack(">Q", self._take(8))[0]
        if c == 0xD0:
            return struct.unpack(">b", self._take(1))[0]
        if c == 0xD1:
            return struct.unpack(">h", self._take(2))[0]
        if c == 0xD2:
            return struct.unpack(">i", self._take(4))[0]
        if c == 0xD3:
            return struct.unpack(">q", self._take(8))[0]
        if c == 0xD9:
            return self._take(self._take(1)[0]).decode("utf-8")
        if c == 0xDA:
            return self._take(struct.unpack(">H", self._take(2))[0]).decode("utf-8")
        if c == 0xDB:
            return self._take(struct.unpack(">I", self._take(4))[0]).decode("utf-8")
        if c == 0xDC:
            return self._array(struct.unpack(">H", self._take(2))[0])
        if c == 0xDD:
            return self._array(struct.unpack(">I", self._take(4))[0])
        if c == 0xDE:
            return self._map(struct.unpack(">H", self._take(2))[0])
        if c == 0xDF:
            return self._map(struct.unpack(">I", self._take(4))[0])
        raise MsgpackError(f"unsupported msgpack type byte 0x{c:02x}")

    def _array(self, n: int) -> list:
        return [self.unpack() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.unpack()
            out[k] = self.unpack()
        return out


def unpackb(buf: bytes):
    if _c_unpackb is not None:
        return _c_unpackb(buf)
    u = _Unpacker(bytes(buf))
    obj = u.unpack()
    if u.pos != len(u.buf):
        raise MsgpackError(f"trailing bytes after msgpack object "
                           f"({len(u.buf) - u.pos})")
    return obj


def unpackb_prefix(buf: bytes):
    """Decode one object, returning (obj, bytes_consumed) — for streams."""
    u = _Unpacker(bytes(buf))
    obj = u.unpack()
    return obj, u.pos
