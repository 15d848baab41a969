"""The KMS half that seals persisted secrets: the tier's remote credentials.

The port's copy of the parts of minio_tpu/crypto/kms.py and
minio_tpu/crypto/sse.py that bucket/tier.py uses: a single-key KMS
(`StaticKMS`, the reference's internal/kms/single-key.go) that hands out
AES-256-GCM data keys sealed under the master key in
MTPU_KMS_SECRET_KEY, and the sealed-document format of a config blob
(`seal_with_kms` / `unseal_with_kms`, framed as the JAX `sse.seal`: an
8-byte nonce base, then 64 KiB packets of 4-byte length + ciphertext and
tag, the last packet's counter flagged).  The bytes are the JAX
package's, so either package unseals the other's tier config.

Object SSE (SSE-S3, SSE-KMS, SSE-C), named keys and the KMS admin API
wait for ROADMAP.md Queue A item 10.3.
"""

from __future__ import annotations

import hashlib
import hmac
import os
import secrets
import struct

try:
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM
except ImportError:                       # optional: the server boots
    AESGCM = None                         # without it, sealing errors

#: plaintext bytes per sealed packet (the JAX sse.PACKET_SIZE)
PACKET_SIZE = 64 * 1024


class KMSError(Exception):
    pass


def _require_aesgcm() -> None:
    if AESGCM is None:
        raise KMSError("sealing unavailable: the 'cryptography' package "
                       "is not installed")


class StaticKMS:
    """Master key held in memory, by default from MTPU_KMS_SECRET_KEY
    (64 hex digits).  A data key sealed under another key id (a JAX
    named key) unseals with that id's derived key, HMAC(master, id)."""

    def __init__(self, master_key: bytes | None = None,
                 key_id: str = "mtpu-default-key"):
        if master_key is None:
            env = os.environ.get("MTPU_KMS_SECRET_KEY", "")
            if not env:
                raise KMSError(
                    "no KMS master key configured "
                    "(set MTPU_KMS_SECRET_KEY to 32 hex-encoded bytes)")
            try:
                master_key = bytes.fromhex(env)
            except ValueError:
                raise KMSError("MTPU_KMS_SECRET_KEY is not valid hex "
                               "(need 32 hex-encoded bytes)") from None
        if len(master_key) != 32:
            raise KMSError("master key must be 32 bytes")
        if master_key == b"\x00" * 32:
            raise KMSError("refusing all-zero KMS master key")
        self._master = master_key
        self.key_id = key_id

    def _key_for(self, key_id: str) -> bytes:
        if key_id == self.key_id:
            return self._master
        return hmac.new(self._master, b"mtpu-kms-key:" + key_id.encode(),
                        hashlib.sha256).digest()

    def generate_data_key(self, context: bytes = b""):
        """-> (key id, plaintext data key, sealed data key)."""
        _require_aesgcm()
        plaintext = secrets.token_bytes(32)
        nonce = secrets.token_bytes(12)
        sealed = nonce + AESGCM(self._key_for(self.key_id)).encrypt(
            nonce, plaintext, context)
        return self.key_id, plaintext, sealed

    def decrypt_data_key(self, key_id: str, sealed: bytes,
                         context: bytes = b"") -> bytes:
        _require_aesgcm()
        try:
            return AESGCM(self._key_for(key_id)).decrypt(
                sealed[:12], sealed[12:], context)
        except Exception as e:  # noqa: BLE001
            raise KMSError(f"unseal failed: {e}") from None


def _nonce(base: bytes, seq: int, final: bool) -> bytes:
    # 4-byte packet counter, its top bit marking the last packet (no
    # truncation goes unseen), then the 8 random base bytes.
    return struct.pack(">I", seq | (0x80000000 if final else 0)) + base


def seal(data: bytes, key: bytes) -> bytes:
    _require_aesgcm()
    aes = AESGCM(key)
    base = secrets.token_bytes(8)
    out = bytearray(base)
    n_packets = max(1, -(-len(data) // PACKET_SIZE))
    for i in range(n_packets):
        chunk = data[i * PACKET_SIZE:(i + 1) * PACKET_SIZE]
        ct = aes.encrypt(_nonce(base, i, i == n_packets - 1), chunk, b"")
        out += struct.pack(">I", len(ct)) + ct
    return bytes(out)


def unseal(blob: bytes, key: bytes) -> bytes:
    _require_aesgcm()
    aes = AESGCM(key)
    if len(blob) < 8:
        raise KMSError("ciphertext too short")
    base, pos, seq = blob[:8], 8, 0
    out = bytearray()
    while pos < len(blob):
        if pos + 4 > len(blob):
            raise KMSError("truncated packet header")
        (clen,) = struct.unpack(">I", blob[pos:pos + 4])
        pos += 4
        ct = blob[pos:pos + clen]
        if len(ct) != clen:
            raise KMSError("truncated packet")
        pos += clen
        try:
            out += aes.decrypt(_nonce(base, seq, pos >= len(blob)), ct, b"")
        except Exception:  # noqa: BLE001
            raise KMSError("decryption failed (wrong key or corrupt "
                           "data)") from None
        seq += 1
    return bytes(out)


def seal_with_kms(kms: StaticKMS, plaintext: bytes,
                  context: bytes = b"") -> dict:
    """Seal a config blob under a fresh data key -> a JSON-able doc."""
    key_id, pk, sealed_key = kms.generate_data_key(context)
    return {"v": 2, "keyId": key_id, "sealedKey": sealed_key.hex(),
            "ciphertext": seal(plaintext, pk).hex()}


def unseal_with_kms(kms: StaticKMS, doc: dict,
                    context: bytes = b"") -> bytes:
    pk = kms.decrypt_data_key(doc["keyId"],
                              bytes.fromhex(doc["sealedKey"]), context)
    return unseal(bytes.fromhex(doc["ciphertext"]), pk)


def is_sealed_doc(doc) -> bool:
    return (isinstance(doc, dict) and doc.get("v") == 2
            and "ciphertext" in doc and "sealedKey" in doc)


def kms_from_env() -> StaticKMS | None:
    """A keyed KMS when the environment gives a master key, else None
    (then nothing carrying credentials is persisted)."""
    if not os.environ.get("MTPU_KMS_SECRET_KEY", ""):
        return None
    return StaticKMS()
