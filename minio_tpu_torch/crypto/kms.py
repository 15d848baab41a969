"""KMS: the key-encryption-key service behind a narrow interface.

The port of minio_tpu/crypto/kms.py (the internal/kms role): a KMS hands
out (key id, plaintext, sealed) data keys and unseals them later.
`StaticKMS` seals with a master key held in memory, by default from
MTPU_KMS_SECRET_KEY (the reference's single-key KMS,
internal/kms/single-key.go); named keys are derived from it,
HMAC(master, "mtpu-kms-key:" + id), so there is no key state to
replicate.  crypto/kes.py's `KESKMS` speaks the same interface to an
external key server.  The sealed data-key format (12-byte nonce, then
the AES-256-GCM ciphertext and tag) and the sealed-document format of a
config blob (`seal_with_kms`, framed as crypto/sse.py's `seal`) are the
JAX package's: either package unwraps the other's data keys and unseals
the other's tier config.
"""

from __future__ import annotations

import hashlib
import hmac
import os
import secrets

try:
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM
except ImportError:                       # optional: the server boots
    AESGCM = None                         # without it, sealing errors


class KMSError(Exception):
    pass


def _require_aesgcm() -> None:
    if AESGCM is None:
        raise KMSError("SSE unavailable: the 'cryptography' package "
                       "is not installed")


class KMS:
    """Interface: generate_data_key() -> (key_id, plaintext, sealed);
    decrypt_data_key(key_id, sealed, context) -> plaintext."""

    def generate_data_key(self, context: bytes = b""):
        raise NotImplementedError

    def decrypt_data_key(self, key_id: str, sealed: bytes,
                         context: bytes = b"") -> bytes:
        raise NotImplementedError


class StaticKMS(KMS):
    """Master key held in memory, by default from MTPU_KMS_SECRET_KEY
    (64 hex digits)."""

    def __init__(self, master_key: bytes | None = None,
                 key_id: str = "mtpu-default-key"):
        if master_key is None:
            env = os.environ.get("MTPU_KMS_SECRET_KEY", "")
            if not env:
                # No well-known fallback key: the reference refuses to
                # serve SSE without a configured key
                # (internal/kms/single-key.go ParseSecretKey).
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
        # The default key is the master itself (what was sealed before
        # named keys existed); a created key is derived from it.
        self._created: set[str] = {key_id}

    def _key_for(self, key_id: str, for_decrypt: bool = False) -> bytes:
        if key_id == self.key_id:
            return self._master
        if key_id not in self._created and not for_decrypt:
            # Sealing and the status probe need a created key (a typo'd
            # id must not probe healthy); unsealing derives for any id,
            # since the created set lives in memory and a restart must
            # not strand what was sealed.
            raise KMSError(f"unknown key id {key_id!r}")
        return hmac.new(self._master, b"mtpu-kms-key:" + key_id.encode(),
                        hashlib.sha256).digest()

    # -- admin surface (cf. KMSCreateKey/KMSKeyStatus admin handlers) --------

    def create_key(self, key_id: str) -> None:
        if not key_id or "/" in key_id:
            raise KMSError(f"invalid key id {key_id!r}")
        self._created.add(key_id)

    def list_keys(self) -> list[str]:
        return sorted(self._created)

    def key_status(self, key_id: str) -> dict:
        """Round-trip health probe: seal and unseal under the key (what
        the reference's KMSKeyStatusHandler does)."""
        return _key_status(self, key_id)

    def generate_data_key(self, context: bytes = b"",
                          key_id: str | None = None):
        """-> (key id, plaintext data key, sealed data key)."""
        key_id = key_id or self.key_id
        _require_aesgcm()
        plaintext = secrets.token_bytes(32)
        nonce = secrets.token_bytes(12)
        sealed = nonce + AESGCM(self._key_for(key_id)).encrypt(
            nonce, plaintext, context)
        return key_id, plaintext, sealed

    def decrypt_data_key(self, key_id: str, sealed: bytes,
                         context: bytes = b"") -> bytes:
        _require_aesgcm()
        try:
            return AESGCM(self._key_for(key_id, for_decrypt=True)).decrypt(
                sealed[:12], sealed[12:], context)
        except Exception as e:  # noqa: BLE001
            raise KMSError(f"unseal failed: {e}") from None


def _key_status(kms: KMS, key_id: str) -> dict:
    try:
        kid, plaintext, sealed = kms.generate_data_key(
            b"status-probe", key_id=key_id)
        ok = kms.decrypt_data_key(kid, sealed, b"status-probe") == plaintext
        return {"keyId": key_id, "encryptionErr": "",
                "decryptionErr": "" if ok else "round-trip mismatch"}
    except KMSError as e:
        return {"keyId": key_id, "encryptionErr": str(e),
                "decryptionErr": ""}


def seal_with_kms(kms: KMS, plaintext: bytes,
                  context: bytes = b"") -> dict:
    """Seal a config blob under a fresh data key -> a JSON-able doc (one
    sealing format for every subsystem that persists secrets)."""
    from .sse import seal
    key_id, pk, sealed_key = kms.generate_data_key(context)
    return {"v": 2, "keyId": key_id, "sealedKey": sealed_key.hex(),
            "ciphertext": seal(plaintext, pk).hex()}


def unseal_with_kms(kms: KMS, doc: dict, context: bytes = b"") -> bytes:
    """Inverse of seal_with_kms; raises KMSError or SSEError."""
    from .sse import unseal
    pk = kms.decrypt_data_key(doc["keyId"],
                              bytes.fromhex(doc["sealedKey"]), context)
    return unseal(bytes.fromhex(doc["ciphertext"]), pk)


def is_sealed_doc(doc) -> bool:
    return (isinstance(doc, dict) and doc.get("v") == 2
            and "ciphertext" in doc and "sealedKey" in doc)


def kms_from_env() -> StaticKMS | None:
    """A keyed KMS when the environment gives a master key, else None:
    callers then refuse SSE-S3 and SSE-KMS requests instead of sealing
    under a known key, and persist nothing that carries credentials."""
    if not os.environ.get("MTPU_KMS_SECRET_KEY", ""):
        return None
    return StaticKMS()
