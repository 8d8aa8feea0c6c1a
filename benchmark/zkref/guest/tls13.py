"""TLS 1.3 (RFC 8446) key schedule and record protection, shared by the
recording client and the replaying guest.

The recorded ClientHello offers TLS 1.3 (supported_versions + x25519
key_share, SURVEY.md §2.3), so sessions against modern servers negotiate
1.3; the reference guest's rustls replays them the same way it replays 1.2.
All hashing runs through the witness-recording SHA-256.

Port copy of zktls_tpu.guest.tls13 (same names and values).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .crypto.gcm import AESGCM, GCMEvent
from .crypto.chacha import ChaCha20Poly1305
from .crypto.prf import hkdf_expand_label, hkdf_extract, hmac_sha256
from .crypto.sha256 import SHA256Recorder
from .tls import CipherSuite, ContentType, Record

__all__ = ["Tls13KeySchedule", "Tls13RecordCrypto", "strip_inner_plaintext"]


@dataclass
class Tls13KeySchedule:
    """The HKDF schedule over the suite's hash (SHA-256 or SHA-384);
    secrets exposed for witness generation.  SHA-384 suites hash through
    the SHA-512 recorder so their compressions reach the SHA-512 chip."""

    suite: CipherSuite
    rec: SHA256Recorder | None = None
    rec512: object | None = None   # SHA512Recorder for SHA-384 suites
    early_secret: bytes = b""
    handshake_secret: bytes = b""
    master_secret: bytes = b""
    client_hs_secret: bytes = b""
    server_hs_secret: bytes = b""
    client_app_secret: bytes = b""
    server_app_secret: bytes = b""
    secrets_log: dict = field(default_factory=dict)

    @property
    def hash_len(self) -> int:
        return 48 if self.suite.hash == "sha384" else 32

    def _hmac(self):
        if self.suite.hash == "sha384":
            from .crypto.prf import hmac_sha384

            return lambda k, m: hmac_sha384(k, m, self.rec512)
        return lambda k, m: hmac_sha256(k, m, self.rec)

    def _empty_hash(self) -> bytes:
        import hashlib

        return (hashlib.sha384(b"").digest() if self.suite.hash == "sha384"
                else hashlib.sha256(b"").digest())

    def _expand_label(self, secret, label, context, out_len) -> bytes:
        return hkdf_expand_label(secret, label, context, out_len,
                                 hmac_fn=self._hmac())

    def start(self, shared_secret: bytes) -> None:
        hl = self.hash_len
        zeros = b"\x00" * hl
        self.early_secret = hkdf_extract(zeros, zeros, hmac_fn=self._hmac(),
                                         hash_len=hl)
        derived = self._expand_label(self.early_secret, b"derived",
                                     self._empty_hash(), hl)
        self.handshake_secret = hkdf_extract(derived, shared_secret,
                                             hmac_fn=self._hmac(),
                                             hash_len=hl)

    def handshake_traffic(self, transcript_hash: bytes) -> None:
        hl = self.hash_len
        self.client_hs_secret = self._expand_label(
            self.handshake_secret, b"c hs traffic", transcript_hash, hl)
        self.server_hs_secret = self._expand_label(
            self.handshake_secret, b"s hs traffic", transcript_hash, hl)
        self.secrets_log["c_hs"] = self.client_hs_secret
        self.secrets_log["s_hs"] = self.server_hs_secret

    def application_traffic(self, transcript_hash: bytes) -> None:
        hl = self.hash_len
        derived = self._expand_label(self.handshake_secret, b"derived",
                                     self._empty_hash(), hl)
        self.master_secret = hkdf_extract(derived, b"\x00" * hl,
                                          hmac_fn=self._hmac(), hash_len=hl)
        self.client_app_secret = self._expand_label(
            self.master_secret, b"c ap traffic", transcript_hash, hl)
        self.server_app_secret = self._expand_label(
            self.master_secret, b"s ap traffic", transcript_hash, hl)
        self.secrets_log["c_ap"] = self.client_app_secret
        self.secrets_log["s_ap"] = self.server_app_secret

    def finished_verify(self, base_secret: bytes, transcript_hash: bytes
                        ) -> bytes:
        fk = self._expand_label(base_secret, b"finished", b"",
                                self.hash_len)
        return self._hmac()(fk, transcript_hash)


class Tls13RecordCrypto:
    """Per-direction record protection: key/iv from a traffic secret,
    nonce = iv XOR seq (RFC 8446 §5.3)."""

    def __init__(self, suite: CipherSuite, secret: bytes,
                 rec: SHA256Recorder | None = None, rec512=None):
        self.suite = suite
        if suite.hash == "sha384":
            from .crypto.prf import hmac_sha384

            hmac_fn = lambda k, m: hmac_sha384(k, m, rec512)  # noqa: E731
        else:
            hmac_fn = lambda k, m: hmac_sha256(k, m, rec)  # noqa: E731
        self.key = hkdf_expand_label(secret, b"key", b"", suite.key_len,
                                     hmac_fn=hmac_fn)
        self.iv = hkdf_expand_label(secret, b"iv", b"", 12, hmac_fn=hmac_fn)
        self.aead = (AESGCM(self.key) if suite.aead == "aes-gcm"
                     else ChaCha20Poly1305(self.key))
        self.seq = 0

    def _nonce(self) -> bytes:
        return bytes(a ^ b for a, b in zip(self.iv,
                                           self.seq.to_bytes(12, "big")))

    def decrypt(self, record: Record,
                events: list[GCMEvent] | None = None,
                chacha_events: list | None = None) -> bytes:
        aad = bytes([record.typ]) + record.version + \
            len(record.payload).to_bytes(2, "big")
        nonce = self._nonce()
        if isinstance(self.aead, AESGCM):
            out = self.aead.decrypt(nonce, record.payload, aad, events)
        else:
            out = self.aead.decrypt(nonce, record.payload, aad,
                                    chacha_events)
        self.seq += 1
        return out

    def encrypt(self, inner_plaintext: bytes) -> bytes:
        total = len(inner_plaintext) + 16
        aad = bytes([ContentType.APPLICATION_DATA]) + b"\x03\x03" + \
            total.to_bytes(2, "big")
        out = self.aead.encrypt(self._nonce(), inner_plaintext, aad)
        self.seq += 1
        return out


def strip_inner_plaintext(plaintext: bytes) -> tuple[int, bytes]:
    """TLSInnerPlaintext: content ‖ type ‖ zero-padding — returns
    (content_type, content)."""
    i = len(plaintext) - 1
    while i >= 0 and plaintext[i] == 0:
        i -= 1
    if i < 0:
        raise ValueError("all-padding TLS 1.3 record")
    return plaintext[i], plaintext[:i]
