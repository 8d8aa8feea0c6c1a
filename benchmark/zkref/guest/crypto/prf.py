"""TLS key-schedule primitives: HMAC, the TLS 1.2 PRF (RFC 5246 §5) and the
TLS 1.3 HKDF schedule (RFC 8446 §7.1 / RFC 5869).

The fixture session derives its master secret via the *extended* master
secret (RFC 7627 — extension 23 is present in the recorded ServerHello) and
its key block via the TLS 1.2 PRF; TLS 1.3 sessions use HKDF instead.
All hashing flows through the witness-recording SHA-256 so every compression
reaches the SHA-256 AIR chip.

Port copy of zktls_tpu.guest.crypto.prf (same names and values).
"""

from __future__ import annotations

import struct

from .sha256 import SHA256, SHA256Recorder

__all__ = ["hmac_sha256", "prf_sha256", "hmac_sha384", "prf_sha384",
           "hkdf_extract", "hkdf_expand", "hkdf_expand_label",
           "tls13_derive_secret"]


def hmac_sha256(key: bytes, msg: bytes, rec: SHA256Recorder | None = None) -> bytes:
    if len(key) > 64:
        key = SHA256(key, recorder=rec).digest()
    key = key.ljust(64, b"\x00")
    inner = SHA256(bytes(b ^ 0x36 for b in key), recorder=rec).update(msg).digest()
    return SHA256(bytes(b ^ 0x5C for b in key), recorder=rec).update(inner).digest()


def prf_sha256(secret: bytes, label: bytes, seed: bytes, out_len: int,
               rec: SHA256Recorder | None = None) -> bytes:
    """P_SHA256(secret, label ‖ seed) — RFC 5246 §5."""
    ls = label + seed
    out = b""
    a = ls
    while len(out) < out_len:
        a = hmac_sha256(secret, a, rec)
        out += hmac_sha256(secret, a + ls, rec)
    return out[:out_len]


def hmac_sha384(key: bytes, msg: bytes, rec=None) -> bytes:
    """HMAC-SHA-384 (block size 128) through the SHA-512 recorder — the
    SHA-384 suites' PRF/HKDF core (RFC 5246 §5, RFC 8446 §7.1)."""
    from .sha512 import SHA384

    if len(key) > 128:
        key = SHA384(key, recorder=rec).digest()
    key = key.ljust(128, b"\x00")
    inner = SHA384(bytes(b ^ 0x36 for b in key),
                   recorder=rec).update(msg).digest()
    return SHA384(bytes(b ^ 0x5C for b in key),
                  recorder=rec).update(inner).digest()


def prf_sha384(secret: bytes, label: bytes, seed: bytes, out_len: int,
               rec=None) -> bytes:
    """P_SHA384(secret, label ‖ seed) — RFC 5246 §5 for SHA-384 suites."""
    ls = label + seed
    out = b""
    a = ls
    while len(out) < out_len:
        a = hmac_sha384(secret, a, rec)
        out += hmac_sha384(secret, a + ls, rec)
    return out[:out_len]


# ---------------------------------------------------------------------------
# TLS 1.3 HKDF schedule
# ---------------------------------------------------------------------------


def hkdf_extract(salt: bytes, ikm: bytes, rec: SHA256Recorder | None = None,
                 hmac_fn=None, hash_len: int = 32) -> bytes:
    f = hmac_fn or (lambda k, m: hmac_sha256(k, m, rec))
    return f(salt or b"\x00" * hash_len, ikm)


def hkdf_expand(prk: bytes, info: bytes, out_len: int,
                rec: SHA256Recorder | None = None, hmac_fn=None) -> bytes:
    f = hmac_fn or (lambda k, m: hmac_sha256(k, m, rec))
    out = b""
    t = b""
    i = 1
    while len(out) < out_len:
        t = f(prk, t + info + bytes([i]))
        out += t
        i += 1
    return out[:out_len]


def hkdf_expand_label(secret: bytes, label: bytes, context: bytes, out_len: int,
                      rec: SHA256Recorder | None = None, hmac_fn=None) -> bytes:
    full = b"tls13 " + label
    info = struct.pack(">H", out_len) + bytes([len(full)]) + full + \
        bytes([len(context)]) + context
    return hkdf_expand(secret, info, out_len, rec, hmac_fn=hmac_fn)


def tls13_derive_secret(secret: bytes, label: bytes, transcript_hash: bytes,
                        rec: SHA256Recorder | None = None) -> bytes:
    return hkdf_expand_label(secret, label, transcript_hash, 32, rec)
