"""RSA signature verification: PKCS#1 v1.5 (RFC 8017 §8.2) and RSASSA-PSS
(§8.1), SHA-256/384/512 variants.

The guest verifies the server's ServerKeyExchange signature and the X.509
certificate-chain signatures (the fixture's chain is RSA-signed,
cipher 0xc02f = ECDHE-*RSA*-AES128-GCM-SHA256).  Verification is a single
modexp over the public exponent plus deterministic padding checks — the
exact computation the RSA AIR chip proves.

Port copy of zktls_tpu.guest.crypto.rsa (same names and values).
"""

from __future__ import annotations

import hashlib

from .modmul import powmod

__all__ = ["rsa_pkcs1v15_verify", "rsa_pss_verify"]

_DIGEST_INFO = {
    "sha256": bytes.fromhex("3031300d060960864801650304020105000420"),
    "sha384": bytes.fromhex("3041300d060960864801650304020205000430"),
    "sha512": bytes.fromhex("3051300d060960864801650304020305000440"),
}


def _emsa_pkcs1v15(hash_name: str, msg_hash: bytes, em_len: int) -> bytes:
    t = _DIGEST_INFO[hash_name] + msg_hash
    if em_len < len(t) + 11:
        raise ValueError("intended encoded message length too short")
    return b"\x00\x01" + b"\xff" * (em_len - len(t) - 3) + b"\x00" + t


def rsa_pkcs1v15_verify(n: int, e: int, hash_name: str, msg_hash: bytes,
                        signature: bytes) -> bool:
    k = (n.bit_length() + 7) // 8
    if len(signature) != k:
        return False
    s = int.from_bytes(signature, "big")
    if s >= n:
        return False
    em = powmod(s, e, n).to_bytes(k, "big")
    return em == _emsa_pkcs1v15(hash_name, msg_hash, k)


def _mgf1(seed: bytes, mask_len: int, hash_name: str) -> bytes:
    h = getattr(hashlib, hash_name)
    out = b""
    for i in range((mask_len + h().digest_size - 1) // h().digest_size):
        out += h(seed + i.to_bytes(4, "big")).digest()
    return out[:mask_len]


def rsa_pss_verify(n: int, e: int, hash_name: str, msg_hash: bytes,
                   signature: bytes, salt_len: int | None = None) -> bool:
    """RSASSA-PSS verify; salt_len defaults to the digest size (TLS 1.3 /
    rustls convention)."""
    h_len = len(msg_hash)
    if salt_len is None:
        salt_len = h_len
    k = (n.bit_length() + 7) // 8
    if len(signature) != k:
        return False
    s = int.from_bytes(signature, "big")
    if s >= n:
        return False
    em_bits = n.bit_length() - 1
    em_len = (em_bits + 7) // 8
    em = powmod(s, e, n).to_bytes(k, "big")[-em_len:]
    if em[-1] != 0xBC:
        return False
    db_len = em_len - h_len - 1
    masked_db, h = em[:db_len], em[db_len:-1]
    # leftmost 8*em_len - em_bits bits of masked_db must be zero
    top_bits = 8 * em_len - em_bits
    if top_bits and masked_db[0] >> (8 - top_bits):
        return False
    db = bytes(a ^ b for a, b in zip(masked_db, _mgf1(h, db_len, hash_name)))
    if top_bits:
        db = bytes([db[0] & (0xFF >> top_bits)]) + db[1:]
    ps_len = db_len - salt_len - 1
    if db[:ps_len] != b"\x00" * ps_len or db[ps_len] != 0x01:
        return False
    salt = db[ps_len + 1 :]
    m_prime = b"\x00" * 8 + msg_hash + salt
    return getattr(hashlib, hash_name)(m_prime).digest() == h
