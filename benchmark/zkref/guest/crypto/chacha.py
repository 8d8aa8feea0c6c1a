"""ChaCha20-Poly1305 AEAD (RFC 8439).

Covers the cca8/cca9 TLS 1.2 suites and TLS_CHACHA20_POLY1305_SHA256 (0x1303)
that the recorded client offers (SURVEY.md §2.3 lists the full offered set) —
sessions that negotiate them decrypt through here.

Witness recording (round 4): each record decryption can emit a
`ChaChaEvent` carrying the keystream blocks and the Poly1305 one-time key
for the ChaCha20 block AIR chip (stark/chips/chacha.py), and the Poly1305
accumulator multiplications are recorded as ModMulEvents over 2^130 − 5
so the existing ModMul width-class chip proves the tag polynomial.

Port copy of zktls_tpu.guest.crypto.chacha (same names and values).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

__all__ = ["ChaCha20Poly1305", "chacha20_block", "ChaChaEvent", "P1305"]

P1305 = (1 << 130) - 5


@dataclass
class ChaChaEvent:
    """One decrypted ChaCha20-Poly1305 record: the chip workload."""

    key: bytes                    # 32-byte session key
    nonce: bytes                  # 12 bytes
    otk: bytes                    # Poly1305 key = block(ctr=0)[:32]
    tag: bytes
    ciphertext: bytes
    plaintext: bytes
    keystream: list = field(default_factory=list)   # blocks ctr=1..


def _rotl(x: int, n: int) -> int:
    return ((x << n) | (x >> (32 - n))) & 0xFFFFFFFF


def _quarter(s: list[int], a: int, b: int, c: int, d: int) -> None:
    s[a] = (s[a] + s[b]) & 0xFFFFFFFF
    s[d] = _rotl(s[d] ^ s[a], 16)
    s[c] = (s[c] + s[d]) & 0xFFFFFFFF
    s[b] = _rotl(s[b] ^ s[c], 12)
    s[a] = (s[a] + s[b]) & 0xFFFFFFFF
    s[d] = _rotl(s[d] ^ s[a], 8)
    s[c] = (s[c] + s[d]) & 0xFFFFFFFF
    s[b] = _rotl(s[b] ^ s[c], 7)


def chacha20_block(key: bytes, counter: int, nonce: bytes) -> bytes:
    state = [
        0x61707865, 0x3320646E, 0x79622D32, 0x6B206574,
        *struct.unpack("<8I", key),
        counter,
        *struct.unpack("<3I", nonce),
    ]
    work = list(state)
    for _ in range(10):
        _quarter(work, 0, 4, 8, 12)
        _quarter(work, 1, 5, 9, 13)
        _quarter(work, 2, 6, 10, 14)
        _quarter(work, 3, 7, 11, 15)
        _quarter(work, 0, 5, 10, 15)
        _quarter(work, 1, 6, 11, 12)
        _quarter(work, 2, 7, 8, 13)
        _quarter(work, 3, 4, 9, 14)
    return struct.pack("<16I", *((w + s) & 0xFFFFFFFF for w, s in zip(work, state)))


def _chacha20(key: bytes, counter: int, nonce: bytes, data: bytes) -> bytes:
    out = bytearray()
    for i in range(0, len(data), 64):
        ks = chacha20_block(key, counter + i // 64, nonce)
        chunk = data[i : i + 64]
        out += bytes(c ^ k for c, k in zip(chunk, ks))
    return bytes(out)


def _poly1305(key: bytes, msg: bytes) -> bytes:
    from .modmul import mulmod

    r = int.from_bytes(key[:16], "little") & 0x0FFFFFFC0FFFFFFC0FFFFFFC0FFFFFFF
    s = int.from_bytes(key[16:], "little")
    acc = 0
    for i in range(0, len(msg), 16):
        blk = msg[i : i + 16]
        n = int.from_bytes(blk + b"\x01", "little")
        # each accumulator step is a recorded mulmod over 2^130 − 5, so
        # the ModMul chip proves the tag polynomial's multiplications
        acc = mulmod(acc + n, r, P1305)
    return ((acc + s) & ((1 << 128) - 1)).to_bytes(16, "little")


class ChaCha20Poly1305:
    def __init__(self, key: bytes):
        if len(key) != 32:
            raise ValueError("key must be 32 bytes")
        self.key = bytes(key)

    def _tag(self, nonce: bytes, aad: bytes, ct: bytes) -> bytes:
        otk = chacha20_block(self.key, 0, nonce)[:32]

        def pad(b: bytes) -> bytes:
            return b + b"\x00" * (-len(b) % 16)

        mac_data = pad(aad) + pad(ct) + struct.pack("<QQ", len(aad), len(ct))
        return _poly1305(otk, mac_data)

    def decrypt(self, nonce: bytes, ciphertext_and_tag: bytes, aad: bytes,
                events: list | None = None) -> bytes:
        if len(ciphertext_and_tag) < 16:
            raise ValueError("ciphertext too short for Poly1305 tag")
        ct, tag = ciphertext_and_tag[:-16], ciphertext_and_tag[-16:]
        if self._tag(nonce, aad, ct) != tag:
            raise ValueError("Poly1305 tag mismatch")
        pt = _chacha20(self.key, 1, nonce, ct)
        if events is not None:
            ks = [chacha20_block(self.key, 1 + i, nonce)
                  for i in range((len(ct) + 63) // 64)]
            events.append(ChaChaEvent(
                key=self.key, nonce=bytes(nonce),
                otk=chacha20_block(self.key, 0, nonce)[:32], tag=tag,
                ciphertext=ct, plaintext=pt, keystream=ks))
        return pt

    def encrypt(self, nonce: bytes, plaintext: bytes, aad: bytes) -> bytes:
        ct = _chacha20(self.key, 1, nonce, plaintext)
        return ct + self._tag(nonce, aad, ct)
