"""AES-GCM (NIST SP 800-38D) with keystream/GHASH witness exposure.

TLS 1.2/1.3 record protection for the 0xc02f/0xc02b/0x1301-family suites
(the fixture session negotiates ECDHE-RSA-AES128-GCM-SHA256, SURVEY.md §2.3).
Decryption events are recorded so the AES-GCM AIR chip can prove the exact
counter-mode keystream and GHASH tag computation.

Port copy of zktls_tpu.guest.crypto.gcm (same names and values; host code in
numpy).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .aes import AES

__all__ = ["AESGCM", "GCMEvent"]


def _ghash_mul(x: int, h: int) -> int:
    """GF(2^128) carryless multiply, GCM bit order (x^128+x^7+x^2+x+1)."""
    z = 0
    v = h
    for i in range(127, -1, -1):
        if (x >> i) & 1:
            z ^= v
        if v & 1:
            v = (v >> 1) ^ (0xE1 << 120)
        else:
            v >>= 1
    return z


@dataclass
class GCMEvent:
    """One authenticated decryption: witness unit for the AES-GCM chip."""

    key: bytes
    nonce: bytes
    aad: bytes
    ciphertext: bytes
    plaintext: bytes
    tag: bytes
    counter_blocks: list[bytes] = field(default_factory=list)  # CTR inputs
    keystream: list[bytes] = field(default_factory=list)       # E_K(counter)
    h_block: bytes = b""     # E_K(0^16): the GHASH key H
    j0_mask: bytes = b""     # E_K(J0): the tag whitening block


class AESGCM:
    def __init__(self, key: bytes):
        self.aes = AES(key)
        self.key = bytes(key)
        self.h = int.from_bytes(self.aes.encrypt_block(b"\x00" * 16), "big")

    def _ghash(self, aad: bytes, ct: bytes) -> int:
        def blocks(data: bytes):
            for i in range(0, len(data), 16):
                yield data[i : i + 16].ljust(16, b"\x00")

        y = 0
        for blk in blocks(aad):
            y = _ghash_mul(y ^ int.from_bytes(blk, "big"), self.h)
        for blk in blocks(ct):
            y = _ghash_mul(y ^ int.from_bytes(blk, "big"), self.h)
        lens = (len(aad) * 8).to_bytes(8, "big") + (len(ct) * 8).to_bytes(8, "big")
        return _ghash_mul(y ^ int.from_bytes(lens, "big"), self.h)

    def _ctr(self, nonce: bytes, n_blocks: int, event: GCMEvent | None):
        if len(nonce) != 12:
            raise ValueError("GCM nonce must be 12 bytes (TLS always is)")
        for i in range(n_blocks):
            cb = nonce + (i + 2).to_bytes(4, "big")  # J0 = nonce||1; data from 2
            ks = self.aes.encrypt_block(cb)
            if event is not None:
                event.counter_blocks.append(cb)
                event.keystream.append(ks)
            yield ks

    def decrypt(
        self, nonce: bytes, ciphertext_and_tag: bytes, aad: bytes,
        events: list[GCMEvent] | None = None,
    ) -> bytes:
        if len(ciphertext_and_tag) < 16:
            raise ValueError("ciphertext too short for GCM tag")
        ct, tag = ciphertext_and_tag[:-16], ciphertext_and_tag[-16:]
        s = self._ghash(aad, ct)
        j0 = nonce + b"\x00\x00\x00\x01"
        mask = self.aes.encrypt_block(j0)
        expect = (s ^ int.from_bytes(mask, "big")).to_bytes(16, "big")
        if expect != tag:
            raise ValueError("GCM tag mismatch")
        event = (GCMEvent(self.key, nonce, aad, ct, b"", tag,
                          h_block=self.h.to_bytes(16, "big"), j0_mask=mask)
                 if events is not None else None)
        out = bytearray()
        n_blocks = (len(ct) + 15) // 16
        for i, ks in enumerate(self._ctr(nonce, n_blocks, event)):
            chunk = ct[i * 16 : (i + 1) * 16]
            out += bytes(c ^ k for c, k in zip(chunk, ks))
        if event is not None:
            event.plaintext = bytes(out)
            events.append(event)
        return bytes(out)

    def encrypt(self, nonce: bytes, plaintext: bytes, aad: bytes) -> bytes:
        ct = bytearray()
        n_blocks = (len(plaintext) + 15) // 16
        for i, ks in enumerate(self._ctr(nonce, n_blocks, None)):
            chunk = plaintext[i * 16 : (i + 1) * 16]
            ct += bytes(p ^ k for p, k in zip(chunk, ks))
        s = self._ghash(aad, bytes(ct))
        j0 = nonce + b"\x00\x00\x00\x01"
        tag = (s ^ int.from_bytes(self.aes.encrypt_block(j0), "big")).to_bytes(16, "big")
        return bytes(ct) + tag
