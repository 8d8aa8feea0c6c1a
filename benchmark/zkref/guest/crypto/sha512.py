"""SHA-512 / SHA-384, implemented from the FIPS 180-4 spec with full
intermediate-state exposure (mirror of sha256.py for the 64-bit family).

SHA-384 suites (0xC030 ECDHE-RSA-AES256-GCM-SHA384, 0x1302
TLS13-AES256-GCM-SHA384 — offered by the reference client,
crates/input-builder/src/request.rs:25-27) hash their transcript, PRF and
HKDF through SHA-384 = truncated SHA-512 with a distinct IV.  The SHA-512
AIR chip (stark/chips/sha512.py) proves exactly the (block, state_in,
state_out) compression triples recorded here; hashlib is the test oracle.

Port copy of zktls_tpu.guest.crypto.sha512 (same names and values).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

__all__ = ["SHA512", "SHA384", "sha512", "sha384", "Compression512Event",
           "SHA512Recorder", "compress512"]

_K512 = [
    0x428A2F98D728AE22, 0x7137449123EF65CD, 0xB5C0FBCFEC4D3B2F,
    0xE9B5DBA58189DBBC, 0x3956C25BF348B538, 0x59F111F1B605D019,
    0x923F82A4AF194F9B, 0xAB1C5ED5DA6D8118, 0xD807AA98A3030242,
    0x12835B0145706FBE, 0x243185BE4EE4B28C, 0x550C7DC3D5FFB4E2,
    0x72BE5D74F27B896F, 0x80DEB1FE3B1696B1, 0x9BDC06A725C71235,
    0xC19BF174CF692694, 0xE49B69C19EF14AD2, 0xEFBE4786384F25E3,
    0x0FC19DC68B8CD5B5, 0x240CA1CC77AC9C65, 0x2DE92C6F592B0275,
    0x4A7484AA6EA6E483, 0x5CB0A9DCBD41FBD4, 0x76F988DA831153B5,
    0x983E5152EE66DFAB, 0xA831C66D2DB43210, 0xB00327C898FB213F,
    0xBF597FC7BEEF0EE4, 0xC6E00BF33DA88FC2, 0xD5A79147930AA725,
    0x06CA6351E003826F, 0x142929670A0E6E70, 0x27B70A8546D22FFC,
    0x2E1B21385C26C926, 0x4D2C6DFC5AC42AED, 0x53380D139D95B3DF,
    0x650A73548BAF63DE, 0x766A0ABB3C77B2A8, 0x81C2C92E47EDAEE6,
    0x92722C851482353B, 0xA2BFE8A14CF10364, 0xA81A664BBC423001,
    0xC24B8B70D0F89791, 0xC76C51A30654BE30, 0xD192E819D6EF5218,
    0xD69906245565A910, 0xF40E35855771202A, 0x106AA07032BBD1B8,
    0x19A4C116B8D2D0C8, 0x1E376C085141AB53, 0x2748774CDF8EEB99,
    0x34B0BCB5E19B48A8, 0x391C0CB3C5C95A63, 0x4ED8AA4AE3418ACB,
    0x5B9CCA4F7763E373, 0x682E6FF3D6B2B8A3, 0x748F82EE5DEFB2FC,
    0x78A5636F43172F60, 0x84C87814A1F0AB72, 0x8CC702081A6439EC,
    0x90BEFFFA23631E28, 0xA4506CEBDE82BDE9, 0xBEF9A3F7B2C67915,
    0xC67178F2E372532B, 0xCA273ECEEA26619C, 0xD186B8C721C0C207,
    0xEADA7DD6CDE0EB1E, 0xF57D4F7FEE6ED178, 0x06F067AA72176FBA,
    0x0A637DC5A2C898A6, 0x113F9804BEF90DAE, 0x1B710B35131C471B,
    0x28DB77F523047D84, 0x32CAAB7B40C72493, 0x3C9EBE0A15C9BEBC,
    0x431D67C49C100D4C, 0x4CC5D4BECB3E42B6, 0x597F299CFC657E2A,
    0x5FCB6FAB3AD6FAEC, 0x6C44198C4A475817,
]

_IV512 = (
    0x6A09E667F3BCC908, 0xBB67AE8584CAA73B, 0x3C6EF372FE94F82B,
    0xA54FF53A5F1D36F1, 0x510E527FADE682D1, 0x9B05688C2B3E6C1F,
    0x1F83D9ABFB41BD6B, 0x5BE0CD19137E2179,
)

_IV384 = (
    0xCBBB9D5DC1059ED8, 0x629A292A367CD507, 0x9159015A3070DD17,
    0x152FECD8F70E5939, 0x67332667FFC00B31, 0x8EB44A8768581511,
    0xDB0C2E0D64F98FA7, 0x47B5481DBEFA4FA4,
)

_M64 = (1 << 64) - 1


def _rotr(x: int, n: int) -> int:
    return ((x >> n) | (x << (64 - n))) & _M64


@dataclass
class Compression512Event:
    """One SHA-512 compression (chaining semantics identical to
    sha256.CompressionEvent — (obj, seq) chains rooted at an IV; iv384
    distinguishes the SHA-384 root from the SHA-512 one in-circuit)."""

    block: bytes               # 128-byte message block
    state_in: tuple[int, ...]  # 8 x u64
    state_out: tuple[int, ...]
    obj: int = 0
    seq: int = 0
    result_tag: int = 0
    iv384: int = 0             # chain root is the SHA-384 IV


class SHA512Recorder:
    """Collects every SHA-512-family compression (the guest replay carries
    one of these alongside the SHA-256 recorder for SHA-384 suites)."""

    def __init__(self) -> None:
        self.events: list[Compression512Event] = []
        self._next_obj = 1 << 20   # disjoint from SHA-256 object ids

    def new384(self, data: bytes = b"") -> "SHA384":
        return SHA384(data, recorder=self)

    def _assign_obj(self) -> int:
        obj = self._next_obj
        self._next_obj += 1
        return obj


def compress512(state: tuple[int, ...], block: bytes) -> tuple[int, ...]:
    w = list(struct.unpack(">16Q", block))
    for t in range(16, 80):
        s0 = _rotr(w[t - 15], 1) ^ _rotr(w[t - 15], 8) ^ (w[t - 15] >> 7)
        s1 = _rotr(w[t - 2], 19) ^ _rotr(w[t - 2], 61) ^ (w[t - 2] >> 6)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & _M64)
    a, b, c, d, e, f, g, h = state
    for t in range(80):
        S1 = _rotr(e, 14) ^ _rotr(e, 18) ^ _rotr(e, 41)
        ch = (e & f) ^ (~e & g)
        t1 = (h + S1 + ch + _K512[t] + w[t]) & _M64
        S0 = _rotr(a, 28) ^ _rotr(a, 34) ^ _rotr(a, 39)
        maj = (a & b) ^ (a & c) ^ (b & c)
        t2 = (S0 + maj) & _M64
        a, b, c, d, e, f, g, h = (
            (t1 + t2) & _M64, a, b, c, (d + t1) & _M64, e, f, g)
    return tuple((x + y) & _M64 for x, y in zip(state, (a, b, c, d, e, f, g, h)))


class SHA512:
    digest_size = 64
    block_size = 128
    _iv = _IV512
    _iv384_flag = 0

    def __init__(self, data: bytes = b"",
                 recorder: SHA512Recorder | None = None):
        self._state: tuple[int, ...] = self._iv
        self._buf = b""
        self._length = 0
        self._recorder = recorder
        self._obj = recorder._assign_obj() if recorder is not None else 0
        self._seq = 0
        if data:
            self.update(data)

    def copy(self):
        h = type(self)(recorder=self._recorder)
        h._state = self._state
        h._buf = self._buf
        h._length = self._length
        h._obj = self._obj
        h._seq = self._seq
        return h

    def _compress(self, block: bytes) -> None:
        out = compress512(self._state, block)
        if self._recorder is not None:
            self._recorder.events.append(Compression512Event(
                block=block, state_in=self._state, state_out=out,
                obj=self._obj, seq=self._seq, iv384=self._iv384_flag))
        self._state = out
        self._seq += 1

    def update(self, data: bytes) -> "SHA512":
        self._length += len(data)
        buf = self._buf + bytes(data)
        n = len(buf) // 128
        for i in range(n):
            self._compress(buf[i * 128 : (i + 1) * 128])
        self._buf = buf[n * 128 :]
        return self

    def digest(self, result_tag: int = 0) -> bytes:
        h = self.copy()
        bit_len = h._length * 8
        pad = (b"\x80" + b"\x00" * ((-h._length - 17) % 128)
               + bit_len.to_bytes(16, "big"))
        h.update(pad)
        assert not h._buf
        if result_tag and self._recorder is not None:
            self._recorder.events[-1].result_tag = result_tag
        out = b"".join(struct.pack(">Q", x) for x in h._state)
        return out[: self.digest_size]

    def hexdigest(self) -> str:
        return self.digest().hex()


class SHA384(SHA512):
    digest_size = 48
    _iv = _IV384
    _iv384_flag = 1


def sha512(data: bytes, recorder: SHA512Recorder | None = None) -> bytes:
    return SHA512(data, recorder=recorder).digest()


def sha384(data: bytes, recorder: SHA512Recorder | None = None) -> bytes:
    return SHA384(data, recorder=recorder).digest()
