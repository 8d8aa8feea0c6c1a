"""SHA-256, implemented from the FIPS 180-4 spec with full intermediate-state
exposure (port copy of zktls_tpu.guest.crypto.sha256).

The guest's transcript hashing, PRF/HKDF and HMAC all bottom out in SHA-256
compressions (reference guest workload, SURVEY.md §3.4).  The STARK's SHA-256
AIR chip proves exactly these compressions, so the witness generator must be
able to enumerate every (block, state_in, state_out) triple — which hashlib
cannot do.  `hashlib.sha256` is used in tests as the cross-check oracle.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

__all__ = ["SHA256", "sha256", "CompressionEvent", "SHA256Recorder"]

_K = [
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
]

_IV = (
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
)

_M32 = 0xFFFFFFFF


def _rotr(x: int, n: int) -> int:
    return ((x >> n) | (x << (32 - n))) & _M32


@dataclass
class CompressionEvent:
    """One SHA-256 compression: the unit of work the SHA-256 AIR chip proves.

    (obj, seq) places the compression in its hash object's chain: obj is
    assigned per fresh-from-IV hash object, seq is the depth along the
    chain; `copy()` branches share (obj, seq), so the events of one object
    form a tree rooted at the IV.  The AIR chip's bus argument
    (stark/bus.py BUS_SHA_STATE) consumes exactly this structure: a
    compression with seq > 0 receives (obj, seq, state_in) and every
    compression sends (obj, seq+1, state_out) once per consumer, which
    grounds every digest in a chain starting at the IV — the machine
    equivalent of the chaining the reference guest gets for free from
    sequential execution (SURVEY.md §3.4).

    result_tag ≠ 0 marks a digest the proof publishes on the bus
    (BUS_SHA_RESULT) for the verifier to consume — e.g. the journal digest.
    """

    block: bytes              # 64-byte message block
    state_in: tuple[int, ...]  # 8 x u32
    state_out: tuple[int, ...]
    obj: int = 0
    seq: int = 0
    result_tag: int = 0
    #: 1 ⇒ the SHA chip sends this compression's message block on the bus
    #: (BUS_SHA_BLOCK) for the stream-parser chip to consume
    expose_block: int = 0


class SHA256Recorder:
    """Collects every compression performed by SHA256 objects created
    through it — the bridge from guest replay to AIR trace generation."""

    def __init__(self) -> None:
        self.events: list[CompressionEvent] = []
        # ids below 4096 are reserved for deterministic stream-tape hash
        # objects (session i in a batch uses obj = i+1; the verifier's
        # filtered-byte messages carry these ids)
        self._next_obj = 4096

    def new(self, data: bytes = b"") -> "SHA256":
        return SHA256(data, recorder=self)

    def sha256(self, data: bytes, result_tag: int = 0,
               expose_blocks: bool = False, obj: int | None = None) -> bytes:
        """One-shot digest, optionally published with a result tag.
        expose_blocks marks every compression of this hash object for
        block publication (the stream-parser binding); obj pins the hash
        object id (the parser/verifier use deterministic stream ids)."""
        h = SHA256(recorder=self)
        if obj is not None:
            h._obj = obj
        if expose_blocks:
            h._expose = 1
        h.update(data)
        return h.digest(result_tag=result_tag)

    def _assign_obj(self) -> int:
        obj = self._next_obj
        self._next_obj += 1
        return obj


def compress(state: tuple[int, ...], block: bytes) -> tuple[int, ...]:
    w = list(struct.unpack(">16I", block))
    for t in range(16, 64):
        s0 = _rotr(w[t - 15], 7) ^ _rotr(w[t - 15], 18) ^ (w[t - 15] >> 3)
        s1 = _rotr(w[t - 2], 17) ^ _rotr(w[t - 2], 19) ^ (w[t - 2] >> 10)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & _M32)
    a, b, c, d, e, f, g, h = state
    for t in range(64):
        S1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ (~e & g)
        t1 = (h + S1 + ch + _K[t] + w[t]) & _M32
        S0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        t2 = (S0 + maj) & _M32
        a, b, c, d, e, f, g, h = (t1 + t2) & _M32, a, b, c, (d + t1) & _M32, e, f, g
    return tuple((x + y) & _M32 for x, y in zip(state, (a, b, c, d, e, f, g, h)))


class SHA256:
    digest_size = 32
    block_size = 64

    def __init__(self, data: bytes = b"", recorder: SHA256Recorder | None = None):
        self._state: tuple[int, ...] = _IV
        self._buf = b""
        self._length = 0
        self._recorder = recorder
        self._obj = recorder._assign_obj() if recorder is not None else 0
        self._seq = 0
        self._expose = 0
        if data:
            self.update(data)

    def copy(self) -> "SHA256":
        h = SHA256(recorder=self._recorder)
        h._state = self._state
        h._buf = self._buf
        h._length = self._length
        h._obj = self._obj
        h._seq = self._seq
        h._expose = self._expose
        return h

    def _compress(self, block: bytes) -> None:
        out = compress(self._state, block)
        if self._recorder is not None:
            self._recorder.events.append(
                CompressionEvent(block=block, state_in=self._state,
                                 state_out=out, obj=self._obj,
                                 seq=self._seq,
                                 expose_block=self._expose)
            )
        self._state = out
        self._seq += 1

    def update(self, data: bytes) -> "SHA256":
        self._length += len(data)
        buf = self._buf + bytes(data)
        n = len(buf) // 64
        for i in range(n):
            self._compress(buf[i * 64 : (i + 1) * 64])
        self._buf = buf[n * 64 :]
        return self

    def digest(self, result_tag: int = 0) -> bytes:
        h = self.copy()
        bit_len = h._length * 8
        pad = b"\x80" + b"\x00" * ((-h._length - 9) % 64) + struct.pack(">Q", bit_len)
        h.update(pad)
        assert not h._buf
        if result_tag and self._recorder is not None:
            # the last appended event is this digest's final compression
            # (execution is single-threaded within a recording context)
            self._recorder.events[-1].result_tag = result_tag
        return b"".join(struct.pack(">I", x) for x in h._state)

    def hexdigest(self) -> str:
        return self.digest().hex()


def sha256(data: bytes, recorder: SHA256Recorder | None = None) -> bytes:
    return SHA256(data, recorder=recorder).digest()
