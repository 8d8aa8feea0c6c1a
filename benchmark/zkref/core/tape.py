"""Replay-tape codecs: the (stream, random, time) triple that makes a
recorded TLS session deterministically replayable.

Reference behavior: the external `zktls-recordable-tls-provider` crate tees
every TCP byte with direction framing and logs every RNG draw
(consumed at crates/input-builder/src/request.rs:60-70).  Framing recovered
and cryptographically verified in SURVEY.md §2.3:

  stream := ( u8 direction ‖ u32_be length ‖ raw bytes )*
            direction 2 = client→server, 1 = server→client
  random := concatenation of RNG draws in draw order, unframed
  time   := decimal string "seconds.nanoseconds" (9-digit nanos)

Port copy of zktls_tpu.core.tape (same names and values; host code in
numpy).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

__all__ = [
    "DIR_SERVER_TO_CLIENT",
    "DIR_CLIENT_TO_SERVER",
    "StreamSegment",
    "decode_stream",
    "encode_stream",
    "stream_halves",
    "RandomTape",
    "parse_time",
    "format_time",
]

DIR_SERVER_TO_CLIENT = 1
DIR_CLIENT_TO_SERVER = 2


@dataclass
class StreamSegment:
    """One raw socket read/write.  Segments may split TLS records mid-record
    (verified: a 5,060-byte server flight spans 3 segments in the fixture)."""

    direction: int
    data: bytes


def decode_stream(tape: bytes) -> list[StreamSegment]:
    segments: list[StreamSegment] = []
    pos = 0
    n = len(tape)
    while pos < n:
        if pos + 5 > n:
            raise ValueError(f"truncated stream-tape header at {pos}")
        direction = tape[pos]
        if direction not in (DIR_SERVER_TO_CLIENT, DIR_CLIENT_TO_SERVER):
            raise ValueError(f"bad stream direction {direction} at {pos}")
        (length,) = struct.unpack_from(">I", tape, pos + 1)
        pos += 5
        if pos + length > n:
            raise ValueError(f"truncated stream-tape segment at {pos}")
        segments.append(StreamSegment(direction, tape[pos : pos + length]))
        pos += length
    return segments


def encode_stream(segments: list[StreamSegment]) -> bytes:
    out = bytearray()
    for seg in segments:
        out.append(seg.direction)
        out += struct.pack(">I", len(seg.data))
        out += seg.data
    return bytes(out)


def stream_halves(tape: bytes) -> tuple[bytes, bytes]:
    """Reassemble the tape into (client→server, server→client) byte streams."""
    c2s = bytearray()
    s2c = bytearray()
    for seg in decode_stream(tape):
        half = c2s if seg.direction == DIR_CLIENT_TO_SERVER else s2c
        half += seg.data
    return bytes(c2s), bytes(s2c)


class RandomTape:
    """Cursor over the recorded RNG draws.  Replaying this tape byte-for-byte
    makes the TLS client produce the identical ClientHello and key shares
    (verified in SURVEY.md §2.3: draw layout for the fixture is
    [0:32] x25519 key-share scalar, [32:64] legacy session_id,
    [64:96] client_random, [96:98] 2-byte draw, [98:130] P-256 ECDHE scalar)."""

    def __init__(self, data: bytes):
        self.data = bytes(data)
        self.pos = 0

    def draw(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError(
                f"random tape exhausted: need {n} at {self.pos}, have {len(self.data)}"
            )
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    @property
    def remaining(self) -> int:
        return len(self.data) - self.pos


def parse_time(s: str) -> tuple[int, int]:
    """'1731840085.800056000' -> (1731840085, 800056000)."""
    sec, _, nanos = s.partition(".")
    return int(sec), int(nanos or "0")


def format_time(sec: int, nanos: int) -> str:
    return f"{sec}.{nanos:09d}"
