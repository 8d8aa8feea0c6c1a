"""Minimal CBOR codec, bit-exact with ciborium's encoding of the reference's
serde data model (port copy of zktls_tpu.core.cbor).

The reference serializes `GuestInput` with ciborium
(crates/guest-prover-sp1/src/sp1.rs:106-111, crates/guest-prover-r0/src/prover.rs:81-86).
Conventions observed by decoding the golden fixture
crates/guest-prover-sp1/testdata/guest_input0.cbor (13,217 bytes):

  * Rust structs    -> definite-length maps with text keys, in field
                       declaration order.
  * externally-tagged enums -> map {variant_name: payload}.
  * `Vec<u8>`       -> CBOR *array of uints* (serde's default Vec serialize).
  * `serde_bytes` / alloy `Bytes`/`FixedBytes` -> CBOR byte string.
  * integers        -> minimal-length argument encoding (canonical).

Only the subset the data model needs is implemented: uint, nint, bytes,
text, array, map, bool, null.  Everything is definite-length.
"""

from __future__ import annotations

import struct
from typing import Any

__all__ = ["dumps", "loads", "Tagged"]


class Tagged:
    """A CBOR tag wrapper (rarely needed; kept for completeness)."""

    __slots__ = ("tag", "value")

    def __init__(self, tag: int, value: Any):
        self.tag = tag
        self.value = value

    def __eq__(self, other):
        return (
            isinstance(other, Tagged)
            and self.tag == other.tag
            and self.value == other.value
        )

    def __repr__(self):
        return f"Tagged({self.tag}, {self.value!r})"


# ---------------------------------------------------------------------------
# encoding
# ---------------------------------------------------------------------------


def _head(out: bytearray, major: int, arg: int) -> None:
    """Write a major-type head with minimal-length argument (canonical)."""
    mt = major << 5
    if arg < 24:
        out.append(mt | arg)
    elif arg < 0x100:
        out.append(mt | 24)
        out.append(arg)
    elif arg < 0x10000:
        out.append(mt | 25)
        out += struct.pack(">H", arg)
    elif arg < 0x100000000:
        out.append(mt | 26)
        out += struct.pack(">I", arg)
    else:
        out.append(mt | 27)
        out += struct.pack(">Q", arg)


def _encode(out: bytearray, obj: Any) -> None:
    if obj is None:
        out.append(0xF6)
    elif obj is True:
        out.append(0xF5)
    elif obj is False:
        out.append(0xF4)
    elif isinstance(obj, int):
        if obj >= 0:
            _head(out, 0, obj)
        else:
            _head(out, 1, -1 - obj)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        _head(out, 2, len(b))
        out += b
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _head(out, 3, len(b))
        out += b
    elif isinstance(obj, (list, tuple)):
        _head(out, 4, len(obj))
        for item in obj:
            _encode(out, item)
    elif isinstance(obj, dict):
        _head(out, 5, len(obj))
        for k, v in obj.items():  # insertion order == struct field order
            _encode(out, k)
            _encode(out, v)
    elif isinstance(obj, Tagged):
        _head(out, 6, obj.tag)
        _encode(out, obj.value)
    else:
        raise TypeError(f"cannot CBOR-encode {type(obj)!r}")


def dumps(obj: Any) -> bytes:
    out = bytearray()
    _encode(out, obj)
    return bytes(out)


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------


class _Reader:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated CBOR")
        b = self.data[self.pos : self.pos + n]
        self.pos += n
        return b

    def head(self) -> tuple[int, int]:
        b = self.take(1)[0]
        major, info = b >> 5, b & 0x1F
        if info < 24:
            return major, info
        if info == 24:
            return major, self.take(1)[0]
        if info == 25:
            return major, struct.unpack(">H", self.take(2))[0]
        if info == 26:
            return major, struct.unpack(">I", self.take(4))[0]
        if info == 27:
            return major, struct.unpack(">Q", self.take(8))[0]
        raise ValueError(f"unsupported CBOR additional-info {info}")


def _decode(r: _Reader) -> Any:
    major, arg = r.head()
    if major == 0:
        return arg
    if major == 1:
        return -1 - arg
    if major == 2:
        return r.take(arg)
    if major == 3:
        return r.take(arg).decode("utf-8")
    if major == 4:
        return [_decode(r) for _ in range(arg)]
    if major == 5:
        out = {}
        for _ in range(arg):
            k = _decode(r)
            out[k] = _decode(r)
        return out
    if major == 6:
        return Tagged(arg, _decode(r))
    if major == 7:
        if arg == 20:
            return False
        if arg == 21:
            return True
        if arg == 22:
            return None
        raise ValueError(f"unsupported simple value {arg}")
    raise ValueError(f"unsupported major type {major}")


def loads(data: bytes) -> Any:
    r = _Reader(data)
    obj = _decode(r)
    if r.pos != len(data):
        raise ValueError(f"trailing bytes after CBOR value ({len(data) - r.pos})")
    return obj
