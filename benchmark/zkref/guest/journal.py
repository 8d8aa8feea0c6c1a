"""Journal (public values) emission: the on-chain-consumable binding of the
proven TLS session.

The reference's exact journal ABI lives in the external zkvm-programs guest
(SURVEY.md §2.3 marks it [K]: recoverable only by running the released guest
ELF, which needs network).  This module therefore defines a *documented,
versioned* journal that binds the same facts the reference's does —
(request, filtered response data, server identity, target, origin) — as a
standard Solidity ABI encoding, so the exported EVM verifier can decode it
with `abi.decode`.  Layout (JOURNAL_VERSION 1):

  abi.encode(
    uint64  journal_version,
    bytes32 request_hash,        // keccak256(raw HTTP request bytes)
    bytes32 response_hash,       // keccak256(full plaintext response)
    string  server_name,         // certificate-verified SNI
    uint64  time,                // pinned unix clock used for cert validity
    address client,              // request.target
    bytes32 prover_id,
    uint64  submit_network_id,
    uint64  nonce,               // request.origin
    address origin_signer,       // recovered from the origin signature
    bytes32 root_spki_sha256,    // trust anchor fingerprint of the chain
    uint64[] filtered_begins,
    uint64[] filtered_lengths,
    bytes[]  filtered_contents,
    bytes32 stream_sha256,       // v2: digest of the full recorded stream
                                 //     tape, proven by the SHA-256 chip
    bytes   gcm_records,         // v2: per-record (eid, nonce, tag,
                                 //     n_blocks) headers the GCM control
                                 //     chip accounts against (32 B each)
  )

Version 2 extends version 1 with the two STARK-binding fields: the machine
proof's SHA-256 chip publishes stream_sha256 (and the digest of the journal
itself) on the global bus, and the GCM control chip consumes gcm_records —
so flipping any journal byte, record header, or proven crypto event breaks
verification (stark/machine.py).

Port copy of zktls_tpu.guest.journal (same names and values).
"""

from __future__ import annotations

from ..core.tape import parse_time
from ..core.types import GuestInput
from .crypto.keccak import keccak256

__all__ = ["JOURNAL_VERSION", "abi_encode", "encode_journal", "decode_journal"]

JOURNAL_VERSION = 2


# ---------------------------------------------------------------------------
# Minimal Solidity ABI encoder (the subset the journal needs)
# ---------------------------------------------------------------------------


def _enc_uint(v: int) -> bytes:
    return int(v).to_bytes(32, "big")


def _enc_bytes32(b: bytes) -> bytes:
    if len(b) != 32:
        raise ValueError("bytes32 must be 32 bytes")
    return bytes(b)


def _enc_address(b: bytes) -> bytes:
    if len(b) != 20:
        raise ValueError("address must be 20 bytes")
    return b"\x00" * 12 + bytes(b)


def _enc_dyn_bytes(b: bytes) -> bytes:
    out = _enc_uint(len(b)) + bytes(b)
    return out + b"\x00" * (-len(b) % 32)


def abi_encode(items: list[tuple[str, object]]) -> bytes:
    """Encode a flat tuple per the Solidity ABI head/tail scheme.
    Types: uint64/uint256, bytes32, address, string, bytes, uint64[],
    bytes[]."""
    heads: list[bytes | None] = []
    tails: list[bytes] = []
    for typ, val in items:
        if typ.startswith("uint") and not typ.endswith("]"):
            heads.append(_enc_uint(val)); tails.append(b"")
        elif typ == "bytes32":
            heads.append(_enc_bytes32(val)); tails.append(b"")
        elif typ == "address":
            heads.append(_enc_address(val)); tails.append(b"")
        elif typ in ("bytes", "string"):
            data = val.encode() if isinstance(val, str) else bytes(val)
            heads.append(None); tails.append(_enc_dyn_bytes(data))
        elif typ == "uint64[]":
            body = _enc_uint(len(val)) + b"".join(_enc_uint(x) for x in val)
            heads.append(None); tails.append(body)
        elif typ == "bytes[]":
            inner_heads = []
            inner_tails = []
            for b in val:
                inner_tails.append(_enc_dyn_bytes(bytes(b)))
            off = 32 * len(val)
            for t in inner_tails:
                inner_heads.append(_enc_uint(off))
                off += len(t)
            body = _enc_uint(len(val)) + b"".join(inner_heads) + b"".join(inner_tails)
            heads.append(None); tails.append(body)
        else:
            raise ValueError(f"unsupported ABI type {typ}")
    head_size = 32 * len(items)
    out_heads = b""
    out_tails = b""
    offset = head_size
    for h, t in zip(heads, tails):
        if h is not None:
            out_heads += h
        else:
            out_heads += _enc_uint(offset)
            out_tails += t
            offset += len(t)
    return out_heads + out_tails


# ---------------------------------------------------------------------------
# Journal
# ---------------------------------------------------------------------------


def encode_journal(guest_input: GuestInput, *, response_plaintext: bytes,
                   root_spki_sha256: bytes,
                   origin_signer: bytes = b"\x00" * 20,
                   stream_sha256: bytes = b"\x00" * 32,
                   gcm_records: bytes = b"") -> bytes:
    req = guest_input.request
    resp = guest_input.response
    sec, _nanos = parse_time(resp.time)
    target = req.target
    origin = req.origin
    return abi_encode([
        ("uint64", JOURNAL_VERSION),
        ("bytes32", keccak256(req.request_info.request)),
        ("bytes32", keccak256(response_plaintext)),
        ("string", req.request_info.server_name),
        ("uint64", sec),
        ("address", target.client if target else b"\x00" * 20),
        ("bytes32", target.prover_id if target else b"\x00" * 32),
        ("uint64", target.submit_network_id if target else 0),
        ("uint64", origin.nonce if origin else 0),
        ("address", origin_signer),
        ("bytes32", root_spki_sha256),
        ("uint64[]", list(resp.filtered_responses_begin)),
        ("uint64[]", list(resp.filtered_responses_length)),
        ("bytes[]", list(resp.filtered_responses)),
        ("bytes32", stream_sha256),
        ("bytes", gcm_records),
    ])


def decode_journal(journal: bytes) -> dict:
    """Decode the version-1 journal (verifier-side helper + tests)."""

    def word(i: int) -> bytes:
        return journal[32 * i : 32 * (i + 1)]

    def uint(i: int) -> int:
        return int.from_bytes(word(i), "big")

    def dyn(off: int) -> bytes:
        ln = int.from_bytes(journal[off : off + 32], "big")
        return journal[off + 32 : off + 32 + ln]

    def uint_array(off: int) -> list[int]:
        ln = int.from_bytes(journal[off : off + 32], "big")
        return [int.from_bytes(journal[off + 32 * (i + 1) : off + 32 * (i + 2)], "big")
                for i in range(ln)]

    def bytes_array(off: int) -> list[bytes]:
        ln = int.from_bytes(journal[off : off + 32], "big")
        out = []
        for i in range(ln):
            rel = int.from_bytes(
                journal[off + 32 * (i + 1) : off + 32 * (i + 2)], "big")
            out.append(dyn(off + 32 + rel))
        return out

    return {
        "journal_version": uint(0),
        "request_hash": word(1),
        "response_hash": word(2),
        "server_name": dyn(uint(3)).decode(),
        "time": uint(4),
        "client": word(5)[12:],
        "prover_id": word(6),
        "submit_network_id": uint(7),
        "nonce": uint(8),
        "origin_signer": word(9)[12:],
        "root_spki_sha256": word(10),
        "filtered_begins": uint_array(uint(11)),
        "filtered_lengths": uint_array(uint(12)),
        "filtered_contents": bytes_array(uint(13)),
        "stream_sha256": word(14),
        "gcm_records": dyn(uint(15)),
    }
