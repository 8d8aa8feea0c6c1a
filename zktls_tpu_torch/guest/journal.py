"""Journal (public values) decoding: the on-chain-consumable binding of
the proven TLS session, as the verifier reads it.

Port copy of the decoding half of zktls_tpu.guest.journal (same names and
values).  The journal is a Solidity ABI encoding (JOURNAL_VERSION 2):
version, request and response keccak hashes, server name, pinned time,
target and origin fields, the trust anchor's SPKI digest, the filtered
response ranges and contents, the stream tape's SHA-256 and the GCM record
headers.  `encode_journal` comes with the guest replay, which is not
ported yet.
"""

from __future__ import annotations

__all__ = ["JOURNAL_VERSION", "decode_journal"]

JOURNAL_VERSION = 2


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
