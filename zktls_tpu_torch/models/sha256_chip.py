"""Guest-witness → SHA-256 chip bridge (the transcript-hash workload of
SURVEY.md §3.4).  Builds the machine ChipInstance proving every SHA-256
compression the guest performed, chained over the global bus
(stark/chips/sha256.py).

Port copy of zktls_tpu.models.sha256_chip (same names and values; host code
in numpy)."""

from __future__ import annotations

from ..guest.crypto.sha256 import CompressionEvent
from ..stark.chips.sha256 import Sha256Air, sha256_trace
from ..stark.machine import ChipInstance

__all__ = ["sha256_instance", "sha256_air"]

_AIR = Sha256Air()


def sha256_air() -> Sha256Air:
    return _AIR


def sha256_instance(events: list[CompressionEvent],
                    hop_counts: dict | None = None) -> ChipInstance:
    """The SHA-256 chip's machine instance: every compression the guest
    performed, with obj/seq chaining metadata and tagged result digests
    (journal hash, stream-tape hash) published on the bus.  hop_counts
    routes BUS_SHA_HOP consumption from the key-schedule chip."""
    trace, publics = sha256_trace(events, hop_counts=hop_counts)
    return ChipInstance(air=_AIR, trace=trace, publics=publics)
