"""Guest-witness → AES-128 chip bridge (SURVEY.md §3.4 record-decryption
workload).  Builds the machine ChipInstance proving every AES block
encryption the guest's GCM decryptions performed — H = E_K(0), the tag
mask E_K(J0), and the CTR keystream — each published on the bus as
(AES_ENC, eid, key, input, output) for the GCM control chip.

Port copy of zktls_tpu.models.aes128_chip (same names and values; host code
in numpy)."""

from __future__ import annotations

from ..guest.crypto.gcm import GCMEvent
from ..stark.chips.aes128 import Aes128Air, aes128_trace
from ..stark.machine import ChipInstance
from ..utils.spans import span

__all__ = ["aes128_instance", "aes128_air"]

_AIR = Aes128Air()


def aes128_air() -> Aes128Air:
    return _AIR


def aes_event_blocks(events: list[GCMEvent]) -> list[tuple[int, bytes, bytes]]:
    """Every (eid, key, input_block) encryption of the recorded events."""
    blocks = []
    for eid, ev in enumerate(events):
        blocks.append((eid, ev.key, b"\x00" * 16))
        blocks.append((eid, ev.key, ev.nonce + b"\x00\x00\x00\x01"))
        for cb in ev.counter_blocks:
            blocks.append((eid, ev.key, cb))
    return blocks


def aes128_instance(events: list[GCMEvent]) -> ChipInstance:
    trace, publics = aes128_trace(aes_event_blocks(events))
    return ChipInstance(air=_AIR, trace=trace, publics=publics)


def aes_instances(events: list[GCMEvent]) -> list[ChipInstance]:
    """Route each GCM event to the AES chip matching its key size
    (AES-128 or AES-256 — SHA-384 suites use 32-byte keys); event ids
    stay the global enumeration, so the control chip's receives match
    regardless of which chip served the block.  Each chip's trace is
    built inside its own `zktls.build:<AirName>` span."""
    from ..stark.chips.aes256 import Aes256Air, aes256_trace

    blocks = aes_event_blocks(events)
    b128 = [b for b in blocks if len(b[1]) == 16]
    b256 = [b for b in blocks if len(b[1]) == 32]
    out = []
    if b128:
        with span("zktls.build:Aes128Air"):
            trace, publics = aes128_trace(b128)
        out.append(ChipInstance(air=_AIR, trace=trace, publics=publics))
    if b256:
        with span("zktls.build:Aes256Air"):
            trace, publics = aes256_trace(b256)
        out.append(ChipInstance(air=Aes256Air(), trace=trace,
                                publics=publics))
    return out
