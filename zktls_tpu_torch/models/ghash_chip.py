"""Guest-witness → GHASH chip bridge (SURVEY.md §3.4; together with the
AES-128 and GCM-control chips this covers the AES-GCM record-protection
workload).  Builds the machine ChipInstance proving the GF(2^128)
authentication polynomial of every recorded GCM decryption; the bus binds
each event's h and mask to the control chip and publishes
tag = S ⊕ E_K(J0).

Port copy of zktls_tpu.models.ghash_chip (same names and values; host code
in numpy)."""

from __future__ import annotations

from ..guest.crypto.gcm import GCMEvent
from ..stark.chips.gcm_control import GcmControlAir, gcm_control_trace
from ..stark.chips.ghash import GhashAir, gcm_event_ghash, ghash_trace
from ..stark.machine import ChipInstance

__all__ = ["ghash_instance", "ghash_air", "gcm_control_instance",
           "gcm_control_air"]

_AIR = GhashAir()
_CTRL_AIR = GcmControlAir()


def ghash_air() -> GhashAir:
    return _AIR


def gcm_control_air() -> GcmControlAir:
    return _CTRL_AIR


def ghash_instance(events: list[GCMEvent]) -> ChipInstance:
    gh_events = []
    for eid, ev in enumerate(events):
        h, blocks = gcm_event_ghash(ev)
        gh_events.append((eid, h, blocks, int.from_bytes(ev.j0_mask, "big")))
    trace, publics = ghash_trace(gh_events)
    return ChipInstance(air=_AIR, trace=trace, publics=publics)


def gcm_control_instance(events: list[GCMEvent], metas=None,
                         v13: bool = False) -> ChipInstance:
    trace, publics = gcm_control_trace(events, metas=metas, v13=v13)
    return ChipInstance(air=_CTRL_AIR, trace=trace, publics=publics)
