"""Carry objects across from the reference package into the port's, without
importing the reference.

The `*_from_reference` functions are duck-typed: they read only the
attributes named below, so they take zktls_tpu's objects (or anything shaped
like them).  A recorded session needs no converting: both packages read
the same GuestInput CBOR bytes with their own `GuestInput.from_cbor`.
"""

from __future__ import annotations

import numpy as np

from .guest.crypto.sha256 import CompressionEvent
from .stark.chips import AIRS
from .stark.machine import ChipInstance

__all__ = ["chip_instance_from_reference", "events_from_reference"]


def chip_instance_from_reference(inst) -> ChipInstance:
    """A reference ChipInstance -> the port's: the AIR is looked up by
    `inst.air.name` in the port's registry; `trace`, `publics` and
    `preprocessed` are copied."""
    name = inst.air.name
    if name not in AIRS:
        raise KeyError(f"chip {name!r} is not ported")
    pre = inst.preprocessed
    return ChipInstance(
        air=AIRS[name](),
        trace=np.array(inst.trace, dtype=np.uint32),
        publics=[int(v) for v in inst.publics],
        preprocessed=None if pre is None else np.array(pre,
                                                       dtype=np.uint32))


def events_from_reference(events) -> list[CompressionEvent]:
    """Reference SHA-256 CompressionEvents -> the port's."""
    return [CompressionEvent(
        block=bytes(e.block), state_in=tuple(e.state_in),
        state_out=tuple(e.state_out), obj=e.obj, seq=e.seq,
        result_tag=e.result_tag, expose_block=e.expose_block)
        for e in events]
