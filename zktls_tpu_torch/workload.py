"""The one-chip Sha256Air machine that chip_smoke.py and profile_prove.py
drive: seeded messages hashed with result tags, their compressions as the
chip's trace, and the public messages the verifier receives."""

from __future__ import annotations

import numpy as np

from .guest.crypto.sha256 import SHA256Recorder
from .stark.bus import BUS_SHA_RESULT, digest_limbs
from .stark.chips.sha256 import Sha256Air, sha256_trace
from .stark.machine import ChipInstance

__all__ = ["sha_machine"]


def sha_machine(count: int, size: int, seed: int
                ) -> tuple[ChipInstance, list[tuple]]:
    """`count` messages of `size` seeded random bytes, hashed with result
    tags 1..count: (the chip instance, the verifier's public messages).
    8 messages of 3,000 bytes give 384 compressions, a 32768 × 639
    trace."""
    rng = np.random.default_rng(seed)
    rec = SHA256Recorder()
    digests = [rec.sha256(rng.integers(0, 256, size, dtype=np.uint8)
                          .tobytes(), result_tag=i + 1) for i in range(count)]
    trace, publics = sha256_trace(rec.events)
    # payload layout of chips/sha256.py: (tag, 16 digest limbs, xb = 0)
    msgs = [(BUS_SHA_RESULT, [i + 1] + digest_limbs(d) + [0], -1)
            for i, d in enumerate(digests)]
    return ChipInstance(air=Sha256Air(), trace=trace, publics=publics), msgs
