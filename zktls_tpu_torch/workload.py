"""The machines that chip_smoke.py and profile_prove.py drive.

* `sha_machine`: the one-chip Sha256Air machine — seeded messages hashed
  with result tags, their compressions as the chip's trace, and the public
  messages the verifier receives.
* `session_machine`: the twelve chips of the recorded TLS 1.2
  ECDHE(P-256)-RSA-AES128-GCM-SHA256 session in `data/`, built by
  `provers.stark.build_chip_instances` from the port's replay of the
  session's GuestInput, and its journal (the proof's binding;
  `StarkGuestProver.verify` derives the public messages from it).

The session is a loopback recording whose self-signed certificate anchors
to no root of the store, so it is replayed with
`require_trust_anchor=False`.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .guest.crypto.sha256 import SHA256Recorder
from .stark.bus import BUS_SHA_RESULT, digest_limbs
from .stark.chips.sha256 import Sha256Air, sha256_trace
from .stark.machine import ChipInstance

__all__ = ["sha_machine", "SESSION_GUEST_INPUT", "session_machine"]

#: the recorded session's GuestInput (scripts/record_session_c02f_p256.py)
SESSION_GUEST_INPUT = (Path(__file__).resolve().parent / "data"
                       / "session_c02f_p256.guest_input.cbor")


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


def session_machine() -> tuple[list[ChipInstance], bytes]:
    """(the session's chip instances, its journal): the port's `run_guest`
    of the committed GuestInput, the chain not required to anchor."""
    from .core.types import GuestInput
    from .guest.program import run_guest
    from .provers.stark import build_chip_instances

    out = run_guest(GuestInput.from_cbor(SESSION_GUEST_INPUT.read_bytes()),
                    require_trust_anchor=False)
    return build_chip_instances(out), out.journal
