"""The machines that chip_smoke.py and profile_prove.py drive.

* `sha_machine`: the one-chip Sha256Air machine — seeded messages hashed
  with result tags, their compressions as the chip's trace, and the public
  messages the verifier receives.
* `session_machine(name)`: the chips of one recorded TLS session in
  `data/` (`SESSIONS`), built by `provers.stark.build_chip_instances` from
  the port's replay of the session's GuestInput, and its journal (the
  proof's binding; `StarkGuestProver.verify` derives the public messages
  from it).

Each session is a loopback recording (scripts/record_session_c02f_p256.py
--suite ...) with a 512-byte JSON body of which 10 bytes are filtered,
whose self-signed certificate anchors to no root of the store, so it is
replayed with `require_trust_anchor=False`.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

from .guest.crypto.sha256 import SHA256Recorder
from .stark.bus import BUS_SHA_RESULT, digest_limbs
from .stark.chips.sha256 import Sha256Air, sha256_trace
from .stark.machine import ChipInstance

__all__ = ["sha_machine", "Session", "SESSIONS", "SESSION_GUEST_INPUT",
           "session_machine"]

DATA = Path(__file__).resolve().parent / "data"


@dataclass(frozen=True)
class Session:
    """A committed recording and what its replay must give."""

    #: the recorded GuestInput
    guest_input: Path
    #: the negotiated cipher suite
    suite: int
    #: the certificate report at the recording's pinned time: one
    #: self-signed certificate, so no store anchor; root_spki_sha256 is
    #: then the SHA-256 of the leaf's own SubjectPublicKeyInfo
    chain: dict
    journal_bytes: int
    #: (chip name, rows, columns) in build order
    chips: tuple


def _chain(leaf_spki_sha256: str) -> dict:
    return {"hostname_match": True, "validity": True, "signatures": True,
            "anchored": False, "root_spki_sha256": leaf_spki_sha256}


#: the committed sessions by name
SESSIONS = {
    # TLS 1.2 ECDHE(P-256)-RSA-AES128-GCM-SHA256
    "c02f": Session(
        DATA / "session_c02f_p256.guest_input.cbor", 0xC02F,
        _chain("90b0c5f1760d339a3d12a1abf60ccd08"
               "760d542d1c38259654c95efb485ed45c"), 1056,
        (("Sha256Air", 16384, 639), ("Aes128Air", 1024, 851),
         ("GhashAir", 8192, 779), ("GcmControlAir", 64, 303),
         ("StreamParserAir", 4096, 141), ("GcmDataAir", 1024, 39),
         ("XorTableAir", 256, 1), ("KeccakAir", 1024, 1999),
         ("EcScheduleAir", 256, 1302), ("KeyScheduleAir", 64, 181),
         ("ModMul256Air", 8192, 324), ("ModMulRsa2048Air", 256, 3832))),
    # TLS 1.3 TLS_AES_256_GCM_SHA384 over x25519: what a default OpenSSL
    # server picks from the recorder's default suite list
    "1302": Session(
        DATA / "session_1302_x25519.guest_input.cbor", 0x1302,
        _chain("1cc0643548c5b494d8b9d13ec473935e"
               "4b9a8345060410801201b8adbc53c7ef"), 1248,
        (("Sha256Air", 8192, 639), ("Sha512Air", 32768, 1186),
         ("Aes256Air", 4096, 987), ("GhashAir", 32768, 779),
         ("GcmControlAir", 256, 303), ("StreamParserAir", 4096, 141),
         ("GcmDataAir", 4096, 39), ("XorTableAir", 256, 1),
         ("KeccakAir", 1024, 1999), ("ModMul256Air", 8192, 324),
         ("ModMulRsa2048Air", 256, 3832))),
    # TLS 1.3 TLS_CHACHA20_POLY1305_SHA256 over x25519
    "1303": Session(
        DATA / "session_1303_x25519.guest_input.cbor", 0x1303,
        _chain("5ab5cb5d9d2f8aafd1815390c0479326"
               "c0ecb0a10c2ebc0f63f8c6e0c115419f"), 1248,
        (("Sha256Air", 16384, 639), ("ChaChaControlAir", 256, 317),
         ("StreamParserAir", 4096, 141), ("ChaChaDataAir", 4096, 39),
         ("XorTableAir", 256, 1), ("KeccakAir", 1024, 1999),
         ("ChaCha20Air", 2048, 1147), ("ModMul256Air", 8192, 324),
         ("ModMulRsa2048Air", 256, 3832))),
}

#: the first recorded session's GuestInput
SESSION_GUEST_INPUT = SESSIONS["c02f"].guest_input


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


def session_machine(name: str = "c02f"
                    ) -> tuple[list[ChipInstance], bytes]:
    """(the session's chip instances, its journal): the port's `run_guest`
    of the committed GuestInput, the chain not required to anchor."""
    from .core.types import GuestInput
    from .guest.program import run_guest
    from .provers.stark import build_chip_instances

    gi = GuestInput.from_cbor(SESSIONS[name].guest_input.read_bytes())
    out = run_guest(gi, require_trust_anchor=False)
    return build_chip_instances(out), out.journal
