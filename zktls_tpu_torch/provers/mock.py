"""Mock prover: executes the real guest and returns the real journal with an
empty proof — the reference's key testing mechanism
(`--mock`: RISC0_DEV_MODE / SP1_PROVER=mock, SURVEY.md §4 "dev-mode provers
execute the real guest and produce real journals with fake proofs",
crates/guest-prover-r0/src/prover.rs:22, guest-prover-sp1/src/sp1.rs:23).

Port copy of zktls_tpu.provers.mock (same names and values).
"""

from __future__ import annotations

from ..core.types import GuestInput
from ..guest.program import run_guest

__all__ = ["MockProver"]


class MockProver:
    """ZkProver returning (journal, b"") after full guest execution."""

    def prove(self, guest_input: GuestInput) -> tuple[bytes, bytes]:
        out = run_guest(guest_input)
        return out.journal, b""
