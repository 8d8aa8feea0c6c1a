"""Core data model, codecs, tapes, and the two framework-wide interfaces.

Reference: core/src/prelude.rs:7-18 defines the two async traits the whole
system plugs into — `InputBuilder` (Request -> GuestInput) and `ZkProver`
(GuestInput + guest -> (journal, proof)).  Here they are Python protocols;
the guest is not an opaque RISC-V ELF but a replay program driven by the
framework (see zktls_tpu_torch.guest.program).

Port copy of zktls_tpu.core (same names and values).
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable

from .types import (  # noqa: F401
    FilteredResponse,
    GuestInput,
    GuestInputResponse,
    OffsetTemplate,
    PrefixTemplate,
    RegexTemplate,
    Request,
    RequestInfo,
    RequestOrigin,
    RequestTarget,
    ResponseTemplate,
)


@runtime_checkable
class InputBuilder(Protocol):
    """Builds a replayable GuestInput from a Request
    (reference: core/src/prelude.rs:7-9)."""

    def build_input(self, request: Request) -> GuestInput: ...


@runtime_checkable
class ZkProver(Protocol):
    """Proves a GuestInput, returning (journal/public-values, proof bytes)
    (reference: core/src/prelude.rs:12-18)."""

    def prove(self, guest_input: GuestInput) -> tuple[bytes, bytes]: ...
