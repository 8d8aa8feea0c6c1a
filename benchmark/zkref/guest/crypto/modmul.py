"""Modular-multiplication witness recording for the EC/bigint AIR chip.

The reference proves elliptic-curve arithmetic with bigint precompile
chips inside the zkVM (`sp1-curves` field ops + the bigint/ec precompile
chips, SURVEY.md §2.2.B).  Here the guest's big-int hot ops — every
modular multiplication and inversion performed by the EC group law, ECDSA
verification and origin recovery — are recorded as `ModMulEvent`s, and the
ModMul STARK chip (stark/chips/modmul.py) proves each one.

Inversions are recorded as a multiplication event `a · a⁻¹ ≡ 1 (mod m)`
— the standard witness trick: the prover supplies the inverse, the chip
proves the product is 1.

Recording is scoped with the `recording()` context manager (the guest
program wraps its whole execution); when inactive the helpers are plain
arithmetic with zero overhead beyond a branch.

Port copy of zktls_tpu.guest.crypto.modmul (same names and values; host code
in numpy).
"""

from __future__ import annotations

import contextvars
from contextlib import contextmanager
from dataclasses import dataclass

__all__ = ["ModMulEvent", "ModMulRecorder", "recording", "active_recorder",
           "mulmod", "invmod", "powmod"]


@dataclass(frozen=True)
class ModMulEvent:
    """One proven statement: a · b ≡ r (mod m), operands canonical."""

    a: int
    b: int
    r: int
    m: int


class ModMulRecorder:
    def __init__(self):
        self.events: list[ModMulEvent] = []

    def record(self, a: int, b: int, r: int, m: int) -> None:
        self.events.append(ModMulEvent(a, b, r, m))


# Context-local recorder: concurrent guest executions (e.g. the threading
# HTTP prover service handling parallel /v1/prove requests) each see only
# their own recorder — a module-level global would cross-contaminate event
# streams between sessions.
_active: contextvars.ContextVar[ModMulRecorder | None] = \
    contextvars.ContextVar("zktls_modmul_recorder", default=None)


def active_recorder() -> ModMulRecorder | None:
    return _active.get()


@contextmanager
def recording(rec: ModMulRecorder | None = None):
    """Activate a recorder for the dynamic extent (guest execution)."""
    if rec is None:
        rec = ModMulRecorder()
    token = _active.set(rec)
    try:
        yield rec
    finally:
        _active.reset(token)


def mulmod(a: int, b: int, m: int) -> int:
    """a·b mod m, recorded when a recorder is active."""
    a %= m
    b %= m
    r = a * b % m
    rec = _active.get()
    if rec is not None:
        rec.record(a, b, r, m)
    return r


def invmod(a: int, m: int) -> int:
    """a⁻¹ mod m, recorded as the event a·a⁻¹ ≡ 1."""
    a %= m
    inv = pow(a, -1, m)
    rec = _active.get()
    if rec is not None:
        rec.record(a, inv, 1, m)
    return inv


def powmod(base: int, exp: int, m: int) -> int:
    """base^exp mod m via square-and-multiply, each step recorded — the
    RSA-verification workload (one modexp per signature, e.g. e = 65537 →
    16 squarings + 1 multiplication at the 2048-bit width class)."""
    if exp < 0:
        raise ValueError("negative exponent")
    base %= m
    result = 1 % m
    started = False
    for bit in bin(exp)[2:]:
        if started:
            result = mulmod(result, result, m)
        if bit == "1":
            result = base if not started else mulmod(result, base, m)
            started = True
    return result
