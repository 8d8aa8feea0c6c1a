"""Global LogUp bus: the cross-chip glue of the machine STARK.

Port copy of the part of zktls_tpu.stark.bus that the SHA-256 chip and
the machine prover/verifier use (same names and values).  Every chip
interaction is a message sent (+) or received (−) on one global bus; the
machine proof exposes each chip's cumulative bus sum, and verification
checks

    Σ_chips bus_sum  −  Σ_public-receives 1/(γ − fp(msg))  ==  0

Message fingerprint: fp(tag, payload) = tag + Σ_i δ^{i+1} · payload_i.
"""

from __future__ import annotations

import numpy as np

from ..ops.field_ref import Fp4, P

__all__ = [
    "BUS_SHA_STATE", "BUS_SHA_RESULT", "BUS_SHA_BLOCK", "BUS_SHA_HOP",
    "MAX_PAYLOAD", "bus_fingerprint", "bus_term", "delta_powers",
    "digest_limbs", "np_bus_inverse_terms",
]

#: SHA-256 chaining: (obj, seq, state 16×u16)
BUS_SHA_STATE = 0x101
#: (result_tag, digest 16×u16, expose flag) — a tagged final compression
#: publishes its digest; the verifier receives it
BUS_SHA_RESULT = 0x102
#: (obj, seq, half, 16×u16) — one 32-byte half of a message block
BUS_SHA_BLOCK = 0x109
#: (in_state 16×u16, block 32×u16, out_state 16×u16) — one proven
#: compression as a value-level statement
BUS_SHA_HOP = 0x126

#: maximum payload length any message of the full machine uses; it fixes
#: the length of the machine challenge vector [γ, δ, δ², …, δ^MAX_PAYLOAD]
MAX_PAYLOAD = 73


def delta_powers(delta: Fp4, count: int = MAX_PAYLOAD) -> list[Fp4]:
    """[δ, δ², …, δ^count]."""
    out = []
    acc = Fp4(1)
    for _ in range(count):
        acc = acc * delta
        out.append(acc)
    return out


def bus_fingerprint(challenges: list[Fp4], tag: int,
                    payload: list[int]) -> Fp4:
    """Host-side fingerprint: tag + Σ δ^{i+1}·payload_i.  `challenges` is
    the machine challenge vector [γ, δ, δ², …]."""
    if len(payload) > MAX_PAYLOAD:
        raise ValueError(f"payload too long: {len(payload)}")
    fp = Fp4(tag)
    for i, v in enumerate(payload):
        fp = fp + challenges[1 + i] * (int(v) % P)
    return fp


def bus_term(challenges: list[Fp4], tag: int, payload: list[int]) -> Fp4:
    """1/(γ − fp) — the LogUp term one message contributes."""
    return (challenges[0] - bus_fingerprint(challenges, tag, payload)).inv()


def digest_limbs(digest32: bytes) -> list[int]:
    """A 32-byte digest as the 16 u16 limbs used in SHA bus payloads
    (word-major: each u32 word contributes (lo, hi) 16-bit limbs, matching
    the SHA chip's h_state column layout)."""
    if len(digest32) != 32:
        raise ValueError("need a 32-byte digest")
    out = []
    for i in range(0, 32, 4):
        word = int.from_bytes(digest32[i : i + 4], "big")
        out.append(word & 0xFFFF)
        out.append(word >> 16)
    return out


def np_bus_inverse_terms(challenges: list[Fp4], tag,
                         payload_cols: np.ndarray) -> np.ndarray:
    """Vectorized witness helper: for payload rows (n, k) of plain ints,
    return (n, 4) uint64 values of 1/(γ − fp(tag, row))."""
    from .lookup import np_ext_inverse

    n, k = payload_cols.shape
    acc = np.zeros((n, 4), dtype=np.uint64)
    g = np.array(challenges[0].c, dtype=np.uint64)
    acc[:] = g[None, :]
    acc[:, 0] = (acc[:, 0] + P - tag % P) % P
    for i in range(k):
        d = np.array(challenges[1 + i].c, dtype=np.uint64)
        contrib = (d[None, :] * (payload_cols[:, i].astype(np.uint64)
                                 % P)[:, None]) % P
        acc = (acc + P - contrib) % P
    return np_ext_inverse(acc)
