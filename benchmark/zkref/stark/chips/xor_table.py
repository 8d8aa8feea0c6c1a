"""Nibble-XOR lookup table chip.

The GCM data chip must prove plaintext = ciphertext ⊕ keystream per byte,
but Baby-Bear has no native xor — the reference gets xor for free from the
RV32IM ALU chip's byte-lookup tables (sp1-core-machine, SURVEY.md §2.2.B).
Here the same LogUp-table idea at nibble granularity: a fixed 256-row table
enumerating every (x, y, x⊕y) with x, y ∈ [0, 16), SENT on the global bus
(BUS_XOR) with a per-row multiplicity column.  A byte xor costs two lookups
(hi/lo nibbles), and a successful lookup simultaneously range-checks both
inputs to [0, 16).

The x/y/z patterns are PERIODIC columns (period 256 == the trace height):
the verifier evaluates their interpolants itself, so the only committed
column is the multiplicity — the table cannot be forged, only its use
counts chosen, and those must balance the consumers' receives exactly.

Port copy of zktls_tpu.stark.chips.xor_table (same names and values; host
code in numpy).
"""

from __future__ import annotations

import numpy as np

from ..air import Air, AirBuilder
from ..bus import BUS_XOR, np_bus_inverse_terms
from ..ext_val import ExtVal

__all__ = ["XorTableAir", "xor_table_trace", "XOR_ROWS"]

P = 2013265921
XOR_ROWS = 256


def _patterns():
    i = np.arange(XOR_ROWS, dtype=np.uint32)
    x = i >> 4
    y = i & 15
    return x, y, x ^ y


class XorTableAir(Air):
    width = 1                # multiplicity
    num_public = 0
    max_constraint_degree = 3
    perm_width = 8           # inv ‖ acc
    num_perm_challenges = 2
    has_bus = True

    def periodic_columns(self) -> list:
        x, y, z = _patterns()
        return [x, y, z]

    def eval(self, b: AirBuilder) -> None:
        x, y, z = b.periodic
        m = b.local[0]
        gamma = b.challenges[0]

        def dpow(i):
            return b.challenges[1 + i]

        fp = (ExtVal.from_base(BUS_XOR) + dpow(0) * x + dpow(1) * y
              + dpow(2) * z)
        inv = b.perm_ext(0)
        acc = b.perm_ext(1)
        inv_n = b.perm_ext(0, nxt=True)
        acc_n = b.perm_ext(1, nxt=True)
        m_n = b.next[0]
        b.assert_ext_zero(inv * (gamma - fp) - 1)
        b.assert_ext_zero((acc - inv * m) * b.is_first_row)
        b.assert_ext_zero((acc_n - acc - inv_n * m_n) * b.is_transition)
        for ell in range(4):
            b.when_last_row(acc.c[ell] - b.public[ell])

    def generate_perm_trace(self, main, publics, challenges):
        x, y, z = _patterns()
        payload = np.stack([x, y, z], axis=1).astype(np.uint64)
        inv = np_bus_inverse_terms(challenges, BUS_XOR, payload)
        m = main[:, 0].astype(np.uint64)[:, None]
        u = (inv.astype(np.uint64) * m) % P
        acc = np.cumsum(u, axis=0) % P
        return np.concatenate([inv, acc], axis=1).astype(np.uint32)


def xor_table_trace(counts: np.ndarray | None = None):
    """Trace from a (256,) use-count array (or zeros)."""
    trace = np.zeros((XOR_ROWS, 1), dtype=np.uint32)
    if counts is not None:
        if counts.shape != (XOR_ROWS,):
            raise ValueError("counts must be (256,)")
        trace[:, 0] = counts.astype(np.uint64) % P
    return trace, []


def xor_use_counts(pairs: list[tuple[int, int]]) -> np.ndarray:
    """Use counts from a list of (x, y) nibble lookups."""
    counts = np.zeros(XOR_ROWS, dtype=np.uint64)
    for x, y in pairs:
        counts[(x << 4) | y] += 1
    return counts
