"""Byte range-check chip — the first LogUp consumer and the template for
table-based chips (AES S-box, byte XOR, u16 range — the reference's
byte-lookup chip family, SURVEY.md §2.2.B "byte-lookup ... chips").

Proves every value in a witness column is a byte (0..255) by looking it up
against the periodic table t_i = i mod 256 with a committed multiplicity
column.  Demonstrates the full two-round commitment flow: main trace →
challenge γ → LogUp permutation columns → quotient.

Port copy of zktls_tpu.stark.chips.bytes_table (same names and values;
host code in numpy).
"""

from __future__ import annotations

import numpy as np

from ..air import Air, AirBuilder
from ..ext_val import ExtVal
from ..lookup import PERM_COLS_PER_LOOKUP, logup_perm_columns

__all__ = ["ByteRangeAir", "byte_range_trace"]


class ByteRangeAir(Air):
    width = 2                 # v (looked-up value), m (table multiplicity)
    num_public = 0
    max_constraint_degree = 3
    perm_width = PERM_COLS_PER_LOOKUP
    num_perm_challenges = 1

    def periodic_columns(self) -> list:
        return [np.arange(256, dtype=np.uint32)]

    def generate_perm_trace(self, main, public_values, challenges):
        n = main.shape[0]
        table = [i % 256 for i in range(n)]
        return logup_perm_columns(main[:, 0], table, main[:, 1], challenges[0])

    def eval(self, b: AirBuilder) -> None:
        gamma = b.challenges[0]
        v, m = b.local[0], b.local[1]
        m_next = b.next[1]
        t = b.periodic[0]
        inv_v = b.perm_ext(0)
        inv_t = b.perm_ext(1)
        s = b.perm_ext(2)
        inv_v_n = b.perm_ext(0, nxt=True)
        inv_t_n = b.perm_ext(1, nxt=True)
        s_next = b.perm_ext(2, nxt=True)

        # the committed inverses are genuine: inv·(γ − x) = 1
        b.assert_ext_zero(inv_v * (gamma - ExtVal.from_base(v)) - 1)
        b.assert_ext_zero(inv_t * (gamma - ExtVal.from_base(t)) - 1)

        term_first = inv_v - m * inv_t
        b.assert_ext_zero((s - term_first) * b.is_first_row)
        # S' = S + (inv_v' − m'·inv_t')  on transitions
        term_next = inv_v_n - m_next * inv_t_n
        b.assert_ext_zero((s_next - s - term_next) * b.is_transition)
        # balanced lookup: the final running sum vanishes
        b.assert_ext_zero(s * b.is_last_row)


def byte_range_trace(values: list[int], min_log_n: int = 8) -> np.ndarray:
    """Main trace for a list of byte values (padded with zeros — zero is in
    the table, its multiplicity accounts for the padding)."""
    n = 1 << max(min_log_n, (max(len(values), 256) - 1).bit_length())
    v = np.zeros(n, dtype=np.uint32)
    v[: len(values)] = np.asarray(values, dtype=np.uint32)
    counts = np.bincount(v, minlength=256) if v.size else np.zeros(256, int)
    m = np.zeros(n, dtype=np.uint32)
    m[:256] = counts[:256]
    return np.stack([v, m], axis=1)
