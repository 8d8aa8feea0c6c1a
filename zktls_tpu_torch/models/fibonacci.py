"""Fibonacci AIR — the minimal end-to-end chip, used to validate the whole
prove/verify pipeline and as the reference example for writing chips.

Port copy of zktls_tpu.models.fibonacci (unchanged).

Columns: (a, b); public values: (a0, b0, b_final).
  first row:   a = a0, b = b0
  transition:  a' = b,  b' = a + b
  last row:    b = b_final
"""

from __future__ import annotations

import numpy as np

from ..ops.field_ref import P
from ..stark.air import Air, AirBuilder

__all__ = ["FibonacciAir", "fibonacci_trace"]


class FibonacciAir(Air):
    width = 2
    num_public = 3
    max_constraint_degree = 2  # constraint degree 1 + selector degree 1

    def eval(self, b: AirBuilder) -> None:
        # machine proofs append the 4 bus-sum publics after the AIR's own
        a0, b0, b_final = b.public[:3]
        local_a, local_b = b.local
        next_a, next_b = b.next
        b.when_first_row(local_a - a0)
        b.when_first_row(local_b - b0)
        b.when_transition(next_a - local_b)
        b.when_transition(next_b - (local_a + local_b))
        b.when_last_row(local_b - b_final)


def fibonacci_trace(log_n: int, a0: int = 0, b0: int = 1):
    """Returns (trace (n,2) uint32, public_values)."""
    n = 1 << log_n
    trace = np.zeros((n, 2), dtype=np.uint32)
    a, b = a0 % P, b0 % P
    for i in range(n):
        trace[i] = (a, b)
        a, b = b, (a + b) % P
    return trace, [a0 % P, b0 % P, int(trace[-1, 1])]
