"""Chip development aid: evaluate an AIR's constraints directly on a trace
over the raw field (no proving) and report every violated (row, constraint)
pair — the moral equivalent of the reference's debug-constraints mode.

Port copy of zktls_tpu.stark.debug (same names and values).
"""

from __future__ import annotations

import numpy as np

from ..ops.field_ref import P
from .air import Air, AirBuilder

__all__ = ["check_trace"]


class _Row:
    """Plain int field element for row-wise numeric evaluation."""

    __slots__ = ("v",)

    def __init__(self, v: int):
        self.v = v % P

    def _val(self, o):
        if isinstance(o, _Row):
            return o.v
        if isinstance(o, int):
            return o
        return None  # defer to the other operand's reflected op

    def __add__(self, o):
        v = self._val(o)
        return NotImplemented if v is None else _Row(self.v + v)
    __radd__ = __add__

    def __sub__(self, o):
        v = self._val(o)
        return NotImplemented if v is None else _Row(self.v - v)

    def __rsub__(self, o):
        v = self._val(o)
        return NotImplemented if v is None else _Row(v - self.v)

    def __mul__(self, o):
        v = self._val(o)
        return NotImplemented if v is None else _Row(self.v * v)
    __rmul__ = __mul__

    def __neg__(self):
        return _Row(-self.v)


def check_trace(air: Air, trace: np.ndarray, public_values: list[int],
                max_failures: int = 20, perm_trace: np.ndarray | None = None,
                challenges=(), preprocessed: np.ndarray | None = None,
                ) -> list[tuple[int, int]]:
    """Returns [(row, constraint_index)] for every violated constraint
    (transition rows exclude the wrap; first/last-row constraints evaluated
    only where their selector is live).  Empty list = trace satisfies AIR.
    For LogUp AIRs pass the generated perm_trace and the Fp4 challenges."""
    from .ext_val import ExtVal

    n = trace.shape[0]
    periodic = air.periodic_columns()
    failures: list[tuple[int, int]] = []
    if perm_trace is None:
        perm_trace = np.zeros((n, air.perm_width), dtype=np.uint32)
    if preprocessed is None:
        preprocessed = np.zeros(
            (n, getattr(air, "preprocessed_width", 0)), dtype=np.uint32)
    chal_vals = [ExtVal.from_fp4(c) for c in challenges]

    for row in range(n):
        nxt = (row + 1) % n
        is_first = 1 if row == 0 else 0
        is_last = 1 if row == n - 1 else 0
        is_transition = 0 if row == n - 1 else 1
        idx = [0]

        def fold(expr, row=row, idx=idx):
            if isinstance(expr, _Row) and expr.v != 0:
                failures.append((row, idx[0]))
            idx[0] += 1

        from .air import scalar_vec_hooks

        builder = AirBuilder(
            local=[_Row(int(v)) for v in trace[row]],
            next=[_Row(int(v)) for v in trace[nxt]],
            public=[_Row(int(v)) for v in public_values],
            is_first_row=_Row(is_first),
            is_last_row=_Row(is_last),
            is_transition=_Row(is_transition),
            _fold=fold,
            periodic=[_Row(int(p[row % len(p)])) for p in periodic],
            perm_local=[_Row(int(v)) for v in perm_trace[row]],
            perm_next=[_Row(int(v)) for v in perm_trace[nxt]],
            pre_local=[_Row(int(v)) for v in preprocessed[row]],
            pre_next=[_Row(int(v)) for v in preprocessed[nxt]],
            challenges=chal_vals,
            **scalar_vec_hooks(fold, lambda v: _Row(v)),
        )
        air.eval(builder)
        if len(failures) >= max_failures:
            break
    return failures
