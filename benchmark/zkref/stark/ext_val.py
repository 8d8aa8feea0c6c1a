"""Extension-field values inside AIR constraints (port copy of
zktls_tpu.stark.ext_val).

LogUp permutation columns live in the quartic extension (committed as 4 base
columns each), and their constraints — running-sum transitions, inverse
checks against the lookup challenge γ — are extension-field equations.
`ExtVal` expresses them over any constraint algebra: limbs are BBCol arrays
on the prover, Fp4 scalars (the openings at ζ) on the verifier, plain ints
in the debug checker.  Multiplication folds x⁴ → W_EXT exactly as
zktls_tpu.ops.field_ref.Fp4 does, so limb-wise constraint satisfaction is
equivalent to the extension-field equation.
"""

from __future__ import annotations

from ..ops.field_ref import W_EXT, Fp4

__all__ = ["ExtVal"]


class ExtVal:
    __slots__ = ("c",)

    def __init__(self, c0, c1=0, c2=0, c3=0):
        if isinstance(c0, (tuple, list)):
            c0, c1, c2, c3 = c0
        self.c = (c0, c1, c2, c3)

    @classmethod
    def from_base(cls, v) -> "ExtVal":
        return cls(v, 0, 0, 0)

    @classmethod
    def from_fp4(cls, v: Fp4) -> "ExtVal":
        """A *constant* extension element with integer limbs (lifted by the
        target algebra's int support)."""
        return cls(*[int(x) for x in v.c])

    def _pair(self, o) -> "ExtVal":
        if isinstance(o, ExtVal):
            return o
        return ExtVal.from_base(o)

    def __add__(self, o):
        o = self._pair(o)
        return ExtVal(*[a + b for a, b in zip(self.c, o.c)])
    __radd__ = __add__

    def __sub__(self, o):
        o = self._pair(o)
        return ExtVal(*[a - b for a, b in zip(self.c, o.c)])

    def __rsub__(self, o):
        o = self._pair(o)
        return ExtVal(*[b - a for a, b in zip(self.c, o.c)])

    def __neg__(self):
        return ExtVal(*[-a for a in self.c])

    def __mul__(self, o):
        if not isinstance(o, ExtVal):
            # base-algebra (or int) scalar: limbwise scale
            return ExtVal(*[a * o for a in self.c])
        a, b = self.c, o.c
        prod = [0] * 7
        for i in range(4):
            for j in range(4):
                prod[i + j] = prod[i + j] + a[i] * b[j]
        return ExtVal(
            prod[0] + W_EXT * prod[4],
            prod[1] + W_EXT * prod[5],
            prod[2] + W_EXT * prod[6],
            prod[3],
        )

    def __rmul__(self, o):
        return ExtVal(*[o * a for a in self.c])

    def limbs(self):
        return self.c
