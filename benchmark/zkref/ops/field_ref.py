"""Baby-Bear field — host-side scalar reference implementation.

p = 2^31 − 2^27 + 1 = 0x78000001 = 2013265921, the field underlying both
reference STARK engines (Plonky3 p3-baby-bear and risc0-zkp, SURVEY.md
§2.2.B/C).  Multiplicative group order p−1 = 2^27 · 3 · 5 · 5^0… = 2^27·15,
two-adicity 27, smallest generator 31.

This module is the semantic ground truth: the tensor ops in
zktls_tpu_torch.ops.babybear are tested against it, and the (cheap,
sequential) verifier/challenger arithmetic runs on it directly.  It is the
port's own copy of zktls_tpu.ops.field_ref (same names, same values).

The quartic extension F_p[x]/(x^4 − 11) hosts STARK challenges
(soundness ~ |F|^4 ≈ 2^124); irreducibility of x^4 − 11 is proven by an
explicit polynomial-gcd test in the test suite.
"""

from __future__ import annotations

__all__ = ["P", "TWO_ADICITY", "GENERATOR", "W_EXT", "Fp4",
           "two_adic_root", "batch_inverse"]

P = 2013265921  # 0x78000001
TWO_ADICITY = 27
GENERATOR = 31
W_EXT = 11  # F_p4 = F_p[x]/(x^4 - 11)


def _val(x):
    if isinstance(x, int):
        return x
    return None  # defer to the other operand's reflected op


def two_adic_root(log_n: int) -> int:
    """Root of unity of order 2^log_n."""
    if log_n > TWO_ADICITY:
        raise ValueError(f"2-adicity exceeded: {log_n} > {TWO_ADICITY}")
    return pow(GENERATOR, ((P - 1) >> log_n), P)


def batch_inverse(vals: list[int]) -> list[int]:
    """Montgomery batch inversion over plain ints."""
    n = len(vals)
    prefix = [1] * (n + 1)
    for i, v in enumerate(vals):
        prefix[i + 1] = prefix[i] * v % P
    inv_all = pow(prefix[n], P - 2, P)
    out = [0] * n
    for i in range(n - 1, -1, -1):
        out[i] = prefix[i] * inv_all % P
        inv_all = inv_all * vals[i] % P
    return out


class Fp4:
    """Quartic extension element: a0 + a1·x + a2·x² + a3·x³, x⁴ = W_EXT."""

    __slots__ = ("c",)

    def __init__(self, c0=0, c1=0, c2=0, c3=0):
        if isinstance(c0, (tuple, list)):
            c0, c1, c2, c3 = c0
        self.c = (_val(c0) % P, _val(c1) % P, _val(c2) % P, _val(c3) % P)

    @classmethod
    def from_base(cls, v) -> "Fp4":
        return cls(_val(v))

    def __add__(self, o):
        o = _lift(o)
        if o is None:
            return NotImplemented
        return Fp4(*[(a + b) % P for a, b in zip(self.c, o.c)])
    __radd__ = __add__

    def __sub__(self, o):
        o = _lift(o)
        if o is None:
            return NotImplemented
        return Fp4(*[(a - b) % P for a, b in zip(self.c, o.c)])

    def __rsub__(self, o):
        o = _lift(o)
        if o is None:
            return NotImplemented
        return o - self

    def __neg__(self):
        return Fp4(*[-a % P for a in self.c])

    def __mul__(self, o):
        o = _lift(o)
        if o is None:
            return NotImplemented
        a, b = self.c, o.c
        # schoolbook then fold x^4 -> W
        prod = [0] * 7
        for i in range(4):
            if a[i] == 0:
                continue
            for j in range(4):
                prod[i + j] += a[i] * b[j]
        out = [0] * 4
        for k in range(4):
            out[k] = (prod[k] + W_EXT * prod[k + 4]) % P if k < 3 else prod[k] % P
        # k==3 has no folded term (prod[7] doesn't exist)
        return Fp4(*out)
    __rmul__ = __mul__

    def __pow__(self, e: int):
        result = Fp4(1)
        base = self
        while e:
            if e & 1:
                result = result * base
            base = base * base
            e >>= 1
        return result

    def inv(self) -> "Fp4":
        # Norm to the base field via conjugates: N(a) = a * a^p * a^{p^2} * a^{p^3}
        ap = self.frobenius()
        ap2 = ap.frobenius()
        ap3 = ap2.frobenius()
        conj = ap * ap2 * ap3
        norm = (self * conj).c
        assert norm[1] == 0 and norm[2] == 0 and norm[3] == 0, "norm not in base"
        n_inv = pow(norm[0], P - 2, P)
        return Fp4(*[(x * n_inv) % P for x in conj.c])

    def __truediv__(self, o):
        return self * _lift(o).inv()

    def frobenius(self) -> "Fp4":
        """x -> x^p:  x^p = W^((p-1)/4)·x since p ≡ 1 (mod 4)."""
        f = pow(W_EXT, (P - 1) // 4, P)
        return Fp4(
            self.c[0],
            self.c[1] * f % P,
            self.c[2] * f * f % P,
            self.c[3] * f * f * f % P,
        )

    def __eq__(self, o):
        o = _lift(o)
        return NotImplemented if o is None else self.c == o.c

    def __hash__(self):
        return hash(self.c)

    def __repr__(self):
        return f"Fp4{self.c}"

    def is_base(self) -> bool:
        return self.c[1] == self.c[2] == self.c[3] == 0


def _lift(x):
    if isinstance(x, Fp4):
        return x
    v = _val(x)
    return None if v is None else Fp4(v)
