"""Vectorized (numpy) extension-field helpers for the LogUp witness side
and the prover's/verifier's power tables.

Port copy of the helpers of zktls_tpu.stark.lookup that the machine uses.
uint64 arithmetic: products < p² < 2^62.
"""

from __future__ import annotations

import numpy as np

from ..ops.field_ref import P

__all__ = ["np_ext_mul", "np_ext_powers", "np_ext_inverse"]


def np_ext_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(n, 4) × (n, 4) -> (n, 4) over F_p[x]/(x^4 − W_EXT), uint64 in/out
    (values < p)."""
    from ..ops.field_ref import W_EXT

    a = a % P
    b = b % P

    def m(i, j):
        return (a[:, i] * b[:, j]) % P

    c0 = (m(0, 0) + W_EXT * ((m(1, 3) + m(2, 2) + m(3, 1)) % P)) % P
    c1 = (m(0, 1) + m(1, 0) + W_EXT * ((m(2, 3) + m(3, 2)) % P)) % P
    c2 = (m(0, 2) + m(1, 1) + m(2, 0) + W_EXT * m(3, 3)) % P
    c3 = (m(0, 3) + m(1, 2) + m(2, 1) + m(3, 0)) % P
    return np.stack([c0, c1, c2, c3], axis=1)


def np_ext_powers(x, n: int) -> np.ndarray:
    """(n, 4) plain-uint64 array of [1, x, x², …, x^{n−1}] by repeated
    doubling — log(n) vectorized ext muls instead of n Python Fp4 muls
    (the prover builds ζ/α/β power tables every proof)."""
    out = np.zeros((max(n, 1), 4), dtype=np.uint64)
    out[0, 0] = 1
    k = 1
    xk = np.array([list(x.c)], dtype=np.uint64)   # x^k
    while k < n:
        m = min(k, n - k)
        out[k : k + m] = np_ext_mul(out[:m],
                                    np.broadcast_to(xk, (m, 4)))
        if 2 * k < n:
            xk = np_ext_mul(xk, xk)
        k *= 2
    return out


def np_ext_inverse(a: np.ndarray) -> np.ndarray:
    """Vectorized Fp4 inverse via the norm map (conjugate product lands in
    the base field; one vectorized Fermat inversion there)."""
    from ..ops.field_ref import W_EXT

    a = (a % P).astype(np.uint64)
    f1 = pow(W_EXT, (P - 1) // 4, P)
    tw = np.array([
        [1, f1, f1 * f1 % P, f1 * f1 % P * f1 % P],
        [1, f1 * f1 % P, pow(f1, 4, P), pow(f1, 6, P)],
        [1, pow(f1, 3, P), pow(f1, 6, P), pow(f1, 9, P)],
    ], dtype=np.uint64)
    a_p = (a * tw[0][None, :]) % P
    a_p2 = (a * tw[1][None, :]) % P
    a_p3 = (a * tw[2][None, :]) % P
    conj = np_ext_mul(np_ext_mul(a_p, a_p2), a_p3)
    norm = np_ext_mul(a, conj)[:, 0]
    # Fermat inverse of the base-field norm, vectorized square-and-multiply
    inv = np.ones_like(norm)
    base = norm % P
    e = P - 2
    while e:
        if e & 1:
            inv = (inv * base) % P
        base = (base * base) % P
        e >>= 1
    return (conj * inv[:, None]) % P
