"""LogUp (log-derivative lookup) witness helpers.

The multiset argument that glues chips together and proves table
memberships — the framework analogue of the reference's LogUp-style
lookup/permutation arguments between sp1-core-machine chips
(SURVEY.md §2.2.B).  Identity proven, for a lookup challenge γ:

    Σ_rows 1/(γ − v_i)  =  Σ_rows m_i/(γ − t_i)

which holds (whp over γ) iff the multiset {v_i} is covered by table values
{t_i} with multiplicities m_i.  The prover commits, per lookup:

    inv_v = 1/(γ − v),  inv_t = 1/(γ − t),  S = running sum of
    (inv_v − m·inv_t), with S_last = 0 (or a public cumulative value that
    cross-chip bundles sum to zero).

All three are extension elements → 12 base columns per lookup.

Port copy of zktls_tpu.stark.lookup (same names and values).
"""

from __future__ import annotations

import numpy as np

from ..ops.field_ref import Fp4, P

__all__ = ["fp4_batch_inverse", "logup_perm_columns", "PERM_COLS_PER_LOOKUP"]

PERM_COLS_PER_LOOKUP = 12  # inv_v (4) ‖ inv_t (4) ‖ S (4)


def fp4_batch_inverse(vals: list[Fp4]) -> list[Fp4]:
    """Montgomery batch inversion over Fp4 (one inversion + 3(n−1) mults)."""
    n = len(vals)
    prefix = [Fp4(1)] * (n + 1)
    for i, v in enumerate(vals):
        prefix[i + 1] = prefix[i] * v
    inv_all = prefix[n].inv()
    out: list[Fp4] = [Fp4(0)] * n
    for i in range(n - 1, -1, -1):
        out[i] = prefix[i] * inv_all
        inv_all = inv_all * vals[i]
    return out


def logup_perm_columns(values, table, mults, gamma: Fp4) -> np.ndarray:
    """Build the 12 permutation columns for one lookup.

    values/table/mults: length-n integer sequences (the main-trace value
    column, the table column as materialized per row, the multiplicity
    column).  Returns plain uint32 (n, 12)."""
    n = len(values)
    gv = [gamma - int(v) for v in values]
    gt = [gamma - int(t) for t in table]
    inv_v = fp4_batch_inverse(gv)
    inv_t = fp4_batch_inverse(gt)
    out = np.zeros((n, PERM_COLS_PER_LOOKUP), dtype=np.uint32)
    run = Fp4(0)
    for i in range(n):
        term = inv_v[i] - int(mults[i]) * inv_t[i]
        run = run + term
        out[i, 0:4] = inv_v[i].c
        out[i, 4:8] = inv_t[i].c
        out[i, 8:12] = run.c
    return out


# ---------------------------------------------------------------------------
# vectorized (numpy) extension-field helpers for perm-trace generation —
# the witness side of LogUp is host-bound, and pure-Python Fp4 costs
# seconds per proof at scale.  uint64 arithmetic: products < p² < 2^62.
# ---------------------------------------------------------------------------


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


def np_logup_terms(gamma: Fp4, xs: np.ndarray, deltas_y: np.ndarray | None,
                   ys: np.ndarray | None, delta: Fp4 | None) -> np.ndarray:
    """inverses of γ − (x + δ·y) for flat integer arrays (y optional)."""
    n = xs.shape[0]
    vals = np.zeros((n, 4), dtype=np.uint64)
    g = np.array(gamma.c, dtype=np.uint64)
    vals[:] = g[None, :]
    vals[:, 0] = (vals[:, 0] + P - (xs % P)) % P   # +P: avoid u64 underflow
    if ys is not None:
        d = np.array(delta.c, dtype=np.uint64)
        dy = (d[None, :] * (ys % P)[:, None]) % P
        vals = (vals + P - dy) % P
    return np_ext_inverse(vals)
