"""BN254 (alt_bn128) curve arithmetic and the optimal-ate pairing.

The curve every reference proof ultimately lands on: SP1's gnark Groth16
and RISC0's rapidsnark both prove over BN254 because Ethereum precompiles
(0x06 ecAdd, 0x07 ecMul, 0x08 ecPairing) verify it cheaply on-chain.

Port copy of zktls_tpu.snark.bn254 (same names, values and algorithms):
Fp plain ints; Fp2 = Fp[i]/(i²+1) as pairs; Fp12 = Fp2[w]/(w⁶ − ξ),
ξ = 9 + i, as 6-tuples of Fp2 (G2 untwists into the w²/w³ planes); points
are affine tuples or None (infinity).  Correctness rests on algebraic
tests (bilinearity, pairing-product identities, subgroup orders) and on
equality with the reference (tests/test_torch_snark.py).

Port choice: the MSMs (`msm_g1`, `msm_g2`) and the fixed-base batches
(`g1_base_mul_batch`, `g2_base_mul_batch`) take `native=True` by default
and then go through the C library of utils/native.py
(csrc/bn254_msm_host.c), which raises if it cannot be built or loaded;
the reference falls back to Python quietly there.  `native=False` is the
pure-Python plain version (Pippenger `_msm`, `FixedBase`), for tests.
"""

from __future__ import annotations

import numpy as np

from ..utils import native as clib

__all__ = [
    "P", "R", "G1", "G2", "g1_add", "g1_mul", "g1_neg", "g2_add", "g2_mul",
    "g2_neg", "is_on_g1", "is_on_g2", "pairing", "pairing_product",
    "msm_g1", "msm_g2", "fp12_one",
]

#: base field and scalar field (EIP-196)
P = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617

#: BN parameter t: p = 36t⁴+36t³+24t²+6t+1, r = 36t⁴+36t³+18t²+6t+1
T_BN = 4965661367192848881
ATE_LOOP = 6 * T_BN + 2

G1 = (1, 2)
#: standard G2 generator (EIP-197 ordering: (x_im·i + x_re, y_im·i + y_re))
G2 = (
    (10857046999023057135944570762232829481370756359578518086990519993285655852781,
     11559732032986387107991004021392285783925812861821192530917403151452391805634),
    (8495653923123431417604973247489272438418190587263600148770280649306958101930,
     4082367875863433681332203403145435568316851327593401208105741076214120093531),
)

# ---------------------------------------------------------------------------
# Fp2
# ---------------------------------------------------------------------------


def f2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def f2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def f2_neg(a):
    return (-a[0] % P, -a[1] % P)


def f2_mul(a, b):
    # (a0 + a1 i)(b0 + b1 i), i² = −1
    t0 = a[0] * b[0]
    t1 = a[1] * b[1]
    t2 = (a[0] + a[1]) * (b[0] + b[1])
    return ((t0 - t1) % P, (t2 - t0 - t1) % P)


def f2_sqr(a):
    return f2_mul(a, a)


def f2_scalar(a, k):
    return (a[0] * k % P, a[1] * k % P)


def f2_inv(a):
    norm = (a[0] * a[0] + a[1] * a[1]) % P
    ninv = pow(norm, P - 2, P)
    return (a[0] * ninv % P, -a[1] * ninv % P)


def f2_conj(a):
    return (a[0], -a[1] % P)


F2_ZERO = (0, 0)
F2_ONE = (1, 0)
XI = (9, 1)  # ξ = 9 + i, the sextic twist constant


# ---------------------------------------------------------------------------
# Fp12 = Fp2[w]/(w⁶ − ξ): 6-tuples of Fp2, index k ↔ coefficient of w^k
# ---------------------------------------------------------------------------


def fp12_one():
    return (F2_ONE,) + (F2_ZERO,) * 5


def f12_mul(a, b):
    prod = [F2_ZERO] * 11
    for i in range(6):
        if a[i] == F2_ZERO:
            continue
        for j in range(6):
            if b[j] == F2_ZERO:
                continue
            prod[i + j] = f2_add(prod[i + j], f2_mul(a[i], b[j]))
    out = list(prod[:6])
    for k in range(6, 11):
        out[k - 6] = f2_add(out[k - 6], f2_mul(prod[k], XI))
    return tuple(out)


def f12_sqr(a):
    return f12_mul(a, a)


def f12_conj(a):
    """Conjugation by the order-2 Frobenius p⁶: w ↦ −w (since ξ^{(p⁶−1)/6}
    = −1 for BN curves), i.e. negate odd w-powers."""
    return tuple(a[k] if k % 2 == 0 else f2_neg(a[k]) for k in range(6))


def f12_inv(a):
    """Inverse via p⁶-conjugate reduction to an Fp6-norm then Fermat —
    simplest correct route: solve with the generic extended approach using
    the conjugate: a · ā lands in the even subalgebra; do two steps of
    norm reduction down to Fp2/Fp."""
    # Treat Fp12 as quadratic over Fp6 (even/odd w-powers): a = a0 + a1·v,
    # v = w, v² multiplies into the even part.  Write a = e + o·w with
    # e, o ∈ Fp6 (w² = u, Fp6 = Fp2[u]/(u³ − ξ)).
    e = (a[0], a[2], a[4])
    o = (a[1], a[3], a[5])

    def f6_mul(x, y):
        prod = [F2_ZERO] * 5
        for i in range(3):
            for j in range(3):
                prod[i + j] = f2_add(prod[i + j], f2_mul(x[i], y[j]))
        out = list(prod[:3])
        for k in range(3, 5):
            out[k - 3] = f2_add(out[k - 3], f2_mul(prod[k], XI))
        return tuple(out)

    def f6_sub(x, y):
        return tuple(f2_sub(x[i], y[i]) for i in range(3))

    def f6_mul_u(x):  # multiply by u (w²): shifts, top wraps with ξ
        return (f2_mul(x[2], XI), x[0], x[1])

    def f6_inv(x):
        # norm to Fp2 via adjugate of the 3x3 multiplication matrix
        c0 = f2_sub(f2_sqr(x[0]), f2_mul(XI, f2_mul(x[1], x[2])))
        c1 = f2_sub(f2_mul(XI, f2_sqr(x[2])), f2_mul(x[0], x[1]))
        c2 = f2_sub(f2_sqr(x[1]), f2_mul(x[0], x[2]))
        t = f2_add(f2_mul(x[0], c0),
                   f2_add(f2_mul(XI, f2_mul(x[2], c1)),
                          f2_mul(XI, f2_mul(x[1], c2))))
        tinv = f2_inv(t)
        return (f2_mul(c0, tinv), f2_mul(c1, tinv), f2_mul(c2, tinv))

    # (e + o·w)⁻¹ = (e − o·w)/(e² − o²·u)
    denom = f6_sub(f6_mul(e, e), f6_mul_u(f6_mul(o, o)))
    dinv = f6_inv(denom)
    e_out = f6_mul(e, dinv)
    o_out = f6_mul(o, dinv)
    o_out = tuple(f2_neg(c) for c in o_out)
    return (e_out[0], o_out[0], e_out[1], o_out[1], e_out[2], o_out[2])


def f12_pow(a, e):
    result = fp12_one()
    base = a
    while e:
        if e & 1:
            result = f12_mul(result, base)
        base = f12_sqr(base)
        e >>= 1
    return result


# ---------------------------------------------------------------------------
# group law (affine; None = infinity)
# ---------------------------------------------------------------------------


def _ec_add(p1, p2, add, sub, mul, sqr, inv, neg_y):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if y1 == neg_y(y2):
            return None
        # doubling: λ = 3x²/2y
        lam = mul(mul(sqr(x1), _three(x1)), inv(_two(y1)))
    else:
        lam = mul(sub(y2, y1), inv(sub(x2, x1)))
    x3 = sub(sub(sqr(lam), x1), x2)
    y3 = sub(mul(lam, sub(x1, x3)), y1)
    return (x3, y3)


def _three(sample):
    return 3 if isinstance(sample, int) else (3, 0)


def _two(y):
    if isinstance(y, int):
        return 2 * y % P
    return f2_scalar(y, 2)


def g1_add(p1, p2):
    return _ec_add(
        p1, p2,
        lambda a, b: (a + b) % P, lambda a, b: (a - b) % P,
        lambda a, b: a * b % P if isinstance(b, int) else None,
        lambda a: a * a % P, lambda a: pow(a, P - 2, P),
        lambda y: -y % P)


def g1_neg(p1):
    return None if p1 is None else (p1[0], -p1[1] % P)


def g1_mul(p1, k):
    k %= R
    out = None
    add = g1_add
    while k:
        if k & 1:
            out = add(out, p1)
        p1 = add(p1, p1)
        k >>= 1
    return out


def g2_add(p1, p2):
    return _ec_add(
        p1, p2, f2_add, f2_sub, f2_mul, f2_sqr, f2_inv, f2_neg)


def g2_neg(p1):
    return None if p1 is None else (p1[0], f2_neg(p1[1]))


def g2_mul(p1, k):
    k %= R
    out = None
    while k:
        if k & 1:
            out = g2_add(out, p1)
        p1 = g2_add(p1, p1)
        k >>= 1
    return out


def is_on_g1(p1) -> bool:
    if p1 is None:
        return True
    x, y = p1
    return (y * y - x * x * x - 3) % P == 0


#: twist curve: y² = x³ + 3/ξ
B2 = f2_mul((3, 0), f2_inv(XI))


def is_on_g2(p2) -> bool:
    if p2 is None:
        return True
    x, y = p2
    return f2_sub(f2_sqr(y), f2_add(f2_mul(f2_sqr(x), x), B2)) == F2_ZERO


def in_g2_subgroup(p2) -> bool:
    """Order-r subgroup membership for twist points.  BN254's twist has a
    large cofactor, so on-curve membership alone admits points outside G2
    (diverging from EIP-197 precompile semantics and breaking the Groth16
    soundness assumptions for attacker-supplied proof.b)."""
    return is_on_g2(p2) and g2_mul(p2, R) is None


# ---------------------------------------------------------------------------
# optimal-ate pairing
# ---------------------------------------------------------------------------


def _untwist(q):
    """Map a twist point (x', y') ∈ E'(Fp2): y'² = x'³ + 3/ξ into
    E(Fp12): x = x'·w², y = y'·w³ (w⁶ = ξ) — then
    y² = ξ·y'² = ξ·x'³ + 3 = x³ + 3.  Sparse Fp12 elements."""
    xq, yq = q
    x12 = (F2_ZERO, F2_ZERO, xq, F2_ZERO, F2_ZERO, F2_ZERO)
    y12 = (F2_ZERO, F2_ZERO, F2_ZERO, yq, F2_ZERO, F2_ZERO)
    return (x12, y12)


def _f12_point_add(p1, p2):
    """Affine addition over E(Fp12) with the line slope returned."""
    x1, y1 = p1
    x2, y2 = p2
    if p1 == p2:
        num = f12_mul(f12_mul(x1, x1), (f2_scalar(F2_ONE, 3),) + (F2_ZERO,) * 5)
        den = f12_mul(y1, ((2, 0),) + (F2_ZERO,) * 5)
    else:
        num = _f12_sub(y2, y1)
        den = _f12_sub(x2, x1)
    lam = f12_mul(num, f12_inv(den))
    x3 = _f12_sub(_f12_sub(f12_mul(lam, lam), x1), x2)
    y3 = _f12_sub(f12_mul(lam, _f12_sub(x1, x3)), y1)
    return (x3, y3), lam


def _f12_sub(a, b):
    return tuple(f2_sub(a[k], b[k]) for k in range(6))


def _line(p_t, q_t, lam, p1):
    """Evaluate the line through (T, Q) with slope λ at the G1 point
    p1 = (x, y): l = y − y_T − λ(x − x_T), embedded in Fp12."""
    xt, yt = p_t
    x1, y1 = p1
    x_emb = ((x1 % P, 0),) + (F2_ZERO,) * 5
    y_emb = ((y1 % P, 0),) + (F2_ZERO,) * 5
    return _f12_sub(_f12_sub(y_emb, yt), f12_mul(lam, _f12_sub(x_emb, xt)))


def _frobenius_g2(q):
    """π(Q) on the untwisted Fp12 point: coordinate-wise x ↦ x^p."""
    x, y = q
    return (_f12_frob(x), _f12_frob(y))


def _f12_frob(a):
    """Frobenius x ↦ x^p on Fp12: conjugate Fp2 coefficients and multiply
    coefficient k by ξ^{k(p−1)/6}."""
    out = []
    for k in range(6):
        c = f2_conj(a[k])
        out.append(f2_mul(c, _FROB_COEFF[k]))
    return tuple(out)


def _xi_pow(e):
    # ξ^e in Fp2 by square-and-multiply
    result = F2_ONE
    base = XI
    while e:
        if e & 1:
            result = f2_mul(result, base)
        base = f2_sqr(base)
        e >>= 1
    return result


_FROB_COEFF = [_xi_pow(k * (P - 1) // 6) for k in range(6)]


def _miller(q, p1):
    q12 = _untwist(q)
    t = q12
    f = fp12_one()
    for bit in bin(ATE_LOOP)[3:]:
        new_t, lam = _f12_point_add(t, t)
        f = f12_mul(f12_sqr(f), _line(t, t, lam, p1))
        t = new_t
        if bit == "1":
            new_t, lam = _f12_point_add(t, q12)
            f = f12_mul(f, _line(t, q12, lam, p1))
            t = new_t
    # Frobenius corrections: Q1 = π(Q), Q2 = −π²(Q)
    q1 = _frobenius_g2(q12)
    nq2 = _frobenius_g2(q1)
    nq2 = (nq2[0], tuple(f2_neg(c) for c in nq2[1]))
    new_t, lam = _f12_point_add(t, q1)
    f = f12_mul(f, _line(t, q1, lam, p1))
    t = new_t
    _new_t, lam = _f12_point_add(t, nq2)
    f = f12_mul(f, _line(t, nq2, lam, p1))
    return f


def final_exponentiation(f):
    """f^{(p¹²−1)/r} — easy part via conjugate/inverse, hard part by plain
    square-and-multiply (milliseconds in Python; fine for the host wrap)."""
    # easy: f ↦ f^{p⁶−1} = conj(f)/f, then ^{p²+1}
    f1 = f12_mul(f12_conj(f), f12_inv(f))
    f2 = f12_mul(_f12_frob(_f12_frob(f1)), f1)
    # hard: ^((p⁴ − p² + 1)/r)
    e = (P**4 - P**2 + 1) // R
    return f12_pow(f2, e)


def pairing(p1, q2):
    """e(P, Q) for P ∈ G1, Q ∈ G2 (affine, None = infinity)."""
    if p1 is None or q2 is None:
        return fp12_one()
    if not (is_on_g1(p1) and in_g2_subgroup(q2)):
        raise ValueError("point not on curve / not in G2 subgroup")
    return final_exponentiation(_miller(q2, p1))


def pairing_product(pairs) -> bool:
    """Π e(Pᵢ, Qᵢ) == 1 — the ecPairing precompile semantics (EIP-197):
    multiply Miller loops, one shared final exponentiation."""
    f = fp12_one()
    for p1, q2 in pairs:
        if p1 is None or q2 is None:
            continue
        if not (is_on_g1(p1) and in_g2_subgroup(q2)):
            raise ValueError("point not on curve / not in G2 subgroup")
        f = f12_mul(f, _miller(q2, p1))
    return final_exponentiation(f) == fp12_one()


# ---------------------------------------------------------------------------
# multi-scalar multiplication (Pippenger)
# ---------------------------------------------------------------------------


def _msm(points, scalars, add, neg, window: int = 8):
    acc = None
    n_windows = (256 + window - 1) // window
    for wi in reversed(range(n_windows)):
        if acc is not None:
            for _ in range(window):
                acc = add(acc, acc)
        buckets = [None] * (1 << window)
        shift = wi * window
        mask = (1 << window) - 1
        for pt, s in zip(points, scalars):
            d = (s >> shift) & mask
            if d:
                buckets[d] = add(buckets[d], pt)
        running = None
        total = None
        for d in reversed(range(1, 1 << window)):
            running = add(running, buckets[d])
            total = add(total, running)
        acc = add(acc, total)
    return acc


# The C library is used from 64 points (scalars) up and Python below:
# the reference's size switch, kept as it is.  Both sides compute the same
# exact result, so the switch is a choice of method, not a fallback.
_NATIVE_MIN = 64


def _limbs4(x: int):
    m = (1 << 64) - 1
    return [(x >> (64 * j)) & m for j in range(4)]


def _int4(row) -> int:
    return (int(row[0]) | int(row[1]) << 64 | int(row[2]) << 128
            | int(row[3]) << 192)


def _scalar_limbs(scalars) -> np.ndarray:
    return np.array([_limbs4(s) for s in scalars],
                    dtype=np.uint64).reshape(len(scalars), 4)


def _jac1_to_affine(out3) -> tuple | None:
    X, Y, Z = (_int4(out3[k]) for k in range(3))
    if Z == 0:
        return None
    z_inv = pow(Z, P - 2, P)
    z2 = z_inv * z_inv % P
    return (X * z2 % P, Y * z2 % P * z_inv % P)


def _jac2_to_affine(out6) -> tuple | None:
    X = (_int4(out6[0]), _int4(out6[1]))
    Y = (_int4(out6[2]), _int4(out6[3]))
    Z = (_int4(out6[4]), _int4(out6[5]))
    if Z == (0, 0):
        return None
    z_inv = f2_inv(Z)
    z2 = f2_mul(z_inv, z_inv)
    return (f2_mul(X, z2), f2_mul(f2_mul(Y, z2), z_inv))


def msm_g1(points, scalars, native: bool = True):
    """Σ kᵢ·Pᵢ over G1 (affine, None = infinity)."""
    scalars = [s % R for s in scalars]
    if native and len(points) >= _NATIVE_MIN:
        return _msm_g1_native(points, scalars)
    return _msm(points, scalars, g1_add, g1_neg)


def _msm_g1_native(points, scalars):
    """Pippenger in C (csrc/bn254_msm_host.c) — the Groth16 proving hot
    loop; the reference leans on gnark/rapidsnark native MSM the same
    way."""
    pts = np.zeros((len(points), 8), dtype=np.uint64)
    for i, pt in enumerate(points):
        if pt is not None:
            pts[i] = _limbs4(pt[0]) + _limbs4(pt[1])
    return _jac1_to_affine(clib.bn254_msm_g1(pts, _scalar_limbs(scalars)))


def msm_g2(points, scalars, native: bool = True):
    """Σ kᵢ·Qᵢ over G2 (affine twist points, None = infinity)."""
    scalars = [s % R for s in scalars]
    if native and len(points) >= _NATIVE_MIN:
        return _msm_g2_native(points, scalars)
    return _msm(points, scalars, g2_add, g2_neg)


def _msm_g2_native(points, scalars):
    pts = np.zeros((len(points), 16), dtype=np.uint64)
    for i, pt in enumerate(points):
        if pt is not None:
            (xr, xi), (yr, yi) = pt
            pts[i] = _limbs4(xr) + _limbs4(xi) + _limbs4(yr) + _limbs4(yi)
    return _jac2_to_affine(clib.bn254_msm_g2(pts, _scalar_limbs(scalars)))


def g2_base_mul_batch(scalars: list[int], native: bool = True) -> list:
    """[k·G2 for k in scalars] via the C batched fixed-base path."""
    if not native or len(scalars) < _NATIVE_MIN:
        return [g2_base_mul(k % R) if k % R else None for k in scalars]
    base = np.array(_limbs4(G2[0][0]) + _limbs4(G2[0][1])
                    + _limbs4(G2[1][0]) + _limbs4(G2[1][1]),
                    dtype=np.uint64)
    jac = clib.bn254_g2_mul_batch(base, _scalar_limbs([s % R
                                                      for s in scalars]))
    return [(_jac2_to_affine(jac[i]) if s % R else None)
            for i, s in enumerate(scalars)]


class FixedBase:
    """Windowed fixed-base multiplier (8-bit windows): one table per base
    point amortizes CRS generation from ~512 point ops per scalar to ~32."""

    def __init__(self, base, add, window: int = 8):
        self._add = add
        self._window = window
        self._tables = []
        cur = base
        for _ in range((256 + window - 1) // window):
            row = [None]
            acc = None
            for _d in range((1 << window) - 1):
                acc = add(acc, cur)
                row.append(acc)
            self._tables.append(row)
            for _ in range(window):
                cur = add(cur, cur)

    def mul(self, k: int):
        k %= R
        out = None
        w = self._window
        mask = (1 << w) - 1
        for i, row in enumerate(self._tables):
            d = (k >> (w * i)) & mask
            if d:
                out = self._add(out, row[d])
        return out


_G1_BASE = None
_G2_BASE = None


def g1_base_mul(k: int):
    """G1 generator multiplication through a shared fixed-base table."""
    global _G1_BASE
    if _G1_BASE is None:
        _G1_BASE = FixedBase(G1, g1_add)
    return _G1_BASE.mul(k)


def g1_base_mul_batch(scalars: list[int], native: bool = True) -> list:
    """[k·G1 for k in scalars] — C batched fixed-base (CRS generation is
    n_vars of these), the Python table with native=False."""
    if not native or len(scalars) < _NATIVE_MIN:
        return [g1_base_mul(k % R) if k % R else None for k in scalars]
    base = np.array(_limbs4(G1[0]) + _limbs4(G1[1]), dtype=np.uint64)
    jac = clib.bn254_g1_mul_batch(base, _scalar_limbs([s % R
                                                      for s in scalars]))
    return [(_jac1_to_affine(jac[i]) if s % R else None)
            for i, s in enumerate(scalars)]


def g2_base_mul(k: int):
    global _G2_BASE
    if _G2_BASE is None:
        _G2_BASE = FixedBase(G2, g2_add)
    return _G2_BASE.mul(k)
