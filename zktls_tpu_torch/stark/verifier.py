"""Verifier building blocks — pure host Python (ints + Fp4), independent
of the device code.

Port copy of the parts of zktls_tpu.stark.verifier that the machine
verifier (stark/machine.py) uses: the error type, the periodic-column
interpolants at ζ and the FRI final-layer degree check."""

from __future__ import annotations

from ..ops.field_ref import Fp4, P, two_adic_root
from .config import StarkConfig

__all__ = ["VerificationError"]


class VerificationError(Exception):
    pass


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise VerificationError(what)


_PERIODIC_COEFFS: dict = {}


def _periodic_coeffs(pattern) -> list[int]:
    """Interpolation coefficients of a period-m pattern (ζ-independent,
    cached by content — keccak evaluates ~90 length-256 patterns per
    verify)."""
    key = bytes(memoryview(__import__("numpy").ascontiguousarray(pattern)))
    hit = _PERIODIC_COEFFS.get(key)
    if hit is not None:
        return hit
    import numpy as np

    m = len(pattern)
    w = two_adic_root(m.bit_length() - 1)
    w_inv = pow(w, P - 2, P)
    m_inv = pow(m, P - 2, P)
    pat = np.asarray(pattern, dtype=np.uint64) % P
    steps = np.empty(m, dtype=np.uint64)
    acc = 1
    for k in range(m):
        steps[k] = acc
        acc = acc * w_inv % P
    # V[k, j] = (w^-k)^j  built by cumulative products per row (vector-
    # ized over k): row k = steps[k]^j
    coeffs = []
    for k in range(m):
        powers = np.empty(m, dtype=np.uint64)
        acc = 1
        s = int(steps[k])
        for j in range(m):
            powers[j] = acc
            acc = acc * s % P
        coeffs.append(int((pat * powers % P).sum() % P) * m_inv % P)
    _PERIODIC_COEFFS[key] = coeffs
    return coeffs


def _eval_periodic(pattern, zeta: Fp4, n: int) -> Fp4:
    """Evaluate the degree-<m interpolant of a period-m pattern at ζ^{n/m}
    (cached inverse DFT + Horner; m is small, e.g. 64)."""
    m = len(pattern)
    coeffs = _periodic_coeffs(pattern)
    y = zeta ** (n // m)
    out = Fp4(0)
    for c in reversed(coeffs):
        out = out * y + Fp4(c)
    return out


def _final_low_degree(values: list[Fp4], config: StarkConfig,
                      log_N: int, n_layers: int) -> None:
    """Interpolate the final layer on its domain and check the degree bound
    deg < size/blowup (naive O(size²) — size ≤ fri_final_size)."""
    size = len(values)
    log_size = size.bit_length() - 1
    _check(1 << log_size == size, "final size not a power of two")
    shift = config.shift
    for _ in range(n_layers):
        shift = shift * shift % P
    w_f = two_adic_root(log_size)
    # coefficients via inverse DFT: c_k = (1/size)·Σ_i v_i·w^{-ik}·shift^{-k}
    size_inv = pow(size, P - 2, P)
    w_inv = pow(w_f, P - 2, P)
    shift_inv = pow(shift, P - 2, P)
    max_deg = size // config.blowup  # strict bound: coeffs >= this are 0
    sh = 1
    for k in range(size):
        step = pow(w_inv, k, P)
        acc = Fp4(0)
        wk = 1
        for i in range(size):
            acc = acc + values[i] * wk
            wk = wk * step % P
        coeff = acc * size_inv * sh
        if k >= max_deg:
            _check(coeff == Fp4(0), f"final poly degree too high at {k}")
        sh = sh * shift_inv % P
