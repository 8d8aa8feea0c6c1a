"""Groth16 over BN254: setup → prove → verify.

The stark→snark wrap stage: a constant-size, pairing-checkable proof the
exported EVM contract verifies with the ecPairing precompile.  setup()
derives the toxic waste (τ, α, β, γ, δ) from a seed — the dev-mode
equivalent of gnark's unsafe setup; a production deployment runs a
multi-party ceremony for the same CRS shape.  QAP division uses the BN254
scalar field's 2^28 two-adicity (radix-2 NTT over a coset).

Port copy of zktls_tpu.snark.groth16 (same names, values and bytes: the
same circuit, seed and randomness give the reference's keys and proof).
Host code, as in the reference; its MSMs and fixed-base batches go through
the C library of utils/native.py (bn254.msm_g1 and friends), which raises
rather than fall back to Python.
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass

from .bn254 import (
    G1,
    G2,
    P as BN_P,
    R,
    fp12_one,
    g1_add,
    g1_base_mul,
    g1_mul,
    g1_neg,
    g2_add,
    g2_base_mul,
    g2_mul,
    msm_g1,
    msm_g2,
    pairing_product,
)
from .r1cs import R1CS

__all__ = ["Groth16Keys", "Groth16Proof", "setup", "prove", "verify"]

# 5 generates BN254's Fr*; ω = 5^((r−1)/2^28) is the 2^28-th root of unity
_TWO_ADICITY = 28
_W_MAX = pow(5, (R - 1) >> _TWO_ADICITY, R)
assert pow(_W_MAX, 1 << _TWO_ADICITY, R) == 1
assert pow(_W_MAX, 1 << (_TWO_ADICITY - 1), R) != 1


def _root(log_n: int) -> int:
    return pow(_W_MAX, 1 << (_TWO_ADICITY - log_n), R)


def _ntt(vals: list[int], invert: bool = False) -> list[int]:
    n = len(vals)
    log_n = n.bit_length() - 1
    a = list(vals)
    # bit-reversal
    j = 0
    for i in range(1, n):
        bit = n >> 1
        while j & bit:
            j ^= bit
            bit >>= 1
        j |= bit
        if i < j:
            a[i], a[j] = a[j], a[i]
    length = 2
    while length <= n:
        w = _root(length.bit_length() - 1)
        if invert:
            w = pow(w, R - 2, R)
        half = length // 2
        for start in range(0, n, length):
            wn = 1
            for k in range(half):
                u = a[start + k]
                v = a[start + k + half] * wn % R
                a[start + k] = (u + v) % R
                a[start + k + half] = (u - v) % R
                wn = wn * w % R
        length <<= 1
    if invert:
        n_inv = pow(n, R - 2, R)
        a = [x * n_inv % R for x in a]
    return a


@dataclass
class Groth16Keys:
    # proving key
    alpha1: tuple
    beta1: tuple
    beta2: tuple
    delta1: tuple
    delta2: tuple
    a_query: list          # [A_i(τ)]₁
    b1_query: list         # [B_i(τ)]₁
    b2_query: list         # [B_i(τ)]₂
    k_query: list          # [(βA_i + αB_i + C_i)/δ]₁ for private i
    h_query: list          # [τ^k·Z(τ)/δ]₁
    # verifying key
    gamma2: tuple
    ic: list               # [(βA_i + αB_i + C_i)/γ]₁ for i ≤ n_public
    n_public: int

    def vk(self) -> dict:
        return {
            "alpha1": self.alpha1, "beta2": self.beta2,
            "gamma2": self.gamma2, "delta2": self.delta2, "ic": self.ic,
        }


@dataclass
class Groth16Proof:
    a: tuple   # G1
    b: tuple   # G2
    c: tuple   # G1

    def to_bytes(self) -> bytes:
        def enc1(p):
            return p[0].to_bytes(32, "big") + p[1].to_bytes(32, "big")

        def enc2(p):
            # EIP-197 ordering: imaginary limb first
            return (p[0][1].to_bytes(32, "big") + p[0][0].to_bytes(32, "big")
                    + p[1][1].to_bytes(32, "big") + p[1][0].to_bytes(32, "big"))

        return enc1(self.a) + enc2(self.b) + enc1(self.c)

    @classmethod
    def from_bytes(cls, data: bytes) -> "Groth16Proof":
        def word(i):
            v = int.from_bytes(data[32 * i : 32 * (i + 1)], "big")
            if v >= BN_P:
                # non-canonical coordinate: accepting it (reducing mod p)
                # would make proofs malleable
                raise ValueError("non-canonical BN254 coordinate in proof")
            return v

        return cls(
            a=(word(0), word(1)),
            b=((word(3), word(2)), (word(5), word(4))),
            c=(word(6), word(7)),
        )


def _qap_matrices(cs: R1CS, tau: int):
    """A_i(τ), B_i(τ), C_i(τ) for every variable, plus Z(τ), using the
    Lagrange basis on the 2-adic domain of size n ≥ #constraints."""
    m = len(cs.constraints)
    log_n = max(1, (m - 1).bit_length())
    n = 1 << log_n
    w = _root(log_n)
    # L_j(τ) = (τ^n − 1)·ω^j / (n·(τ − ω^j))
    tau_n = pow(tau, n, R)
    lag = []
    wj = 1
    for j in range(n):
        denom = (n * (tau - wj)) % R
        lag.append((tau_n - 1) * wj % R * pow(denom, R - 2, R) % R)
        wj = wj * w % R
    a_t = [0] * cs.n_vars
    b_t = [0] * cs.n_vars
    c_t = [0] * cs.n_vars
    for j, (a, b, c) in enumerate(cs.constraints):
        lj = lag[j]
        for i, v in a.items():
            a_t[i] = (a_t[i] + v * lj) % R
        for i, v in b.items():
            b_t[i] = (b_t[i] + v * lj) % R
        for i, v in c.items():
            c_t[i] = (c_t[i] + v * lj) % R
    z_t = (tau_n - 1) % R
    return a_t, b_t, c_t, z_t, n, log_n


def setup(cs: R1CS, seed: bytes = b"zktls-tpu-groth16-dev") -> Groth16Keys:
    """Dev-mode CRS from a seed (production: MPC ceremony, same shape)."""

    def draw(label: str) -> int:
        out = int.from_bytes(
            hashlib.sha512(seed + b"/" + label.encode()).digest(), "big") % R
        return out or 1

    tau, alpha, beta, gamma, delta = (draw(x) for x in
                                      ("tau", "alpha", "beta", "gamma",
                                       "delta"))
    a_t, b_t, c_t, z_t, n, _log_n = _qap_matrices(cs, tau)
    gamma_inv = pow(gamma, R - 2, R)
    delta_inv = pow(delta, R - 2, R)

    from .bn254 import g1_base_mul_batch, g2_base_mul_batch

    a_query = [p if v else None
               for p, v in zip(g1_base_mul_batch(a_t), a_t)]
    b1_query = [p if v else None
                for p, v in zip(g1_base_mul_batch(b_t), b_t)]
    b2_query = [p if v else None
                for p, v in zip(g2_base_mul_batch(b_t), b_t)]
    k_scalars = []
    for i in range(cs.n_vars):
        k = (beta * a_t[i] + alpha * b_t[i] + c_t[i]) % R
        k_scalars.append(k * (gamma_inv if i <= cs.n_public
                              else delta_inv) % R)
    k_points = g1_base_mul_batch(k_scalars)
    ic = k_points[: cs.n_public + 1]
    k_query = k_points[cs.n_public + 1 :]
    h_scalars = []
    t_pow = 1
    for _k in range(n - 1):
        h_scalars.append(t_pow * z_t % R * delta_inv % R)
        t_pow = t_pow * tau % R
    h_query = g1_base_mul_batch(h_scalars)
    return Groth16Keys(
        alpha1=g1_base_mul(alpha), beta1=g1_base_mul(beta),
        beta2=g2_base_mul(beta), delta1=g1_base_mul(delta),
        delta2=g2_base_mul(delta), a_query=a_query, b1_query=b1_query,
        b2_query=b2_query, k_query=k_query, h_query=h_query,
        gamma2=g2_base_mul(gamma), ic=ic, n_public=cs.n_public)


def _h_coeffs(cs: R1CS, z: list[int]) -> list[int]:
    """Coefficients of h(x) = (A(x)·B(x) − C(x)) / Z(x) via coset NTTs."""
    m = len(cs.constraints)
    log_n = max(1, (m - 1).bit_length())
    n = 1 << log_n
    a_e = [0] * n
    b_e = [0] * n
    c_e = [0] * n
    for j, (a, b, c) in enumerate(cs.constraints):
        a_e[j] = sum(z[i] * v for i, v in a.items()) % R
        b_e[j] = sum(z[i] * v for i, v in b.items()) % R
        c_e[j] = sum(z[i] * v for i, v in c.items()) % R
    a_c = _ntt(a_e, invert=True)
    b_c = _ntt(b_e, invert=True)
    c_c = _ntt(c_e, invert=True)
    g = 5  # coset shift (multiplicative generator)
    gp = [pow(g, k, R) for k in range(n)]
    a_s = _ntt([a_c[k] * gp[k] % R for k in range(n)])
    b_s = _ntt([b_c[k] * gp[k] % R for k in range(n)])
    c_s = _ntt([c_c[k] * gp[k] % R for k in range(n)])
    z_g = (pow(g, n, R) - 1) % R      # Z on the coset is constant g^n − 1
    z_inv = pow(z_g, R - 2, R)
    h_s = [(a_s[k] * b_s[k] - c_s[k]) % R * z_inv % R for k in range(n)]
    h_c = _ntt(h_s, invert=True)
    g_inv = pow(g, R - 2, R)
    return [h_c[k] * pow(g_inv, k, R) % R for k in range(n)][: n - 1]


def prove(keys: Groth16Keys, cs: R1CS,
          randomness: bytes | None = None) -> Groth16Proof:
    """randomness: explicit blinding entropy for reproducible tests; by
    default FRESH os.urandom is drawn per proof — r and s must never be
    recomputable from public data or the masking terms r·δ, s·δ can be
    stripped and zero-knowledge collapses."""
    z = cs.assignment()
    if not cs.check():
        raise ValueError("R1CS assignment does not satisfy the constraints")
    if randomness is None:
        randomness = os.urandom(64)
    # mix the FULL private assignment (not just the public prefix) so even
    # caller-supplied low-entropy randomness never yields publicly
    # recomputable blinding scalars
    rs = hashlib.sha512(b"groth16-rand/" + randomness
                        + bytes(str(z), "ascii")).digest()
    r = int.from_bytes(rs[:32], "big") % R
    s = int.from_bytes(rs[32:], "big") % R

    pts_a = [p for p, v in zip(keys.a_query, z) if p is not None and v]
    sc_a = [v for p, v in zip(keys.a_query, z) if p is not None and v]
    a = g1_add(g1_add(keys.alpha1, msm_g1(pts_a, sc_a)),
               g1_mul(keys.delta1, r))

    pts_b2 = [p for p, v in zip(keys.b2_query, z) if p is not None and v]
    sc_b2 = [v for p, v in zip(keys.b2_query, z) if p is not None and v]
    b2 = g2_add(keys.beta2, msm_g2(pts_b2, sc_b2))
    b2 = g2_add(b2, g2_mul(keys.delta2, s))

    pts_b1 = [p for p, v in zip(keys.b1_query, z) if p is not None and v]
    sc_b1 = [v for p, v in zip(keys.b1_query, z) if p is not None and v]
    b1 = g1_add(g1_add(keys.beta1, msm_g1(pts_b1, sc_b1)),
                g1_mul(keys.delta1, s))

    h = _h_coeffs(cs, z)
    c = msm_g1(keys.h_query[: len(h)], h)
    priv = z[cs.n_public + 1 :]
    if priv:
        c = g1_add(c, msm_g1(keys.k_query, priv))
    c = g1_add(c, g1_mul(a, s))
    c = g1_add(c, g1_mul(b1, r))
    c = g1_add(c, g1_neg(g1_mul(keys.delta1, r * s % R)))
    return Groth16Proof(a=a, b=b2, c=c)


def verify(vk: dict, public_inputs: list[int],
           proof: Groth16Proof) -> bool:
    """e(A, B) = e(α, β) · e(IC(pub), γ) · e(C, δ) — exactly the pairing-
    product the exported EVM contract submits to the 0x08 precompile."""
    ic = vk["ic"]
    if len(public_inputs) != len(ic) - 1:
        raise ValueError("public input count mismatch")
    acc = ic[0]
    for p, v in zip(ic[1:], public_inputs):
        acc = g1_add(acc, g1_mul(p, v % R))
    from .bn254 import g2_neg

    return pairing_product([
        (g1_neg(proof.a), proof.b),
        (vk["alpha1"], vk["beta2"]),
        (acc, vk["gamma2"]),
        (proof.c, vk["delta2"]),
    ])
