"""The uni-STARK verifier — pure host Python (ints + Fp4), independent of
the device code.

Port copy of zktls_tpu.stark.verifier.  `verify` re-derives the full
Fiat-Shamir transcript of a single-AIR proof (stark/prover.py::prove),
checks the DEEP-ALI constraint identity at ζ, and for every query checks
Merkle openings, the DEEP composition value, the FRI fold chain, and
finally the low-degreeness of the FRI final layer.  The periodic-column
interpolants at ζ and the final-layer degree check serve the machine
verifier (stark/machine.py) too."""

from __future__ import annotations

from ..ops.field_ref import Fp4, P, two_adic_root
from ..ops.merkle import hash_row_ints, verify_path
from .air import Air
from .challenger import Challenger
from .config import DEFAULT_CONFIG, StarkConfig
from .proof import StarkProof

__all__ = ["verify", "VerificationError"]


class VerificationError(Exception):
    pass


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise VerificationError(what)


_EXT_BASIS = [Fp4(1), Fp4(0, 1), Fp4(0, 0, 1), Fp4(0, 0, 0, 1)]


def verify(air: Air, proof: StarkProof,
           config: StarkConfig = DEFAULT_CONFIG) -> bool:
    """Raises VerificationError on any failure; returns True on success."""
    _check(proof.air_name == air.name, "air name mismatch")
    log_n = proof.log_n
    n = 1 << log_n
    log_N = log_n + config.log_blowup
    N = 1 << log_N
    w = air.width
    s = config.shift
    g = two_adic_root(log_n)
    w_N = two_adic_root(log_N)
    _check(len(proof.trace_local_evals) == w, "bad local eval count")
    _check(len(proof.trace_next_evals) == w, "bad next eval count")
    n_qcols = 4 * config.blowup
    _check(len(proof.quotient_evals) == n_qcols, "bad quotient eval count")
    _check(len(proof.queries) == config.num_queries, "bad query count")
    n_layers = 0
    size = N
    while size > config.fri_final_size:
        size //= 2
        n_layers += 1
    _check(len(proof.fri_roots) == n_layers, "bad FRI layer count")
    _check(len(proof.fri_final) == size, "bad FRI final size")

    pw = air.perm_width
    _check(len(proof.perm_local_evals) == pw, "bad perm eval count")
    _check(len(proof.perm_next_evals) == pw, "bad perm eval count")
    _check((proof.perm_root is not None) == bool(pw), "perm root mismatch")

    # --- transcript replay ------------------------------------------------
    ch = Challenger()
    ch.observe_bytes(air.name.encode())
    ch.observe(log_n)
    ch.observe_many(proof.public_values)
    ch.observe_many(proof.trace_root)
    challenges = []
    if pw:
        challenges = [ch.sample_ext()
                      for _ in range(air.num_perm_challenges)]
        ch.observe_many(proof.perm_root)
    alpha = ch.sample_ext()
    ch.observe_many(proof.quotient_root)
    zeta = ch.sample_ext()
    for v in (proof.trace_local_evals + proof.trace_next_evals
              + proof.perm_local_evals + proof.perm_next_evals
              + proof.quotient_evals):
        ch.observe_ext(v)
    beta = ch.sample_ext()
    fold_betas = []
    for root in proof.fri_roots:
        ch.observe_many(root)
        fold_betas.append(ch.sample_ext())
    for v in proof.fri_final:
        ch.observe_ext(v)
    _check(ch.check_witness(config.pow_bits, proof.pow_witness),
           "grinding check failed")
    query_indices = [ch.sample_bits(log_N) for _ in range(config.num_queries)]

    # --- DEEP-ALI constraint identity at ζ --------------------------------
    z_h = zeta**n - 1
    g_last = pow(g, n - 1, P)
    sels = {
        "is_first_row": z_h / (zeta - 1),
        "is_last_row": z_h / (zeta - g_last),
        "is_transition": zeta - g_last,
    }
    periodic_at_zeta = [
        _eval_periodic(pattern, zeta, n) for pattern in air.periodic_columns()
    ]
    folded = air.fold_constraints_scalar(
        proof.trace_local_evals, proof.trace_next_evals,
        proof.public_values, sels, alpha, periodic=periodic_at_zeta,
        perm_local=proof.perm_local_evals,
        perm_next=proof.perm_next_evals,
        challenges=challenges,
    )
    zeta_n = zeta**n
    q_at_zeta = Fp4(0)
    zpow = Fp4(1)
    for k in range(config.blowup):
        chunk = Fp4(0)
        for ell in range(4):
            chunk = chunk + _EXT_BASIS[ell] * proof.quotient_evals[4 * k + ell]
        q_at_zeta = q_at_zeta + zpow * chunk
        zpow = zpow * zeta_n
    _check(folded == z_h * q_at_zeta, "constraint identity failed at zeta")

    # --- per-query checks -------------------------------------------------
    g_zeta = zeta * g
    for qp, expect_index in zip(proof.queries, query_indices):
        _check(qp.index == expect_index, "query index mismatch")
        q = qp.index
        _check(len(qp.trace_row) == w, "bad trace row width")
        _check(len(qp.quotient_row) == n_qcols, "bad quotient row width")
        _check(
            verify_path(hash_row_ints([v % P for v in qp.trace_row]), q,
                        qp.trace_path, proof.trace_root),
            "trace Merkle path failed",
        )
        _check(
            verify_path(hash_row_ints([v % P for v in qp.quotient_row]), q,
                        qp.quotient_path, proof.quotient_root),
            "quotient Merkle path failed",
        )
        if pw:
            _check(len(qp.perm_row) == pw, "bad perm row width")
            _check(
                verify_path(hash_row_ints([v % P for v in qp.perm_row]), q,
                            qp.perm_path, proof.perm_root),
                "perm Merkle path failed",
            )
        x = Fp4(s * pow(w_N, q, P) % P)
        # DEEP composition value from the openings — β-power order matches
        # the prover: ζ-group [trace ‖ perm ‖ quotient], g·ζ-group
        # [trace ‖ perm]
        num_z = Fp4(0)
        bpow = Fp4(1)
        for j in range(w):
            num_z = num_z + bpow * (Fp4(qp.trace_row[j])
                                    - proof.trace_local_evals[j])
            bpow = bpow * beta
        for j in range(pw):
            num_z = num_z + bpow * (Fp4(qp.perm_row[j])
                                    - proof.perm_local_evals[j])
            bpow = bpow * beta
        for c in range(n_qcols):
            num_z = num_z + bpow * (Fp4(qp.quotient_row[c])
                                    - proof.quotient_evals[c])
            bpow = bpow * beta
        num_gz = Fp4(0)
        for j in range(w):
            num_gz = num_gz + bpow * (Fp4(qp.trace_row[j])
                                      - proof.trace_next_evals[j])
            bpow = bpow * beta
        for j in range(pw):
            num_gz = num_gz + bpow * (Fp4(qp.perm_row[j])
                                      - proof.perm_next_evals[j])
            bpow = bpow * beta
        f_val = num_z / (x - zeta) + num_gz / (x - g_zeta)

        # FRI chain
        qq = q
        cur_shift = s
        for ell, step in enumerate(qp.fri_steps):
            size_l = 1 << (log_N - ell)
            half = size_l // 2
            j = qq % half
            # Merkle check of the pair leaf
            row = [c for v in step.pair for c in v.c]
            _check(
                verify_path(hash_row_ints(row), j, step.path,
                            proof.fri_roots[ell]),
                f"FRI layer {ell} Merkle path failed",
            )
            mine = step.pair[0] if qq < half else step.pair[1]
            _check(mine == f_val, f"FRI layer {ell} value mismatch")
            # fold
            x_j = Fp4(cur_shift * pow(two_adic_root(log_N - ell), j, P) % P)
            a, b = step.pair
            f_val = (a + b) / 2 + fold_betas[ell] * (a - b) / (2 * x_j)
            cur_shift = cur_shift * cur_shift % P
            qq = j
        _check(f_val == proof.fri_final[qq], "FRI final value mismatch")

    # --- FRI final layer is low-degree ------------------------------------
    _final_low_degree(proof.fri_final, config, log_N, n_layers)
    return True


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
