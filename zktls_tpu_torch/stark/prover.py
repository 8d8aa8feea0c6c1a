"""Prover building blocks on torch tensors: out-of-domain evaluation, the
DEEP composition, the FRI fold and proof-of-work grinding.

Port of the helpers of zktls_tpu.stark.prover that the machine prover
(stark/machine.py) uses.  Field tensors are Montgomery form
(ops/babybear.py); host values are plain ints and Fp4.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import babybear as bb
from ..ops import ext as ex
from ..ops.field_ref import Fp4, P
from ..ops.ntt import eval_domain, np_batch_inverse
from ..ops.poseidon2 import permute_batch
from .challenger import Challenger
from .lookup import np_ext_powers


def _ext_evals_at(coeffs: torch.Tensor, zpows: torch.Tensor) -> np.ndarray:
    """Evaluate base-coefficient polynomials at an extension point.
    coeffs (n, C) Montgomery, zpows (n, 4) Montgomery powers of the point.
    Returns (C, 4) plain-form numpy."""
    out = torch.stack([bb.dot_mod(coeffs, zpows[:, ell : ell + 1], dim=0)
                       for ell in range(4)], dim=-1)
    return bb.np_from_mont(bb.to_numpy(out))


def _zeta_powers(zeta: Fp4, n: int, device) -> torch.Tensor:
    """(n, 4) Montgomery powers [1, ζ, …, ζ^{n−1}] on `device`."""
    return bb.from_numpy(bb.np_to_mont(np_ext_powers(zeta, n).astype(
        np.uint32)), device)


def _pair_rows(values: torch.Tensor) -> torch.Tensor:
    """FRI layer values (N, 4) -> Merkle rows (N/2, 8): leaf j holds
    (f[j], f[j+N/2])."""
    half = values.shape[0] // 2
    return torch.cat([values[:half], values[half:]], dim=1)


_INV2_M = pow(2, P - 2, P) * bb.MONT_R % P


def _fold_layer(values: torch.Tensor, beta: Fp4, inv_2x: np.ndarray
                ) -> torch.Tensor:
    """One FRI fold: f'(x²) = (f(x)+f(−x))/2 + β·(f(x)−f(−x))/(2x)."""
    half = values.shape[0] // 2
    dev = values.device
    a, b = values[:half], values[half:]
    even = ex.ext_scale(ex.ext_add(a, b), _INV2_M)
    odd = ex.ext_scale(ex.ext_sub(a, b), bb.from_numpy(inv_2x, dev))
    beta_b = bb.from_numpy(ex.from_fp4(beta), dev).expand(half, 4)
    return ex.ext_add(even, ex.ext_mul(beta_b, odd))


def _deep_fn(mat_z: torch.Tensor, mat_gz: torch.Tensor,
             bpow_m: torch.Tensor, ev_z: torch.Tensor, ev_gz: torch.Tensor,
             inv_x_zeta: torch.Tensor, inv_x_gzeta: torch.Tensor
             ) -> torch.Tensor:
    """DEEP composition in matvec form:

      Σ_j β^j (V_j(x) − v_j)  =  (Σ_j β^j V_j(x))  −  (Σ_j β^j v_j)

    so each opening group costs 4 modular matvecs (one per extension limb)
    plus a broadcast constant.  The ζ-group matrix is [trace ‖ perm ‖
    quotient] columns, the g·ζ-group is [trace ‖ perm].  bpow_m holds the
    ζ-group's β powers, then the g·ζ-group's."""
    w_z = mat_z.shape[1]

    def group_numer(mat, betas, evals):
        comb = torch.stack([bb.dot_mod(mat, betas[None, :, ell], dim=1)
                            for ell in range(4)], dim=-1)      # (N, 4)
        const = bb.sum_mod(ex.ext_mul(betas, evals), dim=0)    # (4,)
        return ex.ext_sub(comb, const[None, :])

    numer_z = group_numer(mat_z, bpow_m[:w_z], ev_z)
    numer_gz = group_numer(mat_gz, bpow_m[w_z:], ev_gz)
    return ex.ext_add(ex.ext_mul(numer_z, inv_x_zeta),
                      ex.ext_mul(numer_gz, inv_x_gzeta))


def _grind_device(ch: Challenger, pow_bits: int, device) -> int:
    """Proof-of-work grinding, batched: try candidate witnesses in one
    permutation batch instead of a sequential host loop.  Mirrors
    Challenger.observe(w); sample_bits(pow_bits) == 0: the candidate joins
    the pending input buffer, the duplex permutes, and the check reads rate
    lane 7 (the first popped output).  Returns the first passing candidate
    in batch order."""
    base = np.array(ch.state, dtype=np.uint32)
    buf = [v % P for v in ch.input_buf]
    if len(buf) >= 8:
        raise AssertionError("challenger buffer cannot be full here")
    batch = 1 << min(pow_bits + 3, 18)
    mask = (1 << pow_bits) - 1
    offset = 0
    # Expected tries ≈ 2^pow_bits; needing more than 2^(pow_bits+16) has
    # probability ~e^-65536 — treat it as a bug, not luck.
    max_offset = 1 << (pow_bits + 16)
    while offset < max_offset:
        states = np.tile(base, (batch, 1))
        if buf:
            states[:, : len(buf)] = np.array(buf, dtype=np.uint32)
        cands = (np.arange(batch, dtype=np.uint64) + offset) % P
        states[:, len(buf)] = cands.astype(np.uint32)
        out = bb.np_from_mont(bb.to_numpy(permute_batch(
            bb.from_numpy(bb.np_to_mont(states), device))))
        hits = np.nonzero((out[:, 7] & mask) == 0)[0]
        if hits.size:
            return int(cands[hits[0]])
        offset += batch
    raise AssertionError(
        f"grinding found no witness in 2^{pow_bits + 16} tries — "
        "challenger/permute mismatch, not bad luck")


def _inv_2x(log_size: int, shift: int) -> np.ndarray:
    """Montgomery (N/2,) array of 1/(2·x_j) for the layer domain."""
    xs = eval_domain(log_size, shift)[: (1 << log_size) // 2]
    invs = np_batch_inverse(2 * xs.astype(np.uint64) % P)
    return bb.np_to_mont(invs.astype(np.uint32))
