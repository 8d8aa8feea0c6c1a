"""Number-theoretic transform (radix-2) and low-degree extension over
Baby-Bear as torch ops, batched over the columns of an (n, C) matrix.

Counterpart of zktls_tpu.ops.ntt: one bit-reversal gather, then log2(n)
decimation-in-time stages written as reshapes and slices; Montgomery
values in and out; twiddle tables built on the host (numpy, exact) and
cached per size and device.

From n = 2^_FOUR_STEP_LOG up, as in the reference, `ntt` takes the
four-step split (n = n1·n2: size-n1 column transforms, a twiddle
multiply, a transpose, size-n2 row transforms; `_ntt_four_step`).  It
gives radix-2's values; on an H100 it was 4 % faster at 2^23 and 2^25
rows and held one more copy of the matrix (PERF.md §5).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from . import babybear as bb
from .field_ref import P, two_adic_root

__all__ = ["ntt", "intt", "coset_lde", "coeffs_to_coset_evals",
           "coset_coeffs", "bitrev_indices", "eval_domain", "powers",
           "np_batch_inverse", "LDE_BLOCK_BYTES"]

#: `coset_lde` extends a matrix in column blocks of at most this many
#: output bytes (int64): a whole (2^25, 40) perm extension, 10.7 GB, would
#: hold several times its size in butterfly temporaries at once
LDE_BLOCK_BYTES = float(1 << 32)
#: `ntt` takes the four-step split from n = 2^this up (the reference's)
_FOUR_STEP_LOG = 23


def powers(base: int, n: int) -> np.ndarray:
    """[1, base, base², …, base^{n−1}] mod p as uint64 numpy (by doubling:
    log n vector multiplies)."""
    out = np.empty(max(n, 1), dtype=np.uint64)
    out[0] = 1
    k = 1
    bk = base % P                                   # base^k
    while k < n:
        m = min(k, n - k)
        out[k : k + m] = out[:m] * np.uint64(bk) % np.uint64(P)
        bk = bk * bk % P
        k *= 2
    return out[:n]


def np_batch_inverse(vals: np.ndarray) -> np.ndarray:
    """Inverses of nonzero field values (plain form, any integer dtype) as
    uint64 numpy: `field_ref.batch_inverse` over a product tree — the
    pairwise products level by level up, one inverse at the root, each
    node's inverse times its sibling level by level down — so 3n
    vectorized products instead of n Python ones."""
    levels = [np.asarray(vals, dtype=np.uint64) % np.uint64(P)]
    while levels[-1].shape[0] > 1:
        x = levels[-1]
        if x.shape[0] % 2:
            x = np.append(x, np.uint64(1))
        levels.append(x[0::2] * x[1::2] % np.uint64(P))
    if not levels[-1].shape[0]:
        return levels[-1]
    inv = np.array([pow(int(levels[-1][0]), P - 2, P)], dtype=np.uint64)
    for x in reversed(levels[:-1]):
        m = x.shape[0]
        if m % 2:
            x = np.append(x, np.uint64(1))
        out = np.empty(x.shape[0], dtype=np.uint64)
        out[0::2] = inv * x[1::2] % np.uint64(P)
        out[1::2] = inv * x[0::2] % np.uint64(P)
        inv = out[:m]
    return inv


@lru_cache(maxsize=None)
def bitrev_indices(log_n: int) -> np.ndarray:
    n = 1 << log_n
    idx = np.arange(n, dtype=np.uint32)
    rev = np.zeros(n, dtype=np.uint32)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


@lru_cache(maxsize=None)
def _twiddles(log_n: int, inverse: bool) -> tuple[np.ndarray, ...]:
    """Per-stage twiddle tables, Montgomery form.  Stage s (half-block
    m = 2^s) uses w_{2m}^j for j in [0, m)."""
    root = two_adic_root(log_n)
    if inverse:
        root = pow(root, P - 2, P)
    return tuple(
        bb.np_to_mont(powers(pow(root, 1 << (log_n - 1 - s), P), 1 << s))
        for s in range(log_n))


@lru_cache(maxsize=None)
def _ntt_args(log_n: int, inverse: bool, device: torch.device):
    rev = torch.from_numpy(bitrev_indices(log_n).astype(np.int64)).to(device)
    tws = tuple(bb.from_numpy(t, device) for t in _twiddles(log_n, inverse))
    return rev, tws


@lru_cache(maxsize=None)
def _four_step_tw(log_n: int, inverse: bool) -> np.ndarray:
    """(n1, n2) twiddle matrix w_n^{j2·k1} for the four-step split,
    Montgomery form (host-cached)."""
    log1 = (log_n + 1) // 2
    n1, n2 = 1 << log1, 1 << (log_n - log1)
    w = two_adic_root(log_n)
    if inverse:
        w = pow(w, P - 2, P)
    base = powers(w, n1)                               # w^k1
    tw = np.empty((n1, n2), dtype=np.uint64)
    tw[:, 0] = 1
    for j2 in range(1, n2):
        tw[:, j2] = tw[:, j2 - 1] * base % np.uint64(P)
    return bb.np_to_mont(tw.astype(np.uint32))


@lru_cache(maxsize=None)
def _four_step_tw_dev(log_n: int, inverse: bool, device: torch.device):
    return bb.from_numpy(_four_step_tw(log_n, inverse), device)


def _ntt_four_step(x: torch.Tensor, log_n: int, inverse: bool
                   ) -> torch.Tensor:
    """n = n1·n2 split of an (n, C) matrix: column NTTs (size n1), twiddle
    multiply, transpose, row NTTs (size n2); the 1/n of an inverse is
    spread over the two sub-transforms."""
    n = 1 << log_n
    cols = x.shape[1]
    log1 = (log_n + 1) // 2
    n1, n2 = 1 << log1, 1 << (log_n - log1)
    a = _ntt_radix2(x.reshape(n1, n2 * cols), inverse)   # size-n1
    tw = _four_step_tw_dev(log_n, inverse, x.device)      # (n1, n2)
    a = bb.mul(a.view(n1, n2, cols), tw[:, :, None])
    a = a.transpose(0, 1).reshape(n2, n1 * cols)
    a = _ntt_radix2(a, inverse)                           # size-n2
    # in-order output: element [k2, k1] sits at index k1 + n1·k2 — the
    # C-order reshape of the (n2, n1) layout is exactly that
    return a.reshape(n, cols)


def ntt(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """In-order -> in-order NTT along dim 0; x is (n,) or (n, C) in
    Montgomery form.  inverse=True includes the 1/n scaling."""
    n = x.shape[0]
    log_n = n.bit_length() - 1
    if 1 << log_n != n:
        raise ValueError(f"NTT size must be a power of two, got {n}")
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    if log_n >= _FOUR_STEP_LOG:
        x = _ntt_four_step(x, log_n, inverse)
    else:
        x = _ntt_radix2(x, inverse)
    return x[:, 0] if squeeze else x


def _ntt_radix2(x: torch.Tensor, inverse: bool) -> torch.Tensor:
    """The radix-2 NTT of an (n, C) matrix along dim 0."""
    n, cols = x.shape
    log_n = n.bit_length() - 1
    rev, tws = _ntt_args(log_n, inverse, x.device)
    x = x[rev]
    for s in range(log_n):
        m = 1 << s
        v = x.view(n // (2 * m), 2, m, cols)
        a = v[:, 0]
        b = bb.mul(v[:, 1], tws[s].view(1, m, 1))
        x = torch.stack([bb.add(a, b), bb.sub(a, b)], dim=1).view(n, cols)
    if inverse:
        x = bb.mul(x, int(bb.np_to_mont(np.array([pow(n, P - 2, P)],
                                                 dtype=np.uint32))[0]))
    return x


def intt(x: torch.Tensor) -> torch.Tensor:
    return ntt(x, inverse=True)


@lru_cache(maxsize=None)
def _coset_powers(log_n: int, shift: int) -> np.ndarray:
    return bb.np_to_mont(powers(shift, 1 << log_n))


def _scale_rows(x: torch.Tensor, log_n: int, shift: int) -> torch.Tensor:
    scale = bb.from_numpy(_coset_powers(log_n, shift), x.device)
    if x.ndim == 2:
        scale = scale[:, None]
    return bb.mul(x, scale)


def coeffs_to_coset_evals(coeffs: torch.Tensor, log_blowup: int,
                          shift: int) -> torch.Tensor:
    """Coefficients (n, C) of a degree-<n polynomial -> evaluations on the
    coset shift·H of the size n·2^log_blowup subgroup.  Montgomery in/out."""
    n = coeffs.shape[0]
    coeffs = _scale_rows(coeffs, n.bit_length() - 1, shift)
    pad = torch.zeros(((1 << log_blowup) * n - n,) + coeffs.shape[1:],
                      dtype=coeffs.dtype, device=coeffs.device)
    return ntt(torch.cat([coeffs, pad], dim=0))


def coset_lde(values: torch.Tensor, log_blowup: int, shift: int
              ) -> torch.Tensor:
    """Low-degree extension: `values` (n, C) are evaluations on the size-n
    subgroup; return evaluations on the coset shift·H of the size
    n·2^log_blowup subgroup.  Montgomery in/out.

    A matrix whose extension passes LDE_BLOCK_BYTES (int64; on the CPU
    also bb.CPU_BLOCK_BYTES) is extended in column blocks of at most that
    many bytes, written into one output: columns are independent, so the
    values are the same, and the butterflies' temporaries are a block's,
    not the whole matrix's."""
    N = values.shape[0] << log_blowup
    cols = values.shape[1] if values.ndim == 2 else 1
    limit = (LDE_BLOCK_BYTES if values.device.type != "cpu"
             else min(LDE_BLOCK_BYTES, bb.CPU_BLOCK_BYTES))
    if 8 * N * cols <= limit:
        return coeffs_to_coset_evals(intt(values), log_blowup, shift)
    step = max(1, int(limit // (8 * N)))
    out = torch.empty((N, cols), dtype=values.dtype, device=values.device)
    for c0 in range(0, cols, step):
        out[:, c0 : c0 + step] = coeffs_to_coset_evals(
            intt(values[:, c0 : c0 + step]), log_blowup, shift)
    return out


def coset_coeffs(values: torch.Tensor, shift: int) -> torch.Tensor:
    """Interpolate values (N, C) on the coset shift·H_N back to
    coefficients (undoes the coset scaling).  Montgomery in/out."""
    n = values.shape[0]
    return _scale_rows(intt(values), n.bit_length() - 1,
                       pow(shift, P - 2, P))


@lru_cache(maxsize=None)
def eval_domain(log_n: int, shift: int = 1) -> np.ndarray:
    """The points shift·w^i of the evaluation domain, plain form (host)."""
    return (powers(two_adic_root(log_n), 1 << log_n)
            * np.uint64(shift % P) % np.uint64(P)).astype(np.uint32)
