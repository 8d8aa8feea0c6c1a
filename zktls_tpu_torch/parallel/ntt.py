"""Multi-device NTT: the four-step (Cooley–Tukey n = n1·n2) factorization
with its transpose as an all-to-all between the devices of a mesh axis —
the port's counterpart of zktls_tpu.parallel.ntt.

Derivation (forward transform, natural-order input and output):
  j = j1 + n1·j2,  k = k2 + n2·k1
  X[n2·k1 + k2] = NTT_n1^{(j1)} [ w^{j1·k2} · NTT_n2^{(j2)} x[j1 + n1·j2] ]

so with M[j1, j2] = x[j1 + n1·j2], log n1 = ⌊log n / 2⌋:
  step 1: NTTs of M along j2, row by row — local to the device holding
          the rows (M is split by rows j1 with torch.tensor_split, so
          uneven splits work as in JAX);
  step 2: twiddle multiply by w^{j1·k2}, local;
  step 3: NTTs along j1 — the all-to-all first: device d sends the k2
          slice of its rows that device e owns (peer copies, `.to(e)`),
          then each device transforms its k2 slice; the slices are
          gathered onto the input's device.

The local transforms are ops.ntt.ntt.  The inverse is the forward
transform with its output index-reversed, times n⁻¹:
INTT(x)[k] = NTT(x)[−k] / n.  Every value equals ops.ntt's (exact field
arithmetic).  A mesh entry that repeats is one logical shard (mesh.py).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..ops import babybear as bb
from ..ops.field_ref import P, two_adic_root
from ..ops.ntt import _coset_powers, ntt, powers

__all__ = ["ntt_sharded", "make_ntt_sharded", "make_coset_lde_sharded"]


@lru_cache(maxsize=None)
def _twiddle_matrix(log_n1: int, log_n2: int) -> np.ndarray:
    """w^{j1·k2} as an (n1, n2) Montgomery matrix, w the 2^(log_n1 +
    log_n2)-th root of unity."""
    log_n = log_n1 + log_n2
    w_pows = powers(two_adic_root(log_n), 1 << log_n)
    exps = np.outer(np.arange(1 << log_n1, dtype=np.int64),
                    np.arange(1 << log_n2, dtype=np.int64))   # < n
    return bb.np_to_mont(w_pows[exps].astype(np.uint32))


@lru_cache(maxsize=None)
def _twiddle_rows(log_n1: int, log_n2: int, start: int, stop: int,
                  device: torch.device) -> torch.Tensor:
    """Rows [start, stop) of the twiddle matrix on `device`, (rows, n2, 1)."""
    return bb.from_numpy(_twiddle_matrix(log_n1, log_n2)[start:stop],
                         device)[:, :, None]


def _four_step_cols(x: torch.Tensor, log_n1: int, log_n2: int,
                    devices: list) -> torch.Tensor:
    """Forward NTT of an (n, C) Montgomery matrix along dim 0 as a
    four-step sharded over `devices`; the result lands on x's device."""
    n1, n2 = 1 << log_n1, 1 << log_n2
    cols = x.shape[1]
    home = x.device
    m = x.reshape(n2, n1, cols).transpose(0, 1)        # M[j1, j2, c]
    # steps 1 and 2 on each device's rows j1
    rows, start = [], 0
    for dev, blk in zip(devices, torch.tensor_split(m, len(devices))):
        r = blk.shape[0]
        a = blk.to(dev, non_blocking=True).transpose(0, 1).reshape(
            n2, r * cols)
        a = ntt(a).view(n2, r, cols).transpose(0, 1)   # (j1, k2, c)
        rows.append(bb.mul(a, _twiddle_rows(log_n1, log_n2, start,
                                            start + r, dev)))
        start += r
    # the all-to-all, then step 3 on each device's k2 slice
    slices = [torch.tensor_split(a, len(devices), dim=1) for a in rows]
    outs = []
    for e, dev in enumerate(devices):
        b = torch.cat([s[e].to(dev, non_blocking=True) for s in slices])
        o = ntt(b.reshape(n1, -1)).view(n1, -1, cols)   # (k1, k2, c)
        outs.append(o.to(home, non_blocking=home.type == "cuda"))
    # X[n2·k1 + k2] row-major
    return torch.cat(outs, dim=1).reshape(n1 * n2, cols)


def _split(log_n: int) -> tuple[int, int]:
    return log_n // 2, log_n - log_n // 2


def _log2(n: int) -> int:
    log_n = n.bit_length() - 1
    if 1 << log_n != n:
        raise ValueError("size must be a power of two")
    return log_n


def _four_step(x: torch.Tensor, log_n1: int, log_n2: int,
               devices: list) -> torch.Tensor:
    """x: (n,) or (n, C) Montgomery.  Returns the NTT along dim 0 in
    natural order."""
    if x.ndim == 1:
        return _four_step_cols(x[:, None], log_n1, log_n2, devices)[:, 0]
    return _four_step_cols(x, log_n1, log_n2, devices)


def _four_step_inverse_fix(x: torch.Tensor, log_n1: int, log_n2: int,
                           devices: list) -> torch.Tensor:
    """Inverse NTT via the forward four-step: the sub-transforms would need
    inverse roots too, so take the forward result at −k instead and scale
    by n⁻¹."""
    fwd = _four_step(x, log_n1, log_n2, devices)
    n_inv_m = pow(x.shape[0], P - 2, P) * bb.MONT_R % P
    return bb.mul(torch.cat([fwd[:1], fwd[1:].flip(0)]), n_inv_m)


def make_ntt_sharded(mesh, axis: str = "ntt"):
    """A sharded-NTT callable `fn(x, inverse=False)` over the devices of
    the mesh axis: x is (n,) or (n, C) Montgomery, n a power of two; the
    result is on x's device and equals ops.ntt.ntt / intt."""
    devices = mesh.axis_devices(axis)

    def ntt_fn(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
        fn = _four_step_inverse_fix if inverse else _four_step
        return fn(x, *_split(_log2(x.shape[0])), devices)

    return ntt_fn


def ntt_sharded(x: torch.Tensor, mesh, axis: str = "ntt",
                inverse: bool = False) -> torch.Tensor:
    return make_ntt_sharded(mesh, axis)(x, inverse=inverse)


def make_coset_lde_sharded(mesh, axis: str = "ntt"):
    """A drop-in replacement for ops.ntt.coset_lde, `fn(values,
    log_blowup, shift)`, whose two transforms run as four-steps sharded
    over the mesh axis — the machine prover's intra-proof model-parallel
    LDE.  The extension lands on the values' device and equals the local
    coset_lde."""
    devices = mesh.axis_devices(axis)

    def lde_fn(values: torch.Tensor, log_blowup: int,
               shift: int) -> torch.Tensor:
        n, cols = values.shape
        log_n = _log2(n)
        coeffs = _four_step_inverse_fix(values, *_split(log_n), devices)
        coeffs = bb.mul(coeffs, bb.from_numpy(
            _coset_powers(log_n, shift), values.device)[:, None])
        coeffs = torch.cat([coeffs, coeffs.new_zeros(
            ((n << log_blowup) - n, cols))])
        return _four_step_cols(coeffs, *_split(log_n + log_blowup), devices)

    return lde_fn
