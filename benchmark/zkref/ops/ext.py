"""Quartic-extension arithmetic as torch ops: F_p4 = F_p[x]/(x^4 - 11) as
(..., 4) Montgomery field tensors.

Counterpart of zktls_tpu.ops.ext.  STARK challenges, the folded
constraint accumulator, the DEEP composition polynomial and all FRI
layers live in the extension field.
"""

from __future__ import annotations

import numpy as np
import torch

from . import babybear as bb
from .field_ref import P, W_EXT, Fp4

__all__ = [
    "ext_add", "ext_sub", "ext_neg", "ext_mul", "ext_scale", "ext_inv",
    "ext_pow", "ext_from_base", "to_fp4", "from_fp4",
]

_W_MONT = int(bb.np_to_mont(np.array([W_EXT], dtype=np.uint32))[0])


def ext_from_base(x: torch.Tensor) -> torch.Tensor:
    """Base elements (...,) -> ext (..., 4) with zero high coefficients."""
    z = torch.zeros(x.shape + (3,), dtype=x.dtype, device=x.device)
    return torch.cat([x[..., None], z], dim=-1)


def ext_add(a, b):
    return bb.add(a, b)


def ext_sub(a, b):
    return bb.sub(a, b)


def ext_neg(a):
    return bb.neg(a)


def ext_scale(a, s):
    """ext (..., 4) times base (...,) or a Python-int Montgomery scalar."""
    if isinstance(s, torch.Tensor):
        s = s[..., None]
    return bb.mul(a, s)


def ext_mul(a, b):
    """Schoolbook product with the x^4 -> W fold: 16 base muls."""
    a0, a1, a2, a3 = (a[..., i] for i in range(4))
    b0, b1, b2, b3 = (b[..., i] for i in range(4))
    m = bb.mul
    add = bb.add

    def wmul(x):
        return m(x, _W_MONT)

    c0 = add(m(a0, b0), wmul(add(add(m(a1, b3), m(a2, b2)), m(a3, b1))))
    c1 = add(add(m(a0, b1), m(a1, b0)), wmul(add(m(a2, b3), m(a3, b2))))
    c2 = add(add(m(a0, b2), add(m(a1, b1), m(a2, b0))), wmul(m(a3, b3)))
    c3 = add(add(m(a0, b3), m(a1, b2)), add(m(a2, b1), m(a3, b0)))
    return torch.stack([c0, c1, c2, c3], dim=-1)


def ext_pow(a, e: int):
    out = ext_from_base(torch.full(a.shape[:-1], bb.MONT_R, dtype=a.dtype,
                                   device=a.device))
    base = a
    while e:
        if e & 1:
            out = ext_mul(out, base)
        base = ext_mul(base, base)
        e >>= 1
    return out


_F1 = pow(W_EXT, (P - 1) // 4, P)
#: Frobenius twists x -> x^(p^k), k = 1, 2, 3, Montgomery form
_FROB = bb.np_to_mont(np.array(
    [[1, _F1, _F1 * _F1 % P, _F1 * _F1 % P * _F1 % P],
     [1, _F1 * _F1 % P, pow(_F1, 4, P), pow(_F1, 6, P)],
     [1, pow(_F1, 3, P), pow(_F1, 6, P), pow(_F1, 9, P)]], dtype=np.uint32))


def ext_inv(a):
    """Inverse via the norm map: a^-1 = conj(a) / N(a), N(a) ∈ F_p.
    conj(a) = a^p · a^(p²) · a^(p³) computed with Frobenius twists."""
    tw = bb.from_numpy(_FROB, a.device)
    a_p = bb.mul(a, tw[0])
    a_p2 = bb.mul(a, tw[1])
    a_p3 = bb.mul(a, tw[2])
    conj = ext_mul(ext_mul(a_p, a_p2), a_p3)
    norm = ext_mul(a, conj)[..., 0]  # lands in the base field
    return ext_scale(conj, bb.inv(norm))


# ---------------------------------------------------------------------------
# host conversions
# ---------------------------------------------------------------------------


def to_fp4(arr) -> Fp4:
    """Single ext element (4,) Montgomery tensor -> host Fp4."""
    plain = bb.np_from_mont(bb.to_numpy(arr))
    return Fp4(*[int(x) for x in plain])


def from_fp4(v: Fp4) -> np.ndarray:
    """Host Fp4 -> (4,) Montgomery uint32 numpy."""
    return bb.np_to_mont(np.array(v.c, dtype=np.uint32))
