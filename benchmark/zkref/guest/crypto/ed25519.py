"""Ed25519 signature verification (RFC 8032).

rustls-webpki accepts Ed25519 certificate signatures and the recorded client
offers the ed25519 signature algorithm (SURVEY.md §2.3), so chain
verification must support it.

Port copy of zktls_tpu.guest.crypto.ed25519 (same names and values).
"""

from __future__ import annotations

import hashlib

from .modmul import invmod, mulmod

__all__ = ["ed25519_verify"]

_P = 2**255 - 19
_L = 2**252 + 27742317777372353535851937790883648493
_D = -121665 * pow(121666, _P - 2, _P) % _P
_I = pow(2, (_P - 1) // 4, _P)


def _recover_x(y: int, sign: int) -> int | None:
    from .modmul import powmod

    if y >= _P:
        return None
    yy = mulmod(y, y, _P)
    x2 = mulmod((yy - 1) % _P, invmod((mulmod(_D, yy, _P) + 1) % _P, _P), _P)
    x = powmod(x2, (_P + 3) // 8, _P)
    if (mulmod(x, x, _P) - x2) % _P != 0:
        x = mulmod(x, _I, _P)
    if (mulmod(x, x, _P) - x2) % _P != 0:
        return None
    if x & 1 != sign:
        x = _P - x
    return x


def _decode_point(s: bytes) -> tuple[int, int] | None:
    y = int.from_bytes(s, "little") & ((1 << 255) - 1)
    sign = s[31] >> 7
    x = _recover_x(y, sign)
    if x is None:
        return None
    return (x, y)


def _edwards_add(P1, P2):
    """Affine Edwards addition; every field mul/inverse is recorded for
    the 256-bit ModMul chip (modulus 2^255 − 19)."""
    x1, y1 = P1
    x2, y2 = P2
    x1x2 = mulmod(x1, x2, _P)
    y1y2 = mulmod(y1, y2, _P)
    x1y2 = mulmod(x1, y2, _P)
    x2y1 = mulmod(x2, y1, _P)
    dxxyy = mulmod(mulmod(_D, x1x2, _P), y1y2, _P)
    x3 = mulmod((x1y2 + x2y1) % _P, invmod((1 + dxxyy) % _P, _P), _P)
    y3 = mulmod((y1y2 + x1x2) % _P, invmod((1 - dxxyy) % _P, _P), _P)
    return (x3, y3)


def _scalar_mul(k: int, P1):
    Q = (0, 1)
    while k:
        if k & 1:
            Q = _edwards_add(Q, P1)
        P1 = _edwards_add(P1, P1)
        k >>= 1
    return Q


_BX = 15112221349535400772501151409588531511454012693041857206046113283949847762202
_BY = 46316835694926478169428394003475163141307993866256225615783033603165251855960
_B = (_BX, _BY)


def ed25519_verify(public_key: bytes, message: bytes, signature: bytes) -> bool:
    if len(public_key) != 32 or len(signature) != 64:
        return False
    A = _decode_point(public_key)
    R = _decode_point(signature[:32])
    if A is None or R is None:
        return False
    s = int.from_bytes(signature[32:], "little")
    if s >= _L:
        return False
    h = hashlib.sha512(signature[:32] + public_key + message).digest()
    k = int.from_bytes(h, "little") % _L
    # check s·B == R + k·A
    lhs = _scalar_mul(s, _B)
    rhs = _edwards_add(R, _scalar_mul(k, A))
    return lhs == rhs
