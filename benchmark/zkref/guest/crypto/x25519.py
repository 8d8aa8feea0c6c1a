"""X25519 (RFC 7748) scalar multiplication.

The recorded client offers an x25519 key_share in its ClientHello (tape bytes
random[0:32] are the private scalar — verified in SURVEY.md §2.3 against the
fixture's key_share).  Needed both to re-derive the ClientHello
deterministically and for TLS 1.3 sessions that negotiate x25519.

Port copy of zktls_tpu.guest.crypto.x25519 (same names and values).
"""

from __future__ import annotations

from .modmul import invmod, mulmod

__all__ = ["x25519", "x25519_base"]

_P = 2**255 - 19
_A24 = 121665


def _clamp(k: bytes) -> int:
    a = bytearray(k)
    a[0] &= 248
    a[31] &= 127
    a[31] |= 64
    return int.from_bytes(a, "little")


def x25519(k: bytes, u: bytes) -> bytes:
    """RFC 7748 §5 Montgomery ladder."""
    if len(k) != 32 or len(u) != 32:
        raise ValueError("x25519 operands must be 32 bytes")
    k_int = _clamp(k)
    u_int = int.from_bytes(u, "little") & (2**255 - 1)

    x1 = u_int
    x2, z2 = 1, 0
    x3, z3 = u_int, 1
    swap = 0
    for t in range(254, -1, -1):
        k_t = (k_int >> t) & 1
        swap ^= k_t
        if swap:
            x2, x3 = x3, x2
            z2, z3 = z3, z2
        swap = k_t
        # every field multiplication goes through the ModMul recorder so
        # the ladder is proven by the 256-bit chip (modulus 2^255 − 19)
        A = (x2 + z2) % _P
        AA = mulmod(A, A, _P)
        B = (x2 - z2) % _P
        BB = mulmod(B, B, _P)
        E = (AA - BB) % _P
        C = (x3 + z3) % _P
        D = (x3 - z3) % _P
        DA = mulmod(D, A, _P)
        CB = mulmod(C, B, _P)
        x3 = (DA + CB) % _P
        x3 = mulmod(x3, x3, _P)
        z3 = (DA - CB) % _P
        z3 = mulmod(x1, mulmod(z3, z3, _P), _P)
        x2 = mulmod(AA, BB, _P)
        z2 = mulmod(E, (AA + _A24 * E) % _P, _P)
    if swap:
        x2, x3 = x3, x2
        z2, z3 = z3, z2
    out = mulmod(x2, invmod(z2, _P) if z2 else 0, _P) if z2 else 0
    return out.to_bytes(32, "little")


def x25519_base(k: bytes) -> bytes:
    return x25519(k, (9).to_bytes(32, "little"))
