"""Short-Weierstrass elliptic curves: P-256, P-384, secp256k1.

Used by the guest replay for the ECDHE key exchange (P-256 in the fixture —
the recorded scalar at random[98:130] times the server's point yields the
premaster secret, SURVEY.md §2.3), for ECDSA certificate-signature
verification, and for the request-origin secp256k1 signature check.
Pure-Python big-int arithmetic; every modular multiplication/inversion of
the group law goes through `modmul.mulmod`/`invmod` so the ModMul AIR chip
(stark/chips/modmul.py) can prove the recorded event stream.

Port copy of zktls_tpu.guest.crypto.ec (same names and values; host code in
numpy).
"""

from __future__ import annotations

from dataclasses import dataclass

from .modmul import invmod, mulmod

__all__ = ["Curve", "P256", "P384", "SECP256K1", "Point", "ecdsa_verify",
           "ecdsa_recover"]

Point = tuple[int, int] | None  # affine; None = infinity


@dataclass(frozen=True)
class Curve:
    name: str
    p: int
    a: int
    b: int
    gx: int
    gy: int
    n: int  # group order

    # ---- point arithmetic (jacobian internally for speed) ----

    def is_on_curve(self, pt: Point) -> bool:
        if pt is None:
            return True
        x, y = pt
        return (y * y - (x * x * x + self.a * x + self.b)) % self.p == 0

    def add(self, P1: Point, P2: Point) -> Point:
        if P1 is None:
            return P2
        if P2 is None:
            return P1
        p = self.p
        x1, y1 = P1
        x2, y2 = P2
        if x1 == x2:
            if (y1 + y2) % p == 0:
                return None
            num = 3 * mulmod(x1, x1, p) + self.a
            m = mulmod(num, invmod(2 * y1, p), p)
        else:
            m = mulmod(y2 - y1, invmod(x2 - x1, p), p)
        x3 = (mulmod(m, m, p) - x1 - x2) % p
        y3 = (mulmod(m, x1 - x3, p) - y1) % p
        return (x3, y3)

    def mul(self, k: int, P1: Point) -> Point:
        k %= self.n
        result: Point = None
        addend = P1
        while k:
            if k & 1:
                result = self.add(result, addend)
            addend = self.add(addend, addend)
            k >>= 1
        return result

    @property
    def g(self) -> Point:
        return (self.gx, self.gy)

    @property
    def byte_len(self) -> int:
        return (self.p.bit_length() + 7) // 8

    # ---- SEC1 point codec ----

    def decode_point(self, data: bytes) -> Point:
        bl = self.byte_len
        if data[:1] == b"\x04" and len(data) == 1 + 2 * bl:
            x = int.from_bytes(data[1 : 1 + bl], "big")
            y = int.from_bytes(data[1 + bl :], "big")
        elif data[:1] in (b"\x02", b"\x03") and len(data) == 1 + bl:
            x = int.from_bytes(data[1:], "big")
            rhs = (x * x * x + self.a * x + self.b) % self.p
            y = pow(rhs, (self.p + 1) // 4, self.p)  # p ≡ 3 mod 4 for our curves
            if (y * y) % self.p != rhs:
                raise ValueError("point not on curve")
            if (y & 1) != (data[0] & 1):
                y = self.p - y
        else:
            raise ValueError("bad SEC1 point encoding")
        pt = (x, y)
        if not self.is_on_curve(pt):
            raise ValueError("point not on curve")
        return pt

    def encode_point(self, pt: Point, compressed: bool = False) -> bytes:
        if pt is None:
            raise ValueError("cannot encode infinity")
        bl = self.byte_len
        x, y = pt
        if compressed:
            return bytes([2 + (y & 1)]) + x.to_bytes(bl, "big")
        return b"\x04" + x.to_bytes(bl, "big") + y.to_bytes(bl, "big")


P256 = Curve(
    name="secp256r1",
    p=0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFF,
    a=-3 % 0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFF,
    b=0x5AC635D8AA3A93E7B3EBBD55769886BC651D06B0CC53B0F63BCE3C3E27D2604B,
    gx=0x6B17D1F2E12C4247F8BCE6E563A440F277037D812DEB33A0F4A13945D898C296,
    gy=0x4FE342E2FE1A7F9B8EE7EB4A7C0F9E162BCE33576B315ECECBB6406837BF51F5,
    n=0xFFFFFFFF00000000FFFFFFFFFFFFFFFFBCE6FAADA7179E84F3B9CAC2FC632551,
)

P384 = Curve(
    name="secp384r1",
    p=0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFFFF0000000000000000FFFFFFFF,
    a=-3 % 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFFFF0000000000000000FFFFFFFF,
    b=0xB3312FA7E23EE7E4988E056BE3F82D19181D9C6EFE8141120314088F5013875AC656398D8A2ED19D2A85C8EDD3EC2AEF,
    gx=0xAA87CA22BE8B05378EB1C71EF320AD746E1D3B628BA79B9859F741E082542A385502F25DBF55296C3A545E3872760AB7,
    gy=0x3617DE4A96262C6F5D9E98BF9292DC29F8F41DBD289A147CE9DA3113B5F0B8C00A60B1CE1D7E819D7A431D7C90EA0E5F,
    n=0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFC7634D81F4372DDF581A0DB248B0A77AECEC196ACCC52973,
)

SECP256K1 = Curve(
    name="secp256k1",
    p=0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F,
    a=0,
    b=7,
    gx=0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798,
    gy=0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8,
    n=0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141,
)


def ecdsa_verify(curve: Curve, pub: Point, msg_hash: bytes, r: int, s: int) -> bool:
    """Raw ECDSA verification (hash already computed, truncated per spec)."""
    n = curve.n
    if not (1 <= r < n and 1 <= s < n):
        return False
    e = int.from_bytes(msg_hash, "big")
    if len(msg_hash) * 8 > n.bit_length():
        e >>= len(msg_hash) * 8 - n.bit_length()
    w = invmod(s, n)
    u1 = mulmod(e, w, n)
    u2 = mulmod(r, w, n)
    pt = curve.add(curve.mul(u1, curve.g), curve.mul(u2, pub))
    if pt is None:
        return False
    return pt[0] % n == r


def ecdsa_recover(curve: Curve, msg_hash: bytes, r: int, s: int, v: int) -> Point:
    """Recover the public key from a recoverable signature (Ethereum-style
    65-byte sigs; used for the request `origin` secp256k1 signature)."""
    n, p = curve.n, curve.p
    if not (1 <= r < n and 1 <= s < n) or v not in (0, 1):
        raise ValueError("bad recoverable signature")
    x = r  # ignore the r >= p - n overflow case (negligible and unused here)
    rhs = (x * x * x + curve.a * x + curve.b) % p
    y = pow(rhs, (p + 1) // 4, p)
    if (y * y) % p != rhs:
        raise ValueError("invalid signature point")
    if (y & 1) != v:
        y = p - y
    R = (x, y)
    e = int.from_bytes(msg_hash, "big")
    if len(msg_hash) * 8 > n.bit_length():
        e >>= len(msg_hash) * 8 - n.bit_length()
    r_inv = invmod(r, n)
    # Q = r^-1 (s R - e G)
    sR = curve.mul(s, R)
    eG = curve.mul(e, curve.g)
    neg_eG = None if eG is None else (eG[0], (-eG[1]) % p)
    return curve.mul(r_inv, curve.add(sR, neg_eG))
