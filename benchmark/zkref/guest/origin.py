"""Request-origin signature: the secp256k1 signature binding a request to
its author (reference: `origin: {type: "secp256k1", signature, nonce}` in
testdata/input.json; the guest verifies it with k256 — SURVEY.md §3.4).

The reference's exact signing preimage lives in the external zkvm-programs
crate (marked [K] in the survey); this framework defines a documented
canonical preimage (version tag included so a future bit-exact mode can
coexist):

    digest = keccak256( b"zktls-request-v1" ‖ u64be(version) ‖ request ‖
                        remote_addr ‖ server_name ‖ u64be(nonce) )

Signatures are Ethereum-style 65-byte (r ‖ s ‖ v) recoverable; the
recovered signer address = keccak256(uncompressed_pubkey[1:])[12:].

Port copy of zktls_tpu.guest.origin (same names and values).
"""

from __future__ import annotations

from ..core.types import Request
from .crypto.ec import SECP256K1, ecdsa_recover
from .crypto.keccak import keccak256

__all__ = ["origin_digest", "recover_origin_signer", "sign_origin"]

_TAG = b"zktls-request-v1"


def origin_digest(request: Request) -> bytes:
    ri = request.request_info
    nonce = request.origin.nonce if request.origin else 0
    return keccak256(
        _TAG
        + request.version.to_bytes(8, "big")
        + ri.request
        + ri.remote_addr.encode()
        + ri.server_name.encode()
        + nonce.to_bytes(8, "big")
    )


def recover_origin_signer(request: Request) -> bytes:
    """Recovered 20-byte signer address, or zeros when no origin present."""
    if request.origin is None or request.origin.type != "secp256k1":
        return b"\x00" * 20
    sig = request.origin.signature
    if len(sig) != 65:
        raise ValueError("origin signature must be 65 bytes (r‖s‖v)")
    r = int.from_bytes(sig[0:32], "big")
    s = int.from_bytes(sig[32:64], "big")
    v = sig[64]
    if v >= 27:
        v -= 27
    pub = ecdsa_recover(SECP256K1, origin_digest(request), r, s, v)
    raw = pub[0].to_bytes(32, "big") + pub[1].to_bytes(32, "big")
    return keccak256(raw)[12:]


def sign_origin(request: Request, private_key: int) -> bytes:
    """Produce a 65-byte recoverable signature (host-side utility for
    request authors; deterministic RFC 6979-style nonce via keccak)."""
    z = int.from_bytes(origin_digest(request), "big")
    n = SECP256K1.n
    k = int.from_bytes(
        keccak256(private_key.to_bytes(32, "big")
                  + origin_digest(request)), "big") % n
    if k == 0:
        k = 1
    R = SECP256K1.mul(k, SECP256K1.g)
    r = R[0] % n
    s = pow(k, -1, n) * (z + r * private_key) % n
    v = R[1] & 1
    if s > n // 2:  # low-s normalization flips recovery parity
        s = n - s
        v ^= 1
    return r.to_bytes(32, "big") + s.to_bytes(32, "big") + bytes([v])
