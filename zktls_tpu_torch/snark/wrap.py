"""MP-MiMC over the BN254 scalar field: the hash of the shrink layer's
commitments and Fiat-Shamir challenger (stark/commit_bn.py).

Port of the MiMC part of zktls_tpu.snark.wrap (`N_ROUNDS`,
`_round_constants`, `_perm`, `mimc_hash`, `MIMC_ROUND_CONSTANTS`), same
names and values: a 110-round x⁵ MiMC permutation in Miyaguchi–Preneel
mode, round constants from a fixed SHA-256 stream.  These are the plain
Python versions; the C library of utils/native.py (csrc/mimc_bn254_host.c)
computes the same function over whole matrices, with the constants
injected from here.  The Groth16 half of the reference's module
(journal digest, wrap circuit, setup / prove / verify) is not ported yet.
"""

from __future__ import annotations

import hashlib

from .bn254 import R

__all__ = ["mimc_hash", "MIMC_ROUND_CONSTANTS", "N_ROUNDS"]

N_ROUNDS = 110


def _round_constants() -> list[int]:
    out = []
    for i in range(N_ROUNDS):
        h = hashlib.sha256(b"zktls-tpu-mimc-bn254/%d" % i).digest()
        out.append(int.from_bytes(h, "big") % R)
    return out


_RC = _round_constants()


def _perm(x: int, k: int) -> int:
    for c in _RC:
        x = pow((x + k + c) % R, 5, R)
    return x


def mimc_hash(chunks: list[int]) -> int:
    """Miyaguchi–Preneel over the MiMC permutation: h ← P(m, h) + h + m."""
    h = 0
    for m in chunks:
        m %= R
        h = (_perm(m, h) + h + m) % R
    return h


#: MiMC round constants, exported for the on-chain digest computation
MIMC_ROUND_CONSTANTS = _RC
