"""BN254-friendly commitments for the shrink layer.

The reference's last recursion layer re-commits with a hash its Groth16
circuit can afford (SP1's BN254 wrap via gnark, risc0's identity_p254 —
SURVEY.md §2.2.B/C).  Same move here: Merkle trees and the Fiat-Shamir
challenger over MP-MiMC (110-round x⁵, snark/wrap.py constants) in the
BN254 scalar field, so one MiMC permutation costs ~330 R1CS constraints
in the wrap circuit instead of the ~40k a Baby-Bear Poseidon2 would.

Packing: 7 Baby-Bear values per field element at 32-bit strides
(e = Σ vᵢ·2^32i < 2^224 < r) — injective, trivially vectorizable on the
limb representation, and a 7-term linear combination in-circuit.

Port copy of zktls_tpu.stark.commit_bn (same names and values).  Port
choices: `MimcTree` hashes through the C library of utils/native.py
(csrc/mimc_bn254_host.c, OpenMP) and raises if it cannot be built; its
pure-Python plain version is reached only by `MimcTree(m, native=False)`,
never as a fallback.  Leaves are packed and hashed in row blocks, which
bounds the uint64 temporaries at full width.  `verify_path_bn` and
`FrChallenger` are pure Python, as in the reference.
"""

from __future__ import annotations

import numpy as np

from ..ops.field_ref import Fp4, P
from ..snark.wrap import _perm, mimc_hash
from ..utils.native import mimc_compress_pairs, mimc_hash_rows

__all__ = ["PACK_RATE", "pack_row", "leaf_digest", "MimcTree",
           "verify_path_bn", "FrChallenger", "R_BN", "grind_bn"]

R_BN = 21888242871839275222246405745257275088548364400416034343698204186575808495617
PACK_RATE = 7
#: rows per block of packed leaves: (2^20, 6, 4) u64 limbs are 192 MiB
_LEAF_ROWS = 1 << 20


def pack_row(row: list[int]) -> list[int]:
    """Baby-Bear values → field elements, 7 per element at 32-bit
    strides."""
    out = []
    for j in range(0, len(row), PACK_RATE):
        e = 0
        for i, v in enumerate(row[j : j + PACK_RATE]):
            e |= (int(v) & 0xFFFFFFFF) << (32 * i)
        out.append(e)
    return out


def leaf_digest(row: list[int]) -> int:
    return mimc_hash(pack_row(row))


def _pack_matrix_limbs(mat: np.ndarray) -> np.ndarray:
    """(N, w) plain uint32 → (N, k, 4) u64 limb arrays of the packed
    elements (k = ceil(w/7)), fully vectorized."""
    n, w = mat.shape
    k = -(-w // PACK_RATE) if w else 1
    padded = np.zeros((n, k * PACK_RATE), dtype=np.uint64)
    padded[:, :w] = mat.astype(np.uint64)
    vals = padded.reshape(n, k, PACK_RATE)
    limbs = np.zeros((n, k, 4), dtype=np.uint64)
    # value i sits at bit 32·i: limb i//2, shifted 32·(i%2)
    for i in range(PACK_RATE):
        limbs[:, :, i // 2] |= vals[:, :, i] << np.uint64(32 * (i % 2))
    return limbs


def _digests_to_int(d: np.ndarray) -> list[int]:
    return [int(d[i, 0]) | int(d[i, 1]) << 64 | int(d[i, 2]) << 128
            | int(d[i, 3]) << 192 for i in range(d.shape[0])]


def _ints_to_limbs(vals: list[int]) -> np.ndarray:
    out = np.zeros((len(vals), 4), dtype=np.uint64)
    m = (1 << 64) - 1
    for i, v in enumerate(vals):
        out[i, 0] = v & m
        out[i, 1] = (v >> 64) & m
        out[i, 2] = (v >> 128) & m
        out[i, 3] = (v >> 192) & m
    return out


class MimcTree:
    """Merkle tree over MP-MiMC: leaf = chain over the packed row,
    node = chain over (left, right).  `native=True` (the default) hashes
    through the C library; `native=False` is the pure-Python plain
    version, for small matrices."""

    def __init__(self, matrix: np.ndarray, native: bool = True):
        n = matrix.shape[0]
        if native:
            leaves = np.empty((n, 4), dtype=np.uint64)
            for r0 in range(0, n, _LEAF_ROWS):
                blk = matrix[r0 : r0 + _LEAF_ROWS]
                leaves[r0 : r0 + blk.shape[0]] = mimc_hash_rows(
                    _pack_matrix_limbs(blk))
        else:
            leaves = _ints_to_limbs([
                leaf_digest([int(v) for v in matrix[i]])
                for i in range(n)])
        self.levels = [leaves]
        cur = leaves
        while cur.shape[0] > 1:
            pairs = cur.reshape(-1, 2, 4)
            if native:
                cur = mimc_compress_pairs(pairs)
            else:
                ints = _digests_to_int(cur.reshape(-1, 4))
                cur = _ints_to_limbs([
                    mimc_hash([ints[2 * i], ints[2 * i + 1]])
                    for i in range(len(ints) // 2)])
            self.levels.append(cur)

    @property
    def root(self) -> int:
        return _digests_to_int(self.levels[-1])[0]

    def open(self, j: int) -> list[int]:
        path = []
        for level in self.levels[:-1]:
            sib = j ^ 1
            d = level[sib]
            path.append(int(d[0]) | int(d[1]) << 64 | int(d[2]) << 128
                        | int(d[3]) << 192)
            j >>= 1
        return path



def verify_path_bn(leaf: int, index: int, path: list[int],
                   root: int) -> bool:
    node = leaf
    for sib in path:
        lr = (sib, node) if index & 1 else (node, sib)
        node = mimc_hash(list(lr))
        index >>= 1
    return node == root


class FrChallenger:
    """Fiat-Shamir over the BN254 scalar field: running MP-MiMC hash
    state, Baby-Bear observations packed 7-at-32-bit, samples drawn by
    chaining the state with a tag element.  Baby-Bear samples take
    62-bit chunks mod P (bias 2^-31)."""

    SAMPLE_TAG = (1 << 248) + 1

    def __init__(self):
        self.h = 0
        self.buf: list[int] = []

    def copy(self) -> "FrChallenger":
        c = FrChallenger()
        c.h = self.h
        c.buf = list(self.buf)
        return c

    def _step(self, e: int) -> int:
        m = e % R_BN
        self.h = (_perm(m, self.h) + self.h + m) % R_BN
        return self.h

    def flush(self) -> None:
        if self.buf:
            e = 0
            for i, v in enumerate(self.buf):
                e |= (int(v) & 0xFFFFFFFF) << (32 * i)
            self._step(e)
            self.buf = []

    def observe(self, v: int) -> None:
        self.buf.append(int(v) % P)
        if len(self.buf) == PACK_RATE:
            self.flush()

    def observe_many(self, vs) -> None:
        for v in vs:
            self.observe(v)

    def observe_ext(self, v: Fp4) -> None:
        self.observe_many(int(x) for x in v.c)

    def observe_fr(self, x: int) -> None:
        self.flush()
        self._step(int(x) % R_BN)

    def observe_bytes(self, data: bytes) -> None:
        self.flush()
        self._step(len(data))
        for i in range(0, len(data), 28):
            self._step(int.from_bytes(data[i : i + 28], "big"))

    def sample_fr(self) -> int:
        self.flush()
        return self._step(self.SAMPLE_TAG)

    def sample_ext(self) -> Fp4:
        y = self.sample_fr()
        limbs = [((y >> (62 * i)) & ((1 << 62) - 1)) % P for i in range(4)]
        return Fp4(*limbs)

    def sample_bits(self, k: int) -> int:
        return self.sample_fr() & ((1 << k) - 1)

    def check_witness(self, pow_bits: int, witness: int) -> bool:
        self.observe(witness)
        if pow_bits == 0:
            return True
        return self.sample_bits(pow_bits) == 0


def grind_bn(ch: FrChallenger, pow_bits: int) -> int:
    """Host grinding for the BN challenger (the shrink layer is proven
    once; a Python loop at ≤2^18 tries is fine)."""
    w = 0
    while True:
        c = ch.copy()
        if c.check_witness(pow_bits, w):
            return w
        w += 1
