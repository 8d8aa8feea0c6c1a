"""The journal wrap: a constant-size BN254 proof binding the journal bytes
to an on-chain-checkable commitment, and the MP-MiMC hash it is built on.

    public:  d = MiMC-MP(journal field chunks)   (the on-chain commitment)
    private: the journal chunks

so a relying contract learns "the submitter knows the journal behind d"
with one 256-byte proof.  MiMC-MP: 110-round x⁵ MiMC permutation in
Miyaguchi–Preneel mode over the BN254 scalar field (round constants from
a fixed SHA-256 stream); it is also the commitment hash of the shrink
layer (stark/commit_bn.py).

Port copy of zktls_tpu.snark.wrap (same names and values): the MiMC
(`N_ROUNDS`, `_round_constants`, `_perm`, `mimc_hash`,
`MIMC_ROUND_CONSTANTS`) and the journal circuit (`journal_chunks`,
`journal_digest_fr`, `build_wrap_circuit`, `wrap_circuit_params`,
`wrap_setup`, `wrap_prove`, `wrap_verify`).  These are the plain Python
versions; the C library of utils/native.py (csrc/mimc_bn254_host.c)
computes the same MiMC over whole matrices, with the constants injected
from here.  One CRS (`wrap_setup()`, fixed seed) covers every journal up
to (MAX_CHUNKS − 1) · 31 bytes; its verifying key is bundled as
snark/wrap_vk.json.
"""

from __future__ import annotations

import hashlib

from .bn254 import R
from .groth16 import Groth16Keys, Groth16Proof, prove, setup, verify
from .r1cs import R1CS

__all__ = ["mimc_hash", "journal_digest_fr", "build_wrap_circuit",
           "wrap_setup", "wrap_prove", "wrap_verify", "CHUNK_BYTES",
           "MAX_CHUNKS", "MIMC_ROUND_CONSTANTS"]

N_ROUNDS = 110
CHUNK_BYTES = 31  # field elements hold 31 journal bytes (< r)
#: fixed circuit size: every journal pads (with zero chunks before the
#: length chunk) to this many chunks, so ONE trusted setup / verifying
#: key / exported contract covers every journal up to
#: (MAX_CHUNKS − 1) · 31 = 1457 bytes (the committed sessions' journals
#: are 1,056 and 1,248 bytes)
MAX_CHUNKS = 48


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


def journal_chunks(journal: bytes) -> list[int]:
    """Fixed-length chunking: data chunks, zero padding, then the length
    chunk — injective for journals up to (MAX_CHUNKS−1)·31 bytes."""
    n = (len(journal) + CHUNK_BYTES - 1) // CHUNK_BYTES
    if n > MAX_CHUNKS - 1:
        raise ValueError(
            f"journal too long for the wrap circuit "
            f"({len(journal)} B > {(MAX_CHUNKS - 1) * CHUNK_BYTES})")
    data = [int.from_bytes(journal[i : i + CHUNK_BYTES], "big")
            for i in range(0, len(journal), CHUNK_BYTES)]
    return data + [0] * (MAX_CHUNKS - 1 - n) + [len(journal)]


def journal_digest_fr(journal: bytes) -> int:
    return mimc_hash(journal_chunks(journal))


def build_wrap_circuit(journal: bytes) -> R1CS:
    """R1CS: public digest, private journal chunks, MiMC-MP evaluated
    in-circuit (3 constraints per round: x², x⁴, x⁵)."""
    chunks = journal_chunks(journal)
    cs = R1CS()
    digest = cs.public_input(mimc_hash(chunks))
    h_lc = {0: 0}          # running hash starts at 0 (constant)
    h_val = 0
    for m_val in chunks:
        m = cs.witness(m_val)
        # permutation P(m, h): x starts at m; round x ← (x + h + c)⁵
        cur_lc = {m: 1}
        cur_val = m_val % R
        for c in _RC:
            t_lc = dict(cur_lc)
            t_lc[0] = (t_lc.get(0, 0) + c) % R
            for k, v in h_lc.items():
                if k:
                    t_lc[k] = (t_lc.get(k, 0) + v) % R
                else:
                    t_lc[0] = (t_lc.get(0, 0) + v) % R
            t_val = (cur_val + h_val + c) % R
            x2 = cs.mul(t_lc, t_lc)
            x4 = cs.mul({x2: 1}, {x2: 1})
            x5 = cs.mul({x4: 1}, t_lc)
            cur_lc = {x5: 1}
            cur_val = pow(t_val, 5, R)
        # h' = P + h + m
        new_h = (cur_val + h_val + m_val) % R
        h_var = cs.witness(new_h)
        sum_lc = dict(cur_lc)
        sum_lc[m] = (sum_lc.get(m, 0) + 1) % R
        for k, v in h_lc.items():
            sum_lc[k] = (sum_lc.get(k, 0) + v) % R
        cs.enforce_eq(sum_lc, {h_var: 1})
        h_lc = {h_var: 1}
        h_val = new_h
    cs.enforce_eq(h_lc, {digest: 1})
    assert cs.check(), "wrap circuit assignment inconsistent"
    return cs


#: MiMC round constants, exported for the on-chain digest computation
MIMC_ROUND_CONSTANTS = _RC


def wrap_circuit_params(seed: bytes = b"zktls-wrap-v1") -> dict:
    """Identifying parameters of the wrap circuit + CRS seed — embedded in
    exported/bundled vk.json files so a stale verifying key is detected at
    load time."""
    return {"max_chunks": MAX_CHUNKS, "chunk_bytes": CHUNK_BYTES,
            "n_rounds": N_ROUNDS, "seed": seed.decode()}


def wrap_setup(seed: bytes = b"zktls-wrap-v1") -> Groth16Keys:
    """ONE CRS for all journals: the circuit is fixed at MAX_CHUNKS, and
    padding makes every journal fit it.  (The reference's ignored
    `journal_len_chunks` argument is not carried over.)"""
    return setup(build_wrap_circuit(b""), seed=seed)


def wrap_prove(keys: Groth16Keys, journal: bytes) -> tuple[int, bytes]:
    cs = build_wrap_circuit(journal)
    proof = prove(keys, cs)
    return journal_digest_fr(journal), proof.to_bytes()


def wrap_verify(keys_vk: dict, digest: int, proof_bytes: bytes) -> bool:
    return verify(keys_vk, [digest], Groth16Proof.from_bytes(proof_bytes))
