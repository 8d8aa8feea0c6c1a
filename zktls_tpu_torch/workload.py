"""The machines that chip_smoke.py and profile_prove.py drive.

* `sha_machine`: the one-chip Sha256Air machine — seeded messages hashed
  with result tags, their compressions as the chip's trace, and the public
  messages the verifier receives.
* `session_machine(name)`: the chips of one recorded TLS session in
  `data/` (`SESSIONS`), built by `provers.stark.build_chip_instances` from
  the port's replay of the session's GuestInput, and its journal (the
  proof's binding; `StarkGuestProver.verify` derives the public messages
  from it).
* `batch_machine(name)`: a batch of committed sessions (`BATCHES`) merged
  by `provers.stark.merge_guest_outputs` into one chip workload, and the
  batch's journals (the proof binds their concatenation;
  `StarkGuestProver.verify_batch` derives the public messages from them).
* `preprocessed_machine(log_n)`: a FixedMulAir chip (y = c·x + d with
  (c, d) in preprocessed columns) beside a Fibonacci chip of half its
  height — the smallest machine with a preprocessed commit.
* `COMPRESSES`: the compress rung of a committed session — its
  DEFAULT_CONFIG machine proof verified inside the recursion machine
  (`StarkGuestProver.compress`), with the program size and outer chips
  that gives; `sha_compress_machine()`: the 256-row Sha256Air machine whose
  compress chip_smoke.py holds to its CPU bytes.
* `SHRINKS`: the shrink rung — a compress proof proved once more under
  MP-MiMC commitments over BN254 (`recursion.recursion_prove_bn`), with
  the program size and outer chips that gives; `shrink_statement` builds
  its binding, messages and inner vk root as the reference's
  `StarkGuestProver.wrap` does; `fib_chain()`: the tiny chain of
  tests/test_shrink_bn.py (Fibonacci → compress), whose shrink bytes the
  card and the CPU are held to.
* `SNARKS`: the Groth16 paths the reference's host code can finish — the
  STARK-verifier wrap of a small BN machine proof (`wrap_bn`,
  `wrap_bn_machine`) and the journal seal of each committed TLS 1.3 /
  TLS 1.2 session (`journal_1303`, `journal_c02f`) — with their circuits'
  sizes and the JAX package's digests; `r1cs_digests` hashes a circuit;
  `EXPORT_SHA256` holds the JAX package's exported EVM verifier files.

Each session is a loopback recording (scripts/record_session_c02f_p256.py
--suite ...) with a 512-byte JSON body of which 10 bytes are filtered,
whose self-signed certificate anchors to no root of the store, so it is
replayed with `require_trust_anchor=False`.

* `single_air(name)`: the single-AIR proofs (`stark.prover.prove`) held
  to the JAX package's committed bytes (`SINGLES`): the Fibonacci AIR of
  tests/test_stark.py and a LogUp byte-range table (ByteRangeAir) with
  grinding.
* `loopback_server(suite)`, `record_loopback(suite)`: a live recording
  by the port's recorder (host/) against a one-connection TLS server on
  127.0.0.1 (Python's `ssl`) answering `loopback_request`'s request with
  the same 512-byte body (`loopback_response`).  The server's certificate
  and key, `LOOPBACK_CERT` and `LOOPBACK_KEY` (`data/loopback_rsa2048.*`,
  made by scripts/record_session_c02f_p256.py --make-cert), are a
  self-signed test pair for `localhost`: for the tests and chip_smoke.py
  only, never for a real server.
"""

from __future__ import annotations

import contextlib
import hashlib
import socket
import ssl
import threading
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from .core.types import GuestInput, PrefixTemplate, Request, RequestInfo
from .guest.crypto.sha256 import SHA256Recorder
from .models.fibonacci import FibonacciAir, fibonacci_trace
from .ops.field_ref import P
from .stark.air import Air
from .stark.bus import BUS_SHA_RESULT, digest_limbs
from .stark.chips.sha256 import Sha256Air, sha256_trace
from .stark.machine import ChipInstance

__all__ = ["sha_machine", "Session", "SESSIONS", "SESSION_GUEST_INPUT",
           "session_machine", "Batch", "BATCHES", "batch_machine",
           "FixedMulAir", "preprocessed_machine", "Compress", "COMPRESSES",
           "sha_compress_machine", "Shrink", "SHRINKS", "shrink_statement",
           "FIB_CHAIN_CONFIG", "FIB_CHAIN_BINDING", "fib_chain",
           "FIB_COMPRESS_CONFIG", "FIB_COMPRESS_BINDING",
           "FIB_COMPRESS_REFERENCE", "SHA_MACHINE_SEED", "SHA_MACHINE_CONFIG",
           "SHA_MACHINE_BINDING", "SHA_MACHINE_REFERENCE",
           "SHA_QUOTIENT_REFERENCE", "sha_quotient_inputs", "BN_MACHINE_LOG_N",
           "BN_MACHINE_CONFIG", "BN_MACHINE_BINDING", "BN_MACHINE_REFERENCE",
           "FIB_CHAIN_VKS_REFERENCE", "Snark", "SNARKS", "WRAP_BN_CONFIG",
           "WRAP_BN_BINDING", "WRAP_BN_SEED", "WRAP_BN_RANDOMNESS",
           "WRAP_BN_REFERENCE", "wrap_bn_machine", "r1cs_digests",
           "EXPORT_SHA256", "LOOPBACK_CERT", "LOOPBACK_KEY",
           "LOOPBACK_TLS12", "loopback_response", "loopback_request",
           "loopback_server", "record_loopback", "SINGLES", "single_air"]

DATA = Path(__file__).resolve().parent / "data"


@dataclass(frozen=True)
class Session:
    """A committed recording and what its replay must give."""

    #: the recorded GuestInput
    guest_input: Path
    #: the negotiated cipher suite
    suite: int
    #: the certificate report at the recording's pinned time: one
    #: self-signed certificate, so no store anchor; root_spki_sha256 is
    #: then the SHA-256 of the leaf's own SubjectPublicKeyInfo
    chain: dict
    journal_bytes: int
    #: (chip name, rows, columns) in build order
    chips: tuple


def _chain(leaf_spki_sha256: str) -> dict:
    return {"hostname_match": True, "validity": True, "signatures": True,
            "anchored": False, "root_spki_sha256": leaf_spki_sha256}


#: the committed sessions by name
SESSIONS = {
    # TLS 1.2 ECDHE(P-256)-RSA-AES128-GCM-SHA256
    "c02f": Session(
        DATA / "session_c02f_p256.guest_input.cbor", 0xC02F,
        _chain("90b0c5f1760d339a3d12a1abf60ccd08"
               "760d542d1c38259654c95efb485ed45c"), 1056,
        (("Sha256Air", 16384, 639), ("Aes128Air", 1024, 851),
         ("GhashAir", 8192, 779), ("GcmControlAir", 64, 303),
         ("StreamParserAir", 4096, 141), ("GcmDataAir", 1024, 39),
         ("XorTableAir", 256, 1), ("KeccakAir", 1024, 1999),
         ("EcScheduleAir", 256, 1302), ("KeyScheduleAir", 64, 181),
         ("ModMul256Air", 8192, 324), ("ModMulRsa2048Air", 256, 3832))),
    # TLS 1.3 TLS_AES_256_GCM_SHA384 over x25519: what a default OpenSSL
    # server picks from the recorder's default suite list
    "1302": Session(
        DATA / "session_1302_x25519.guest_input.cbor", 0x1302,
        _chain("1cc0643548c5b494d8b9d13ec473935e"
               "4b9a8345060410801201b8adbc53c7ef"), 1248,
        (("Sha256Air", 8192, 639), ("Sha512Air", 32768, 1186),
         ("Aes256Air", 4096, 987), ("GhashAir", 32768, 779),
         ("GcmControlAir", 256, 303), ("StreamParserAir", 4096, 141),
         ("GcmDataAir", 4096, 39), ("XorTableAir", 256, 1),
         ("KeccakAir", 1024, 1999), ("ModMul256Air", 8192, 324),
         ("ModMulRsa2048Air", 256, 3832))),
    # TLS 1.3 TLS_CHACHA20_POLY1305_SHA256 over x25519
    "1303": Session(
        DATA / "session_1303_x25519.guest_input.cbor", 0x1303,
        _chain("5ab5cb5d9d2f8aafd1815390c0479326"
               "c0ecb0a10c2ebc0f63f8c6e0c115419f"), 1248,
        (("Sha256Air", 16384, 639), ("ChaChaControlAir", 256, 317),
         ("StreamParserAir", 4096, 141), ("ChaChaDataAir", 4096, 39),
         ("XorTableAir", 256, 1), ("KeccakAir", 1024, 1999),
         ("ChaCha20Air", 2048, 1147), ("ModMul256Air", 8192, 324),
         ("ModMulRsa2048Air", 256, 3832))),
}

#: the first recorded session's GuestInput
SESSION_GUEST_INPUT = SESSIONS["c02f"].guest_input


@dataclass(frozen=True)
class Batch:
    """A batch of committed sessions proved as one machine."""

    #: the sessions' names (keys of SESSIONS), in batch order
    sessions: tuple
    #: (chip name, rows, columns, perm columns) in build order, as the
    #: reference's merge_guest_outputs + build_chip_instances give them
    chips: tuple


#: the batches by name: the c02f session twice and eight times (the
#: reference's "batch of 8 TLS transcripts", BASELINE.json configs[3])
BATCHES = {
    "c02f_x2": Batch(
        ("c02f",) * 2,
        (("Sha256Air", 32768, 639, 32), ("Aes128Air", 2048, 851, 96),
         ("GhashAir", 16384, 779, 32), ("GcmControlAir", 128, 303, 144),
         ("StreamParserAir", 8192, 141, 44), ("GcmDataAir", 2048, 39, 36),
         ("XorTableAir", 256, 1, 8), ("KeccakAir", 2048, 1999, 44),
         ("EcScheduleAir", 512, 1302, 1128),
         ("KeyScheduleAir", 128, 181, 244),
         ("ModMul256Air", 16384, 324, 584),
         ("ModMulRsa2048Air", 256, 3832, 5120))),
    "c02f_x8": Batch(
        ("c02f",) * 8,
        (("Sha256Air", 131072, 639, 32), ("Aes128Air", 8192, 851, 96),
         ("GhashAir", 65536, 779, 32), ("GcmControlAir", 512, 303, 144),
         ("StreamParserAir", 32768, 141, 44), ("GcmDataAir", 8192, 39, 36),
         ("XorTableAir", 256, 1, 8), ("KeccakAir", 8192, 1999, 44),
         ("EcScheduleAir", 2048, 1302, 1128),
         ("KeyScheduleAir", 512, 181, 244),
         ("ModMul256Air", 65536, 324, 584),
         ("ModMulRsa2048Air", 256, 3832, 5120))),
}


@dataclass(frozen=True)
class Compress:
    """The compress rung of a committed session at DEFAULT_CONFIG."""

    #: the inner session (a key of SESSIONS)
    session: str
    #: the verifier program's instruction count
    instrs: int
    #: (chip name, rows, columns, preprocessed columns, perm columns) of
    #: the outer machine; rows are the program's and the sponge rows'
    #: padding to a power of two
    chips: tuple


#: the compresses by name; instruction and sponge-row counts from the
#: shape-only `build_program` of each session's chips (real sponge rows:
#: 1303 30,671 / 33,372, c02f 37,205 / 41,400 at widths 16 / 24)
COMPRESSES = {
    "compress_1303": Compress(
        "1303", 7689048,
        (("VmAir", 8388608, 24, 28, 40), ("Sponge16Air", 32768, 555, 0, 112),
         ("Sponge24Air", 65536, 1019, 0, 144))),
    "compress_c02f": Compress(
        "c02f", 8520286,
        (("VmAir", 16777216, 24, 28, 40), ("Sponge16Air", 65536, 555, 0, 112),
         ("Sponge24Air", 65536, 1019, 0, 144))),
}
#: the mid-scale compress's inner machine: chip_smoke.py's 256-row
#: Sha256Air machine (2 seeded messages of 100 bytes) and its binding
SHA_COMPRESS_SEED = 20261016
SHA_COMPRESS_BINDING = b"chip-smoke sha256 machine"


def sha_compress_machine() -> tuple[ChipInstance, list[tuple], bytes]:
    """(the 256-row Sha256Air chip, its public messages, its binding)."""
    inst, msgs = sha_machine(2, 100, SHA_COMPRESS_SEED)
    return inst, msgs, SHA_COMPRESS_BINDING


@dataclass(frozen=True)
class Shrink:
    """The shrink rung of a compress at DEFAULT_CONFIG."""

    #: the compress it shrinks (a key of COMPRESSES)
    compress: str
    #: the shrink program's instruction count
    instrs: int
    #: (chip name, rows, columns, preprocessed columns, perm columns) of
    #: the outer machine, as in Compress.chips
    chips: tuple


#: the shrinks by name; the instruction and sponge-row counts come from
#: the shape-only `build_program` of the compress proof's shape (real
#: sponge rows 19,654 / 5,184 at widths 16 / 24)
SHRINKS = {
    "shrink_1303": Shrink(
        "compress_1303", 1315687,
        (("VmAir", 2097152, 24, 28, 40), ("Sponge16Air", 32768, 555, 0, 112),
         ("Sponge24Air", 8192, 1019, 0, 144))),
}


def shrink_statement(vk_a, binding: bytes,
                     public_messages: list[tuple]
                     ) -> tuple[bytes, list[tuple], dict]:
    """(binding, public messages, inner preprocessed roots) of the shrink
    of a compress proof whose vk is `vk_a` and whose statement was
    (binding, public_messages): the arguments the reference's
    `StarkGuestProver.wrap` gives `recursion_prove_bn`."""
    from .stark.recursion import _session_messages

    a_binding = binding + vk_a.shape.to_bytes()
    a_msgs = _session_messages(vk_a.shape, binding, public_messages)
    return a_binding, a_msgs, {"VmAir": list(vk_a.program_root)}


#: the tiny chain of tests/test_shrink_bn.py: Fibonacci(5) proved, then
#: compressed, at this config and binding
FIB_CHAIN_CONFIG = dict(log_blowup=2, num_queries=2, pow_bits=0,
                        fri_final_size=16)
FIB_CHAIN_BINDING = b"fib-chain"
#: the JAX package's compress and shrink vks of that chain, cbor
#: {"vk_a", "vk_b"} (scripts/session_proof_cpu.py --shrink fib)
FIB_CHAIN_VKS_REFERENCE = DATA / "fib_chain_vks.jax.cbor"
#: the Fibonacci inner of tests/test_torch_recursion.py, and the JAX
#: package's compress of it (its vk and outer proof bytes, made by
#: scripts/session_proof_cpu.py --compress fib --reference)
FIB_COMPRESS_CONFIG = dict(log_blowup=2, num_queries=4, pow_bits=0,
                           fri_final_size=16)
FIB_COMPRESS_BINDING = b"fib-recursion"
FIB_COMPRESS_REFERENCE = DATA / "fib_compress.jax.cbor"
#: the 256-row Sha256Air machine of tests/test_torch_machine.py (2 seeded
#: 100-byte messages), its config and binding, and the JAX package's proof
#: of it (made by scripts/session_proof_cpu.py --machine sha --reference)
SHA_MACHINE_SEED = 4404
SHA_MACHINE_CONFIG = dict(log_blowup=2, num_queries=8, pow_bits=0,
                          fri_final_size=16)
SHA_MACHINE_BINDING = b"zktls-tpu-torch machine test"
SHA_MACHINE_REFERENCE = DATA / "sha256_machine.jax.proof"
#: the JAX package's eval_quotient_vm of that machine's chip on its LDE at
#: `sha_quotient_inputs` (blowup 4, shift 31; made by the same command)
SHA_QUOTIENT_REFERENCE = DATA / "sha256_quotient.jax.npy"


def sha_quotient_inputs(n_constraints: int
                        ) -> tuple[list[tuple], list[int], np.ndarray]:
    """The seeded 74 challenges (4 coefficients each), 4 publics and
    (n_constraints, 4) α powers at which tests/test_torch_machine.py
    evaluates the 256-row Sha256Air chip's quotient."""
    rng = np.random.default_rng(4405)
    challenges = [tuple(int(x) for x in rng.integers(0, P, 4))
                  for _ in range(74)]
    publics = [int(x) for x in rng.integers(0, P, 4)]
    return challenges, publics, rng.integers(0, P, (n_constraints, 4),
                                             dtype=np.uint32)
#: the preprocessed machine of tests/test_torch_shrink.py
#: (preprocessed_machine(5)), its config and binding, and the JAX package's
#: BN-committed proof of it (scripts/session_proof_cpu.py --machine bn
#: --reference)
BN_MACHINE_LOG_N = 5
BN_MACHINE_CONFIG = dict(log_blowup=2, num_queries=6, pow_bits=4,
                         fri_final_size=8)
BN_MACHINE_BINDING = b"bn-machine"
BN_MACHINE_REFERENCE = DATA / "bn_machine.jax.proof"


def fib_chain(device=None):
    """(inner proof, compress vk, compress proof) of the tiny chain, proved
    by the port on `device` (the card unless "cpu" is asked for)."""
    from .stark.config import StarkConfig
    from .stark.machine import _resolve_device, prove_machine
    from .stark.recursion import recursion_prove

    device = _resolve_device(device)
    cfg = StarkConfig(**FIB_CHAIN_CONFIG)
    trace, pub = fibonacci_trace(5)
    inner = prove_machine(
        [ChipInstance(air=FibonacciAir(), trace=trace, publics=pub)],
        binding=FIB_CHAIN_BINDING, config=cfg, device=device)
    vk_a, proof_a = recursion_prove([FibonacciAir()], inner,
                                    FIB_CHAIN_BINDING, inner_config=cfg,
                                    outer_config=cfg, device=device)
    return inner, vk_a, proof_a


def sha_machine(count: int, size: int, seed: int
                ) -> tuple[ChipInstance, list[tuple]]:
    """`count` messages of `size` seeded random bytes, hashed with result
    tags 1..count: (the chip instance, the verifier's public messages).
    8 messages of 3,000 bytes give 384 compressions, a 32768 × 639
    trace."""
    rng = np.random.default_rng(seed)
    rec = SHA256Recorder()
    digests = [rec.sha256(rng.integers(0, 256, size, dtype=np.uint8)
                          .tobytes(), result_tag=i + 1) for i in range(count)]
    trace, publics = sha256_trace(rec.events)
    # payload layout of chips/sha256.py: (tag, 16 digest limbs, xb = 0)
    msgs = [(BUS_SHA_RESULT, [i + 1] + digest_limbs(d) + [0], -1)
            for i, d in enumerate(digests)]
    return ChipInstance(air=Sha256Air(), trace=trace, publics=publics), msgs


def session_machine(name: str = "c02f"
                    ) -> tuple[list[ChipInstance], bytes]:
    """(the session's chip instances, its journal): the port's `run_guest`
    of the committed GuestInput, the chain not required to anchor."""
    from .core.types import GuestInput
    from .guest.program import run_guest
    from .provers.stark import build_chip_instances

    gi = GuestInput.from_cbor(SESSIONS[name].guest_input.read_bytes())
    out = run_guest(gi, require_trust_anchor=False)
    return build_chip_instances(out), out.journal


def batch_machine(name: str = "c02f_x2"
                  ) -> tuple[list[ChipInstance], list[bytes]]:
    """(the batch's merged chip instances, its journals): the port's
    `run_guest` of each committed GuestInput, the chain not required to
    anchor, merged by `merge_guest_outputs`."""
    from .core.types import GuestInput
    from .guest.program import run_guest
    from .provers.stark import build_chip_instances, merge_guest_outputs

    outs = [run_guest(GuestInput.from_cbor(
        SESSIONS[s].guest_input.read_bytes()), require_trust_anchor=False)
        for s in BATCHES[name].sessions]
    return (build_chip_instances(merge_guest_outputs(outs)),
            [out.journal for out in outs])


class FixedMulAir(Air):
    """y = c·x + d with (c, d) preprocessed — the prover cannot choose the
    coefficients, only (x, y) satisfying the committed program; a
    transition through the preprocessed NEXT row keeps c nonincreasing by
    steps of 0 or 1 (the chip of tests/test_preprocessed.py)."""

    width = 2
    preprocessed_width = 2
    num_public = 0
    max_constraint_degree = 2
    name = "FixedMulAir"

    def eval(self, b):
        x, y = b.local[0], b.local[1]
        c, d = b.pre_local[0], b.pre_local[1]
        b.assert_zero(y - (c * x + d))
        c_n = b.pre_next[0]
        b.when_transition((c - c_n) * (c - c_n - 1))


def preprocessed_machine(log_n: int, seed: int = 7
                         ) -> tuple[list[ChipInstance], np.ndarray]:
    """(a FixedMulAir chip of 2^log_n seeded rows beside a Fibonacci chip
    of 2^(log_n − 1) rows, the FixedMulAir's preprocessed matrix)."""
    n = 1 << log_n
    rng = np.random.default_rng(seed)
    c = np.arange(n, 0, -1, dtype=np.uint32) // 2   # steps of 0 or 1
    d = rng.integers(0, 1000, n).astype(np.uint32)
    x = rng.integers(0, 10**6, n).astype(np.uint32)
    y = (c.astype(np.uint64) * x + d) % P
    pre = np.stack([c, d], axis=1).astype(np.uint32)
    trace = np.stack([x, y.astype(np.uint32)], axis=1)
    fib, fib_pub = fibonacci_trace(log_n - 1)
    return [ChipInstance(air=FixedMulAir(), trace=trace, publics=[],
                         preprocessed=pre),
            ChipInstance(air=FibonacciAir(), trace=fib, publics=fib_pub)], pre


@dataclass(frozen=True)
class Snark:
    """A Groth16 path: what its circuit proves, the circuit's size and the
    JAX package's digests of what the path gives."""

    #: the statement behind the circuit's one public input
    statement: str
    #: the StarkConfig of the inner BN machine proof (None: no inner proof)
    config: dict | None
    constraints: int
    variables: int
    #: SHA-256 digests, hex: "proof" the inner BN proof's bytes,
    #: "assignment" and "constraints" `r1cs_digests` of the circuit,
    #: "groth16" the Groth16 proof's bytes at WRAP_BN_SEED and
    #: WRAP_BN_RANDOMNESS
    digests: dict


#: the STARK-verifier wrap of tests/test_stark_wrap.py:24-88: the
#: Fibonacci(5) machine with BN254/MiMC commitments at this config and
#: binding, its Groth16 CRS seed and proof randomness, and the JAX
#: package's proof bytes (scripts/session_proof_cpu.py --snark bn
#: --reference)
WRAP_BN_CONFIG = dict(log_blowup=2, num_queries=2, pow_bits=2,
                      fri_final_size=16)
WRAP_BN_BINDING = b"fib-wrap"
WRAP_BN_SEED = b"wrap-test"
WRAP_BN_RANDOMNESS = b"zktls-tpu-torch wrap_bn"
WRAP_BN_REFERENCE = DATA / "fib_wrap_bn.jax.proof"

#: the journal circuit's constraints, the same for every journal
JOURNAL_CONSTRAINTS_SHA256 = (
    "2b6bc7c3afab8c50852fa35bd196e6b5976cefbf8647ed1ae1a7455a836dfd9b")
#: the Groth16 paths by name; the journal circuit is one size for every
#: journal (MAX_CHUNKS), so both journal paths share it and one CRS
#: (`wrap_setup()`)
SNARKS = {
    "wrap_bn": Snark(
        "statement_digest_fr(b'fib-wrap', [], {}) of the Fibonacci(5) "
        "BN machine proof", WRAP_BN_CONFIG, 150312, 147714, {
            "proof": "e8ec5961b5057f5a35913c915548bc9a"
                     "2ea154979306f7a5b578a4f67ab9c898",
            "assignment": "cbb0f37278c041a4ae7df82c0ffdaf6d"
                          "105ace18d7ab580166d88e3205381dc8",
            "constraints": "df5cbad643938e5895eed1190127021207"
                           "a056c9936bea14375c76635c09904d",
            "groth16": "8f37a6332b5372c0bab0100356ad9026"
                       "22128dcd44d86d99c59954c4e7716a4a"}),
    "journal_1303": Snark(
        "journal_digest_fr of the 0x1303 session's 1,248-byte journal",
        None, 15889, 15938, {
            "assignment": "48e657259ea60d55b7e2a3fdbca1fa8b"
                          "7f38d2130906135369a3ee2fd195c9e7",
            "constraints": JOURNAL_CONSTRAINTS_SHA256}),
    "journal_c02f": Snark(
        "journal_digest_fr of the c02f session's 1,056-byte journal",
        None, 15889, 15938, {
            "assignment": "d2dead1513226862458979b470479e83"
                          "87da45ca5dc9fb508086e8fb9b4754da",
            "constraints": JOURNAL_CONSTRAINTS_SHA256}),
}
#: SHA-256 of the JAX package's export_verifier("evm") files (the bundled
#: wrap_vk.json), scripts/session_proof_cpu.py --snark journal --reference
EXPORT_SHA256 = {
    "ZkTlsVerifier.sol":
    "82d6e400abac4088301d204844c7ac94753a44572fe94cfb016f8579369431e7",
    "Groth16Verifier.sol":
    "c4ec28a7c2f8eef31f9f98e00c1e79ea0c413cc3c6c8e6c6d941f143d1fdf848",
    "vk.json":
    "68df3b450262c546d9bf4969bdbd8a700f2ac559352a60c13911d2acf8043167",
}


def wrap_bn_machine() -> tuple[list[ChipInstance], bytes, dict]:
    """(the Fibonacci(5) chip, WRAP_BN_BINDING, WRAP_BN_CONFIG) of the
    `wrap_bn` path."""
    trace, pub = fibonacci_trace(5)
    return ([ChipInstance(air=FibonacciAir(), trace=trace, publics=pub)],
            WRAP_BN_BINDING, WRAP_BN_CONFIG)


def r1cs_digests(cs) -> dict:
    """{"assignment", "constraints"}: SHA-256 of the assignment (each
    value 32 bytes big-endian, in variable order) and of the constraints
    (per constraint the A, B and C combinations, each its term count and
    its (variable, coefficient) terms in the order the builder wrote
    them, as 4 + 32 bytes).  Works on either package's R1CS."""
    h = hashlib.sha256()
    for v in cs.assignment():
        h.update(int(v).to_bytes(32, "big"))
    c = hashlib.sha256()
    for lcs in cs.constraints:
        for lc in lcs:
            c.update(len(lc).to_bytes(4, "big"))
            for k, v in lc.items():
                c.update(int(k).to_bytes(4, "big")
                         + int(v).to_bytes(32, "big"))
    return {"assignment": h.hexdigest(), "constraints": c.hexdigest()}


#: single-AIR proof -> (its StarkConfig keywords, the JAX package's proof
#: bytes, made by scripts/session_proof_cpu.py --single NAME --reference)
SINGLES = {
    "fib": (dict(log_blowup=2, num_queries=12, fri_final_size=32),
            DATA / "fib_single.jax.proof"),
    "bytes": (dict(log_blowup=2, num_queries=10, pow_bits=4,
                   fri_final_size=32), DATA / "bytes_single.jax.proof"),
}


def single_air(name: str, log_n: int | None = None
               ) -> tuple[Air, np.ndarray, list[int]]:
    """(AIR, plain trace, publics) of a single-AIR proof of SINGLES:
    "fib", Fibonacci with 2^log_n rows (2^6 when None); "bytes", 2^log_n
    seeded bytes range-checked against the 256-entry table (200 values in
    256 rows when None)."""
    if name == "fib":
        trace, publics = fibonacci_trace(6 if log_n is None else log_n)
        return FibonacciAir(), trace, publics
    from .stark.chips.bytes_table import ByteRangeAir, byte_range_trace

    count = 200 if log_n is None else 1 << log_n
    values = np.random.default_rng(7).integers(0, 256, count)
    return ByteRangeAir(), byte_range_trace([int(v) for v in values]), []


LOOPBACK_CERT = DATA / "loopback_rsa2048.cert.pem"
LOOPBACK_KEY = DATA / "loopback_rsa2048.key.pem"
#: the loopback server's cipher string for each TLS 1.2 suite; any other
#: suite is TLS 1.3, offered alone by the client
LOOPBACK_TLS12 = {0xC02F: "ECDHE-RSA-AES128-GCM-SHA256",
                  0xCCA8: "ECDHE-RSA-CHACHA20-POLY1305"}
_PRICE_PREFIX, _PRICE_LEN, _BODY_LEN = b'"price":"', 10, 512


def loopback_response(seed: int = 0) -> bytes:
    """An HTTP response whose body is 512 seeded ASCII bytes of JSON (the
    committed sessions' answer)."""
    rng = np.random.default_rng(seed)
    price = "".join(str(d) for d in rng.integers(0, 10, _PRICE_LEN))
    head = (b'{"symbol":"ETHUSD",' + _PRICE_PREFIX + price.encode()
            + b'","data":"')
    tail = b'"}'
    alphabet = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz0123456789",
                             dtype=np.uint8)
    pad = alphabet[rng.integers(0, len(alphabet),
                                _BODY_LEN - len(head) - len(tail))].tobytes()
    return (b"HTTP/1.1 200 OK\r\nContent-Type: application/json\r\n"
            b"Content-Length: " + str(_BODY_LEN).encode() + b"\r\n\r\n"
            + head + pad + tail)


def loopback_request(port: int) -> Request:
    """The committed sessions' request, to 127.0.0.1:port: the price
    field's 10 bytes filtered by a prefix template."""
    return Request(
        version=1,
        request_info=RequestInfo(
            request=b"GET /v1/price?symbol=ETHUSD HTTP/1.1\r\n"
                    b"Host: localhost\r\nConnection: close\r\n\r\n",
            remote_addr=f"127.0.0.1:{port}", server_name="localhost"),
        response_template=[PrefixTemplate(prefix=_PRICE_PREFIX,
                                          length=_PRICE_LEN)])


@contextlib.contextmanager
def loopback_server(suite: int):
    """A one-connection TLS server on 127.0.0.1 with the committed test
    certificate, limited to `suite` (TLS 1.2 over P-256 for the suites of
    LOOPBACK_TLS12, else TLS 1.3): it reads one request and answers
    `loopback_response()`.  Yields its port."""
    response = loopback_response()
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    version = (ssl.TLSVersion.TLSv1_2 if suite in LOOPBACK_TLS12
               else ssl.TLSVersion.TLSv1_3)
    ctx.minimum_version = ctx.maximum_version = version
    if suite in LOOPBACK_TLS12:
        ctx.set_ciphers(LOOPBACK_TLS12[suite])
        ctx.set_ecdh_curve("prime256v1")
    ctx.load_cert_chain(LOOPBACK_CERT, LOOPBACK_KEY)
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)

    def serve():
        try:
            conn, _ = srv.accept()
        except OSError:
            return                      # closed before a client came
        try:
            tls = ctx.wrap_socket(conn, server_side=True)
            while b"\r\n\r\n" not in tls.recv(4096):
                pass
            tls.sendall(response)
            tls.unwrap()
        except (OSError, ssl.SSLError):
            pass  # the client closes without a close_notify
        finally:
            conn.close()

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    try:
        yield srv.getsockname()[1]
    finally:
        srv.close()
        t.join(timeout=10)


def record_loopback(suite: int, rng=None) -> GuestInput:
    """A live recording by the port's TLSInputBuilder against
    `loopback_server(suite)`; a TLS 1.3 suite is the one the client
    offers.  rng: the recorder's source of random bytes."""
    from .host.input_builder import TLSInputBuilder

    suites = None if suite in LOOPBACK_TLS12 else [suite]
    with loopback_server(suite) as port:
        return TLSInputBuilder(rng=rng, suites=suites).build_input(
            loopback_request(port))
