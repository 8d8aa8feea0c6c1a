#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (zktls_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--only PATH,...]

Phases, in order; any failure raises and the script exits non-zero
without printing a result:

  1. the card's name and power limit (nvidia-smi);
  2. build the Poseidon2 kernels (K1: permute, hash_rows, merkle_levels)
     from zktls_tpu_torch/csrc/, the host Poseidon2 library
     (csrc/poseidon2_host.c, the system C compiler) and the host MiMC
     library (csrc/mimc_bn254_host.c, with OpenMP); hold the Poseidon2
     library's permute_batch against the pure-Python plain version at
     widths 16 and 24 on seeded states, and the MiMC library's rows hash
     (its AVX-512 IFMA path where the CPU has one, and its scalar path)
     against the pure-Python mimc_hash on seeded rows, exactly;
  3. hold each entry point against its plain torch version on the card,
     exactly: permute at widths 16 and 24, several batch sizes, rows inside
     a larger batch; hash_rows at several (N, W), the main path's
     largest matrix among them, and its refusal of a strided matrix; merkle_levels, every level, at several N.  Time each
     and its plain version at the main path's shape beside the card's
     bound;
  4. the main path: prove the 32768 × 639 Sha256Air machine (8 messages of
     3,000 bytes, DEFAULT_CONFIG) on the card, with the kernel launch
     counters reset just before and read just after; verify the proof and
     reject one with a tampered digest limb;
  5. the same prove at 256 rows on the card and on the CPU: the proof
     bytes must be identical; then the grinding path (the same machine
     with 8 proof-of-work bits), the one caller of the permute entry
     point, with the counters reset before and read after;
  6. each committed session (zktls_tpu_torch.workload.SESSIONS, in order:
     c02f, the TLS 1.2 ECDHE(P-256)-RSA-AES128-GCM-SHA256 session; 1302,
     TLS 1.3 AES-256-GCM-SHA384; 1303, TLS 1.3 CHACHA20-POLY1305; the
     last two over x25519) from its GuestInput: read it with the port's
     GuestInput.from_cbor, replay it with the port's run_guest
     (require_trust_anchor=False: the loopback certificate anchors to no
     root), require its suite, chain report and journal length, build its
     chips with build_chip_instances and require their names and shapes,
     and require run_guest with the defaults to raise ReplayError ("does
     not anchor"), as the reference does; then hold hash_rows against its
     plain version at each chip's LDE shape (4 × height by width) and its
     perm matrix's that no earlier phase held, and merkle_levels at the
     session's largest tree;
  7. the main path for that session, StarkGuestProver().prove(guest_input):
     with the session leaf's own SPKI hash added to the port's trust store
     (the one change that lets the default replay accept the loopback
     session; the journal is the same bytes), prove cold (the session's
     first prove: new shapes and plans) and warm on the card (the launch
     counters reset just before each prove and read just after), print the
     replay, chip-build and prove seconds and the peak device memory, and
     require both proofs to be the same bytes; verify with
     StarkGuestProver().verify; reject the proof against a journal with a
     changed filtered byte; require the proof's SHA-256 to equal the
     digest of the port's CPU proof of the same session
     (SESSION_PROOF_SHA256, made by scripts/session_proof_cpu.py, whose
     bytes the JAX package's verifier accepts);
  8. a preprocessed machine (workload.preprocessed_machine: a FixedMulAir
     chip of 16,384 rows with its program in preprocessed columns beside a
     Fibonacci chip of 8,192): prove it on the card and on the CPU (the
     same bytes), verify with its vk root, and prove it again with host
     spill and chunked DEEP forced (spill_bytes=0, chunked_deep_bytes=0):
     the same bytes;
  9. the batches (workload.BATCHES), the c02f session twice (c02f_x2) and
     eight times (c02f_x8): replay each
     session, merge and build the chips and require their shapes, hold
     hash_rows against its plain version at every LDE and perm shape no
     earlier phase held and merkle_levels at the batch's largest tree, then
     StarkGuestProver().prove_batch on the card (launch counters reset just
     before and read just after; stage seconds, peak device memory, proof
     bytes).  c02f_x2's proof must hash to BATCH_PROOF_SHA256 (the port's
     CPU proof, scripts/session_proof_cpu.py --batch c02f_x2).
     verify_batch must reject each batch proof exactly where the JAX
     package's verify_batch rejects the same bytes, at StreamParserAir's
     constraint identity (PARSER_FAULT: the reference's AIR admits no
     trace of a second session's parser region), after the bus balance
     and the identities of the larger chips passed; a journal batch with a
     changed filtered byte in the second (c02f_x2) or fifth (c02f_x8)
     session must fail earlier, at the global bus balance;
 10. the compress rung (at full width): first the mid-scale
     compress — the 256-row Sha256Air machine of phase 5
     (workload.sha_compress_machine) proved on the card and compressed by
     recursion_prove on the card, inner and outer at DEFAULT_CONFIG: a
     256,047-instruction program, VmAir 262,144 rows; the outer proof must
     hash to COMPRESS_PROOF_SHA256 (the port's CPU bytes,
     scripts/session_proof_cpu.py --compress sha, which the JAX package's
     recursion_verify accepts) and verify.  Then the 0x1303 session's card
     proof from phase 7 (its digest required; proved here if the sessions
     path did not run): hold hash_rows against its plain version at every
     LDE shape of the outer chips (VmAir trace, preprocessed, perm and
     quotient at 2^25 rows; the sponge chips') and merkle_levels at 2^25
     leaves; StarkGuestProver().compress(journal, proof) on the card with
     the launch counters reset just before and read just after, its
     build_program, outer_chips and outer prove_machine stages'
     seconds, peak device memory, the blob's size and SHA-256 (which
     must equal COMPRESS_1303_SHA256, the blob of an earlier card run:
     the compress has no CPU reference at this width);
     the program must have 7,689,048 instructions and the outer
     chips VmAir 8,388,608, Sponge16Air 32,768 and Sponge24Air 65,536 rows
     (workload.COMPRESSES); verify_compressed with a fresh vk cache under
     build/ (cold: it rebuilds the program and derives the root, which must
     equal the blob's), again (cached), and against a journal with a
     changed filtered byte, which it must reject;
 11. the shrink rung (the slice's full-width path): first the tiny chain
     of tests/test_shrink_bn.py (workload.fib_chain: Fibonacci(5) proved
     and compressed at a tiny config, then shrunk by recursion_prove_bn)
     on the card: the shrink proof must hash to SHRINK_PROOF_SHA256 (the
     JAX package's bytes for the same chain, which the port's CPU shrink
     gives too) and verify.  Then the compress_1303 blob of phase 10 (its
     digest required; compressed here if the compress path did not run)
     shrunk at DEFAULT_CONFIG as the reference's StarkGuestProver.wrap
     does (workload.shrink_statement), with the launch counters reset just
     before and read just after: the program's instruction count and the
     outer chips' rows (workload.SHRINKS), the seconds of build_program,
     outer_chips, each prove_machine_bn stage and the host MiMC (mimc_s),
     peak device memory, the host's cores and the MiMC
     threads, the proof's bytes and SHA-256, and K1's launches (none: the
     shrink commits with MiMC on the host).  recursion_verify_bn must
     accept the proof after a bytes round trip of proof and vk, and reject
     it against a journal with a changed filtered byte, a vk with a
     changed program root, and a proof with one changed opened value;
 12. the Groth16 layer (snark/, host code with the C MSM, as in the
     reference), on the two paths the reference's host Groth16 can
     finish (workload.SNARKS), with the launch counters reset just before
     and read just after (K1 is launched no time: the BN machine commits
     with MiMC, the circuits and Groth16 run on the host):
     a. wrap_bn — the Fibonacci(5) machine of tests/test_stark_wrap.py
        proved with BN254/MiMC commitments on the card (its bytes must
        hash to the JAX package's) and verified; build_stark_wrap_circuit
        over it and cs.check(): 150,312 constraints and 147,714 variables,
        and the digests of its assignment and constraints equal the JAX
        package's.  Build the host MSM library (csrc/bn254_msm_host.c)
        and hold its G1 and G2 MSMs and fixed-base batches against the
        pure-Python plain version on seeded points and scalars, exactly.
        (This circuit's Groth16 setup and prove take ~270 s of host
        Python, and the plain MSM at the prove's sizes ~1 hour of one
        core: `python3 -m zktls_tpu_torch.profile_prove --workload
        wrap_bn` runs them on their own);
     b. journal_1303, journal_c02f — the journals of the 0x1303 and c02f
        sessions' card proofs from phase 7 (their digests required; proved
        here if the sessions path did not run) sealed under one CRS:
        wrap_setup() (its vk must equal the bundled snark/wrap_vk.json),
        each journal's circuit (counts and digests equal the JAX
        package's), wrap_prove, then wrap_verify and simulate_zktls_verify
        accept the seal and reject it against a journal with a changed
        filtered byte and against the digest + 1; export_verifier("evm")
        writes the three files, whose SHA-256 must equal the JAX
        package's.  The setup and prove seconds and the seal's bytes are
        printed; the 0x1303 session prove's K1 launches are this path's;
 13. the prover service and the live recorder: record a 0x1303 (TLS 1.3
     CHACHA20-POLY1305) and a c02f (TLS 1.2 over P-256) session on the
     loopback with the port's TLSInputBuilder against a Python `ssl`
     server holding the committed test certificate
     (workload.record_loopback), replay each with run_guest and require
     its suite and journal length; start the CLI's `serve` service,
     serve("stark", "127.0.0.1", 0) (StarkGuestProver on the card, built
     at the first prove), and, through RemoteGuestProver: health
     ("StarkGuestProver"); the committed 0x1303 session proved remotely
     (its journal == the local replay's, its proof's SHA-256 ==
     SESSION_PROOF_SHA256["1303"]; then a local prove of it, for its time
     and bytes);
     the live 0x1303 recording proved remotely with its leaf joined to the
     store, accepted by StarkGuestProver().verify and rejected against a
     changed filtered byte; a truncated GuestInput body answered 400.  K1
     launches counted over each remote prove must be non-zero (the
     service proves in-process on the card);
 14. the prover's remaining device paths: the four-step NTT (which `ntt`
     takes from 2^23 rows) against radix-2 on (2^23, 8) and (2^25, 8)
     seeded matrices (equal, `ntt` == the four-step, intt inverts; times
     and peaks); the single-AIR
     prove of the Fibonacci AIR at 2^16 rows and of the byte-range LogUp
     table at 2^15 (workload.single_air; the reference's single-AIR
     prove cannot take a bus chip such as Sha256Air): card == CPU bytes,
     verify accepts, a changed opening is rejected, and at the small
     sizes the card's bytes equal the committed JAX proofs
     (workload.SINGLES).  The Fibonacci card prove's K1 launches are
     this path's;
 15. several devices in one process (parallel/): the mesh is every card
     (make_mesh()), or on a host with one card that card twice as two
     logical shards (seg 1 × ntt 2); which one is printed.  With several
     cards, a K1 launch on the last card must leave torch's current device
     at card 0.  (a) ntt_sharded forward and inverse at 2^23 equal
     ntt/intt, and make_coset_lde_sharded at the 0x1303 session's largest
     chip (the one whose trace LDE the prove below shards) equals
     coset_lde; CUDA-event times beside the one-device ones.  (b) The
     0x1303 session's chips from phase 6 (built here if the sessions path
     did not run) proved by prove_machine on one device, then with
     devices= the mesh's devices and mesh= the mesh, the launch counters
     reset just before each prove and read just after: both proofs must
     hash to SESSION_PROOF_SHA256["1303"], StarkGuestProver().verify must
     accept the multi-device proof and reject it against a journal with a
     changed filtered byte; stage seconds and peak device memory of each.
     (c) The segment step of __graft_entry__.dryrun_multichip: two seeded
     (32768, 639) segments per seg device, coset_lde (blowup 2, shift 31)
     and hash_rows on the segment's device, leaves equal to one device's.
     The multi-device prove's K1 launches are this path's;
 16. one JSON line describing each kernel (launches: the compress's;
     permute: the grinding path's; every path's launches under
     "launches_by_path");
 17. last line: {"ok": true, "device": {...}}.

`--only` runs phases 1-3 and the named paths of sha, sessions,
preprocessed, c02f_x2, c02f_x8, compress, shrink, snark, service, paths,
parallel (a check while working on one of them; it prints neither the
kernels line nor the result; shrink runs compress first unless it was
named, snark the sessions it seals).  Needs one card (the parallel path
uses every card there is), nvcc (/usr/local/cuda), a C compiler with
OpenMP and no network.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

SEED = 20261016
#: main-path input: 8 messages × 3,000 bytes = 384 compressions = 24,576
#: rows, padded to 32,768
MAIN_MESSAGES, MAIN_BYTES = 8, 3000
#: SHA-256 of the port's DEFAULT_CONFIG proof of each committed session on
#: the CPU (python scripts/session_proof_cpu.py --session NAME, whose proof
#: the JAX package's verifier accepts); the card must give the same bytes
SESSION_PROOF_SHA256 = {
    "c02f":
    "b6516f414f18c407eace9e7ca9867bd6f672b14d16e8d7ada5b345411cb26b91",
    "1302":
    "46651a3b48ce0e2a5a87f9572edc322776426d2ef119832ea84cfa3b1b7c7a94",
    "1303":
    "45f02303ff4510ae74ee32a69f0e2cb03f652f886f6e37eede640756cea100c4",
}
#: SHA-256 of the port's DEFAULT_CONFIG proof of a batch on the CPU
#: (python scripts/session_proof_cpu.py --batch NAME)
BATCH_PROOF_SHA256 = {
    "c02f_x2":
    "4d0290f470e8c5bd746c870d0e2873a62f99ccadb1e18eaa3430910141470a5c",
}
#: where both packages' verify_batch reject a batch proof: the
#: reference's StreamParserAir resets its byte counter to 0 at a region
#: start (zktls_tpu/stark/chips/stream_parser.py:276), while its first-row
#: rule and region-end length check count the region's first byte, so no
#: trace of a second session's region satisfies it
PARSER_FAULT = "StreamParserAir: constraint identity failed at zeta"
#: the optional paths, in the order they run
PATHS = ("sha", "sessions", "preprocessed", "c02f_x2", "c02f_x8",
         "compress", "shrink", "snark", "service", "paths", "parallel")
#: rows per block of a plain hash_rows held against the kernel
PLAIN_ROWS = 1 << 21
#: SHA-256 of the port's DEFAULT_CONFIG compress of the 256-row Sha256Air
#: machine on the CPU (python scripts/session_proof_cpu.py --compress sha,
#: whose outer proof the JAX package's recursion_verify accepts)
COMPRESS_PROOF_SHA256 = (
    "f0b53f6e5d20d68e29a8883807324dfcc2d74ed29642255957a417ecafaa871b")
#: the mid-scale compress's program and outer chips (rows)
SHA_COMPRESS_INSTRS = 256047
SHA_COMPRESS_CHIPS = {"VmAir": 262144, "Sponge16Air": 4096,
                      "Sponge24Air": 2048}
#: SHA-256 of the 0x1303 session's DEFAULT_CONFIG compress blob
#: (StarkGuestProver.compress of the SESSION_PROOF_SHA256["1303"] proof)
COMPRESS_1303_SHA256 = (
    "35c6381590dfcaacc2d997f9ec7bc80545c56d4239fe2df543ca935deedca80a")
#: SHA-256 of the JAX package's shrink proof of tests/test_shrink_bn.py's
#: chain (python scripts/session_proof_cpu.py --shrink fib, which proves
#: the chain with both packages and requires the same bytes)
SHRINK_PROOF_SHA256 = (
    "91fd559a6de627391e318d540529366e139458c2d593a84997227b8ec40cbdf9")


def _nvidia_smi(fields: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(what)


def _time_ms(fn, reps: int, runs: int = 5) -> float:
    """Median over `runs` of the mean time of `reps` calls (CUDA events),
    after a warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / reps)
    return statistics.median(times)


def _tamper_filtered(journal: bytes) -> tuple[bytes, int]:
    """The journal with its first filtered byte flipped (the ABI's bytes[]
    at head word 13), and that byte's offset."""
    off = int.from_bytes(journal[13 * 32 : 14 * 32], "big")
    rel = int.from_bytes(journal[off + 32 : off + 64], "big")
    pos = off + 32 + rel + 32
    return journal[:pos] + bytes([journal[pos] ^ 1]) + journal[pos + 1 :], pos


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", type=lambda v: v.split(","), default=None,
                    help=f"comma-separated paths of {', '.join(PATHS)}")
    args = ap.parse_args()
    paths = PATHS if args.only is None else tuple(args.only)
    _require(set(paths) <= set(PATHS), f"unknown paths {paths}")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import numpy as np

    from zktls_tpu_torch.ops import babybear as bb
    from zktls_tpu_torch.ops import cuda_poseidon2 as k1
    from zktls_tpu_torch.ops import merkle as mk
    from zktls_tpu_torch.ops import poseidon2 as p2
    from zktls_tpu_torch.stark.chips.sha256 import Sha256Air
    from zktls_tpu_torch.stark.config import DEFAULT_CONFIG
    from zktls_tpu_torch.stark.machine import (
        STAGES,
        MachineProof,
        prove_machine,
        verify_machine,
    )
    from zktls_tpu_torch.core.types import GuestInput
    from zktls_tpu_torch.guest import roots
    from zktls_tpu_torch.guest.program import run_guest
    from zktls_tpu_torch.guest.replay import ReplayError
    from zktls_tpu_torch.models.fibonacci import FibonacciAir
    from zktls_tpu_torch.provers.stark import (
        StarkGuestProver,
        build_chip_instances,
        merge_guest_outputs,
    )
    from zktls_tpu_torch.core import cbor
    from zktls_tpu_torch.stark.machine import preprocessed_root
    from zktls_tpu_torch.provers.stark import journal_public_messages
    from zktls_tpu_torch.snark.wrap import mimc_hash
    from zktls_tpu_torch.stark.config import StarkConfig
    from zktls_tpu_torch.stark.machine_bn import MachineProofBN
    from zktls_tpu_torch.stark.recursion import (
        RecursionVK,
        RecursionVKBN,
        outer_airs,
        recursion_prove,
        recursion_prove_bn,
        recursion_verify,
        recursion_verify_bn,
    )
    from zktls_tpu_torch.stark.verifier import VerificationError
    from zktls_tpu_torch.utils import native
    from zktls_tpu_torch.snark import bn254, wrap
    from zktls_tpu_torch.snark.stark_wrap import build_stark_wrap_circuit
    from zktls_tpu_torch.stark.machine_bn import (
        prove_machine_bn,
        verify_machine_bn,
    )
    from zktls_tpu_torch.verifier_export import (
        export_verifier,
        simulate_zktls_verify,
    )
    from zktls_tpu_torch.ops import ntt as ntt_mod
    from zktls_tpu_torch.parallel.mesh import make_mesh
    from zktls_tpu_torch.parallel.ntt import (
        make_coset_lde_sharded,
        make_ntt_sharded,
    )
    from zktls_tpu_torch.provers.service import RemoteGuestProver, serve
    from zktls_tpu_torch.stark.proof import StarkProof
    from zktls_tpu_torch.stark.prover import prove as prove_single
    from zktls_tpu_torch.stark.verifier import verify as verify_single
    from zktls_tpu_torch.workload import (
        BATCHES,
        COMPRESSES,
        EXPORT_SHA256,
        FIB_CHAIN_BINDING,
        FIB_CHAIN_CONFIG,
        SESSIONS,
        SHRINKS,
        SINGLES,
        SNARKS,
        FixedMulAir,
        fib_chain,
        preprocessed_machine,
        r1cs_digests,
        record_loopback,
        session_machine,
        sha_compress_machine,
        sha_machine,
        shrink_statement,
        single_air,
        wrap_bn_machine,
    )

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # 1. the card
    print(_nvidia_smi("name,power.limit"))
    clock_mhz = float(_nvidia_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    # 2. build K1
    t0 = time.perf_counter()
    _, report = k1.build()
    regs = [line.split("Used")[1].strip() for line in report.splitlines()
            if "Used" in line and "registers" in line]
    print(f"build: poseidon2.cu {time.perf_counter() - t0:.2f} s; "
          f"ptxas: {regs}")
    t0 = time.perf_counter()
    lib_path, _ = native.build()
    build_s = time.perf_counter() - t0
    host_rng = np.random.default_rng(SEED + 1)
    for width in (16, 24):
        states = host_rng.integers(0, bb.P, (256, width), dtype=np.uint32)
        states[0], states[1] = 0, bb.P - 1
        got = native.permute_batch(states, width=width)
        plain = p2.Poseidon2(width, native=False)
        for row, out in zip(states, got):
            _require([int(x) for x in out] ==
                     plain.permute_ints([int(x) for x in row]),
                     f"host Poseidon2 != plain at width {width}")
    print(f"build: poseidon2_host.c {build_s:.2f} s -> {lib_path.name}; "
          "host permute_batch == pure-Python plain at widths 16/24 on 256 "
          "seeded states each (0 and p - 1 among them)")
    t0 = time.perf_counter()
    lib_path, _ = native.build_mimc()
    build_s = time.perf_counter() - t0
    fr_rows = [[int.from_bytes(host_rng.bytes(32), "little")
                for _ in range(3)] for _ in range(64)]
    fr_rows[0], fr_rows[1] = [0] * 3, [(1 << 256) - 1] * 3
    elems = np.array([[[(v >> (64 * j)) & (2**64 - 1) for j in range(4)]
                       for v in row] for row in fr_rows], dtype=np.uint64)
    want = [mimc_hash(row) for row in fr_rows]
    paths_taken = []
    for vector in (True, False):
        paths_taken.append(native._set_mimc_vector(vector))
        got = [sum(int(x) << (64 * j) for j, x in enumerate(d))
               for d in native.mimc_hash_rows(elems)]
        _require(got == want, f"host MiMC (vector={vector}) != mimc_hash")
    vector_on = native._set_mimc_vector(True)
    print(f"build: mimc_bn254_host.c (-fopenmp) {build_s:.2f} s -> "
          f"{lib_path.name}; host mimc_hash_rows == pure-Python mimc_hash "
          f"on 64 seeded rows of 3 scalars (0 and 2^256 - 1 among them), "
          f"AVX-512 IFMA path {'taken' if paths_taken[0] else 'absent'} "
          f"and scalar path; {native.mimc_threads()} MiMC threads on "
          f"{os.cpu_count()} cores, vector path "
          f"{'on' if vector_on else 'off'}")

    # 3. each entry point against its plain version on the card
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)

    def rand_field(*shape):
        """Seeded uniform field values (Montgomery form), made on the card:
        the largest matrices held below are 2^25 rows."""
        return bb.to_mont(torch.randint(0, bb.P, shape, generator=gen,
                                        dtype=bb.DTYPE, device=dev))

    def abs_err(got, want):
        _require(got.shape == want.shape and got.dtype == want.dtype,
                 f"kernel gave {got.dtype} {tuple(got.shape)}, plain "
                 f"{want.dtype} {tuple(want.shape)}")
        return int((got - want).abs().max())

    errs = {"permute": 0, "hash_rows": 0, "merkle_levels": 0}

    session_proofs = {}
    #: each session's (chips, journal) from phase 6
    session_chips = {}

    def session_path(name: str, covered: set) -> dict:
        """Phases 6 and 7 for one committed session; returns the K1
        launches of its warm prove and keeps (journal, proof) in
        session_proofs."""
        spec = SESSIONS[name]
        tag = f"session {name}:"
        guest_input = GuestInput.from_cbor(spec.guest_input.read_bytes())
        t0 = time.perf_counter()
        session = run_guest(guest_input, require_trust_anchor=False)
        replay_s = time.perf_counter() - t0
        journal = session.journal
        suite = session.replay.cipher_suite.id
        _require(suite == spec.suite, f"{tag} the suite is 0x{suite:04X}")
        _require(session.chain == spec.chain,
                 f"{tag} the chain report is {session.chain}")
        _require(len(journal) == spec.journal_bytes,
                 f"{tag} the journal is {len(journal)} bytes")
        t0 = time.perf_counter()
        chips = build_chip_instances(session)
        build_s = time.perf_counter() - t0
        session_chips[name] = (chips, journal)
        rec512 = session.replay.sha512_recorder
        print(f"{tag} GuestInput {spec.guest_input.name}, run_guest "
              f"(require_trust_anchor=False) {replay_s:.2f} s: journal "
              f"{len(journal)} bytes, suite 0x{suite:04X}, "
              f"{len(session.replay.sha256_recorder.events)} SHA-256 and "
              f"{len(rec512.events) if rec512 else 0} SHA-512 compressions, "
              f"{len(session.modmul_events)} ModMul events, "
              f"{len(session.replay.gcm_events)} GCM and "
              f"{len(session.replay.chacha_events or [])} ChaCha events; "
              f"chain {session.chain}")
        print(f"{tag} build_chip_instances {build_s:.2f} s: " + ", ".join(
            f"{c.air.name} {c.trace.shape[0]}x{c.trace.shape[1]}"
            for c in chips))
        got = tuple((c.air.name, *c.trace.shape) for c in chips)
        _require(got == spec.chips, f"{tag} the chips are {got}")
        try:
            run_guest(guest_input)
        except ReplayError as e:
            _require("does not anchor" in str(e), f"run_guest raised {e}")
            print(f"{tag} run_guest with the defaults refuses the loopback "
                  f"certificate ({e})")
        else:
            raise RuntimeError("run_guest accepted a chain that anchors to "
                               "no root of the store")
        hold_k1_at(tag, lde_shapes(chips), covered)

        # the main path, StarkGuestProver.prove, through K1.  The loopback
        # certificate is self-signed, so the leaf's SPKI hash joins the
        # store: verify_chain then finds "a root that is itself in the
        # store" and publishes that same hash as root_spki_sha256, so no
        # journal byte changes.
        leaf_spki = bytes.fromhex(spec.chain["root_spki_sha256"])
        store = roots.anchor_spki_hashes() | {leaf_spki}
        print(f"{tag} the leaf's SPKI hash {leaf_spki.hex()} is added to "
              f"the port's trust store ({len(store) - 1} anchors) for "
              "StarkGuestProver.prove")
        runs = {}
        with mock.patch.object(roots, "anchor_spki_hashes", lambda: store):
            for label in ("cold", "warm"):
                torch.cuda.reset_peak_memory_stats(dev)
                timings: dict = {}
                k1.reset_launches()
                p2.plain_calls = 0
                t0 = time.perf_counter()
                run_journal, blob = StarkGuestProver().prove(
                    guest_input, timings=timings)
                torch.cuda.synchronize(dev)
                runs[label] = (time.perf_counter() - t0, timings, blob,
                               dict(k1.launches), p2.plain_calls,
                               torch.cuda.max_memory_allocated(dev) / 2**30)
                _require(run_journal == journal,
                         f"{tag} StarkGuestProver.prove gave another "
                         "journal than run_guest")
        for label, (tot, t, _, got_launches, plain, peak) in runs.items():
            for entry in ("hash_rows", "merkle_levels"):
                _require(got_launches[entry] > 0,
                         f"{tag} the {label} prove launched {entry} no time")
            _require(plain == 0,
                     f"{tag} the {label} prove ran the plain Poseidon2")
            print(f"{tag} {label} StarkGuestProver.prove {tot:.2f} s")
            print(f"{tag} {label} run_guest {t['run_guest']:.2f} s")
            print(f"{tag} {label} build_chip_instances "
                  f"{t['build_chip_instances']:.2f} s")
            print(f"{tag} {label} prove_machine "
                  f"{sum(t[k] for k in STAGES):.2f} s")
            print(f"{tag} {label} peak device memory {peak:.2f} GiB")
        _, timings, blob, warm_launches, plain, _ = runs["warm"]
        _require(all(r[2] == blob for r in runs.values()),
                 f"{tag} the cold and warm proofs differ")
        digest = hashlib.sha256(blob).hexdigest()
        print(f"{tag} warm stages " + ", ".join(
            f"{k} {timings[k]:.3f}" for k in STAGES)
            + f"; proof {len(blob)} bytes, sha256 {digest}; K1 launches per "
            f"prove {warm_launches}, total {sum(warm_launches.values())}, "
            f"plain calls {plain}")
        _require(digest == SESSION_PROOF_SHA256[name],
                 f"{tag} the card's proof differs from the CPU proof's "
                 "digest")
        t0 = time.perf_counter()
        _require(StarkGuestProver().verify(journal, blob),
                 f"{tag} StarkGuestProver rejected the proof")
        verify_s = time.perf_counter() - t0
        print(f"{tag} StarkGuestProver.verify {verify_s:.2f} s")
        bad, pos = _tamper_filtered(journal)
        t0 = time.perf_counter()
        try:
            StarkGuestProver().verify(bad, blob)
        except VerificationError as e:
            print(f"{tag} verify ok; proof == CPU proof digest; journal "
                  f"with filtered byte {pos} changed rejected in "
                  f"{time.perf_counter() - t0:.2f} s ({e}); total "
                  f"{time.perf_counter() - t_start:.1f} s")
        else:
            raise RuntimeError(f"{tag} the proof verified against a "
                               "tampered journal")
        session_proofs[name] = (journal, blob)
        return warm_launches

    def hold_k1_at(tag: str, shapes: list, covered: set) -> None:
        """hash_rows == plain at each (chip, what, rows, width) not yet
        covered, and merkle_levels == plain at the largest tree."""
        for chip, what, n, w in shapes:
            if (n, w) in covered:
                continue
            covered.add((n, w))
            rows = rand_field(n, w)
            got = mk.hash_rows(rows)
            # rows hash independently: the plain version runs in row
            # blocks, so its temporaries stay small at 2^25 rows
            err = max(abs_err(got[r0 : r0 + PLAIN_ROWS],
                              mk.hash_rows_plain(rows[r0 : r0 + PLAIN_ROWS]))
                      for r0 in range(0, n, PLAIN_ROWS))
            errs["hash_rows"] = max(errs["hash_rows"], err)
            _require(err == 0, f"hash_rows != plain at ({n}, {w})")
            print(f"{tag} kernel: hash_rows == plain at ({n}, {w}), {chip} "
                  f"{what} LDE, max abs err {err}")
            del rows, got
        n_tree = max(n for _, _, n, _ in shapes)
        if ("tree", n_tree) in covered:
            return
        covered.add(("tree", n_tree))
        leaves = rand_field(n_tree, mk.DIGEST_WIDTH)
        err = abs_err(mk.tree_levels(leaves), mk.tree_levels_plain(leaves))
        errs["merkle_levels"] = max(errs["merkle_levels"], err)
        _require(err == 0, f"merkle_levels != plain at N={n_tree}")
        print(f"{tag} kernel: merkle_levels == plain, every level, at "
              f"N={n_tree} (the largest tree), max abs err {err}")

    def lde_shapes(chips) -> list:
        shapes = []
        for c in chips:
            lde_rows = c.trace.shape[0] << DEFAULT_CONFIG.log_blowup
            shapes += [(c.air.name, "trace", lde_rows, c.air.width),
                       (c.air.name, "perm", lde_rows, c.air.perm_width)]
        return [sh for sh in shapes if sh[3]]

    def batch_path(name: str, covered: set, tamper: int) -> dict:
        """Phase 9 for one batch; returns the K1 launches of its prove."""
        spec = BATCHES[name]
        tag = f"batch {name}:"
        inputs = [GuestInput.from_cbor(SESSIONS[s].guest_input.read_bytes())
                  for s in spec.sessions]
        t0 = time.perf_counter()
        outs = [run_guest(gi, require_trust_anchor=False) for gi in inputs]
        replay_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        chips = build_chip_instances(merge_guest_outputs(outs))
        build_s = time.perf_counter() - t0
        got = tuple((c.air.name, *c.trace.shape, c.air.perm_width)
                    for c in chips)
        _require(got == spec.chips, f"{tag} the chips are {got}")
        cells = sum(c.trace.size for c in chips)
        print(f"{tag} {len(inputs)} sessions, run_guest "
              f"{replay_s:.2f} s; merge_guest_outputs + build_chip_instances "
              f"{build_s:.2f} s: {cells} trace cells, " + ", ".join(
                  f"{c.air.name} {c.trace.shape[0]}x{c.trace.shape[1]}"
                  for c in chips))
        hold_k1_at(tag, lde_shapes(chips), covered)
        del chips, outs
        store = roots.anchor_spki_hashes() | {
            bytes.fromhex(SESSIONS[s].chain["root_spki_sha256"])
            for s in spec.sessions}
        with mock.patch.object(roots, "anchor_spki_hashes", lambda: store):
            torch.cuda.reset_peak_memory_stats(dev)
            timings: dict = {}
            k1.reset_launches()
            p2.plain_calls = 0
            t0 = time.perf_counter()
            journals, blob = StarkGuestProver().prove_batch(
                inputs, timings=timings)
            torch.cuda.synchronize(dev)
            prove_s = time.perf_counter() - t0
            launches = dict(k1.launches)
            plain = p2.plain_calls
            peak = torch.cuda.max_memory_allocated(dev) / 2**30
        for entry in ("hash_rows", "merkle_levels"):
            _require(launches[entry] > 0,
                     f"{tag} the prove launched {entry} no time")
        _require(plain == 0, f"{tag} the prove ran the plain Poseidon2")
        digest = hashlib.sha256(blob).hexdigest()
        print(f"{tag} StarkGuestProver.prove_batch {prove_s:.2f} s = "
              f"run_guest {timings['run_guest']:.2f} + merge_guest_outputs "
              f"+ build_chip_instances {timings['build_chip_instances']:.2f}"
              f" + prove_machine {sum(timings[k] for k in STAGES):.2f}")
        print(f"{tag} stages " + ", ".join(
            f"{k} {timings[k]:.3f}" for k in STAGES)
            + f"; peak device memory {peak:.2f} GiB; proof {len(blob)} "
            f"bytes, sha256 {digest}; K1 launches {launches}, total "
            f"{sum(launches.values())}, plain calls {plain}")
        if name in BATCH_PROOF_SHA256:
            _require(digest == BATCH_PROOF_SHA256[name],
                     f"{tag} the card's proof differs from the CPU proof's "
                     "digest")
            print(f"{tag} proof == the CPU proof's digest")
        t0 = time.perf_counter()
        try:
            StarkGuestProver().verify_batch(journals, blob)
        except VerificationError as e:
            _require(str(e) == PARSER_FAULT,
                     f"{tag} verify_batch rejected the proof at {e}")
            print(f"{tag} StarkGuestProver.verify_batch "
                  f"{time.perf_counter() - t0:.2f} s: rejected at the "
                  f"reference's StreamParserAir identity ({e}), every "
                  "check before it passed")
        else:
            raise RuntimeError(f"{tag} verify_batch accepted a proof the "
                               "JAX package's verify_batch rejects")
        bad, pos = _tamper_filtered(journals[tamper])
        bad_journals = journals[:tamper] + [bad] + journals[tamper + 1:]
        t0 = time.perf_counter()
        try:
            StarkGuestProver().verify_batch(bad_journals, blob)
        except VerificationError as e:
            _require(str(e) == "global bus imbalance",
                     f"{tag} the tampered batch failed at {e}")
            print(f"{tag} journals with filtered byte {pos} of session "
                  f"{tamper + 1} changed rejected at the bus balance in "
                  f"{time.perf_counter() - t0:.2f} s ({e}); total "
                  f"{time.perf_counter() - t_start:.1f} s")
        else:
            raise RuntimeError(f"{tag} a tampered batch passed")
        return launches

    for width in (16, 24):
        for n in (1, 511, 513, 131072):
            x = rand_field(n, width)
            err = abs_err(p2.permute_batch(x), p2.permute_batch_plain(x))
            errs["permute"] = max(errs["permute"], err)
            _require(err == 0, f"permute != plain at width {width}, N={n}")
        big = rand_field(1529, width)
        _require(bool((p2.permute_batch(big[:5].contiguous())
                       == p2.permute_batch(big)[:5]).all()),
                 f"permute rows depend on their batch at width {width}")
    for n, w in ((1, 1), (513, 8), (513, 17), (4096, 639), (131072, 16)):
        rows = rand_field(n, w)
        err = abs_err(mk.hash_rows(rows), mk.hash_rows_plain(rows))
        errs["hash_rows"] = max(errs["hash_rows"], err)
        _require(err == 0, f"hash_rows != plain at ({n}, {w})")
    try:
        mk.hash_rows(rand_field(64, 40)[:, ::2])
    except ValueError as e:
        print(f"kernel: hash_rows refuses a strided matrix ({e})")
    else:
        raise RuntimeError("hash_rows took a strided matrix")
    for n in (2, 64, 4096, 131072):
        leaves = rand_field(n, mk.DIGEST_WIDTH)
        got, want = mk.tree_levels(leaves), mk.tree_levels_plain(leaves)
        err = abs_err(got, want)
        errs["merkle_levels"] = max(errs["merkle_levels"], err)
        _require(err == 0, f"merkle_levels != plain at N={n}")
        _require(mk.level_bounds(n)[-1] == (2 * n - 2, 2 * n - 1),
                 "the root is not the buffer's last row")
    torch.cuda.synchronize(dev)
    print("kernel: permute == plain at widths 16/24, N in 1/511/513/131072;"
          " hash_rows == plain at (1,1) (513,8) (513,17) (4096,639) "
          "(131072,16); merkle_levels == plain, every level, at N in "
          f"2/64/4096/131072 (max abs err {max(errs.values())})")

    n_main, w_main = 131072, 639
    x32 = rand_field(n_main, 24).to(torch.int32)
    x64 = x32.to(bb.DTYPE)
    rows = rand_field(n_main, w_main)
    buf = torch.empty((2 * n_main - 1, mk.DIGEST_WIDTH), dtype=bb.DTYPE,
                      device=dev)
    buf[:n_main] = rand_field(n_main, mk.DIGEST_WIDTH)
    err = abs_err(k1.hash_rows(rows), mk.hash_rows_plain(rows))
    errs["hash_rows"] = max(errs["hash_rows"], err)
    _require(err == 0, f"hash_rows != plain at ({n_main}, {w_main})")
    print(f"kernel: hash_rows == plain at ({n_main}, {w_main}), the main "
          "path's largest matrix")
    timed = {
        "permute": (
            f"({n_main}, 24)",
            _time_ms(lambda: k1.permute_batch(x32), reps=50),
            _time_ms(lambda: p2.permute_batch_plain(x64), reps=3, runs=3),
            k1.bound({24: n_main}, sms, clock_mhz)),
        "hash_rows": (
            f"({n_main}, {w_main})",
            _time_ms(lambda: k1.hash_rows(rows), reps=5),
            _time_ms(lambda: mk.hash_rows_plain(rows), reps=1, runs=3),
            k1.hash_rows_bound(n_main, w_main, sms, clock_mhz)),
        "merkle_levels": (
            f"{n_main} leaves",
            _time_ms(lambda: k1.merkle_levels(buf), reps=20),
            _time_ms(lambda: mk.tree_levels_plain(buf[:n_main]), reps=1,
                     runs=3),
            k1.merkle_levels_bound(n_main, sms, clock_mhz)),
    }
    del rows, x32, x64, buf
    for name, (shape, ms, plain_ms, b) in timed.items():
        print(f"kernel: {name} {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
              f"{b['bound_s'] * 1e3:.4f} ms ({b['bound_by']}: "
              f"{b['multiplies']} int32 multiplies at "
              f"{k1.INT_MULS_PER_CLOCK_PER_SM}/clk/SM x {sms} SMs x "
              f"{clock_mhz} MHz; {b['bytes']} bytes "
              f"{b['bytes_s'] * 1e3:.4f} ms) at {shape}")
    print("kernel: no single PyTorch call computes Poseidon2, a sponge or a "
          "tree over it: library_ms null")

    def sha_path() -> dict:
        """Phases 4 and 5; returns the K1 launches of the Sha256Air prove
        and of the grinding prove."""
        # 4. the main path, through K1
        inst, msgs = sha_machine(MAIN_MESSAGES, MAIN_BYTES, SEED)
        _require(inst.trace.shape == (32768, 639),
                 f"main trace is {inst.trace.shape}, want (32768, 639)")
        binding = b"chip-smoke sha256 machine"
        torch.cuda.reset_peak_memory_stats(dev)
        timings: dict = {}
        k1.reset_launches()
        p2.plain_calls = 0
        t0 = time.perf_counter()
        proof = prove_machine([inst], binding, DEFAULT_CONFIG, device=dev,
                              timings=timings)
        torch.cuda.synchronize(dev)
        prove_s = time.perf_counter() - t0
        launches, plain_calls = dict(k1.launches), p2.plain_calls
        for name in ("hash_rows", "merkle_levels"):
            _require(launches[name] > 0, f"the main path launched {name} no time")
        _require(plain_calls == 0, "the main path ran the plain Poseidon2")
        blob = proof.to_bytes()
        peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
        print("main: Sha256Air 32768x639 DEFAULT_CONFIG prove "
              f"{prove_s:.2f} s; stages " + ", ".join(
                  f"{k} {timings[k]:.3f}" for k in STAGES)
              + f"; proof {len(blob)} bytes; K1 launches {launches}, total "
              f"{sum(launches.values())}, plain calls {plain_calls}; peak device "
              f"memory {peak_gib:.2f} GiB")
        t0 = time.perf_counter()
        _require(verify_machine([Sha256Air()], MachineProof.from_bytes(blob),
                                binding, msgs, DEFAULT_CONFIG),
                 "verifier rejected the main proof")
        verify_s = time.perf_counter() - t0
        tag, payload, mult = msgs[0]
        bad = [(tag, payload[:1] + [(payload[1] + 1) % 65536] + payload[2:],
                mult)] + msgs[1:]
        try:
            verify_machine([Sha256Air()], MachineProof.from_bytes(blob), binding,
                           bad, DEFAULT_CONFIG)
        except VerificationError as e:
            print(f"main: verify {verify_s:.2f} s ok; tampered digest limb "
                  f"rejected ({e})")
        else:
            raise RuntimeError("verifier accepted a tampered digest limb")

        # 5. card vs CPU at 256 rows
        small, small_msgs = sha_machine(2, 100, SEED)
        _require(small.trace.shape == (256, 639), "small trace shape")
        on_card = prove_machine([small], binding, DEFAULT_CONFIG,
                                device=dev).to_bytes()
        on_cpu = prove_machine([small], binding, DEFAULT_CONFIG,
                               device="cpu").to_bytes()
        _require(on_card == on_cpu, "card and CPU proofs differ at 256 rows")
        print(f"path: 256-row proof identical on card and CPU "
              f"({len(on_card)} bytes)")
        grind_config = dataclasses.replace(DEFAULT_CONFIG, pow_bits=8)
        k1.reset_launches()
        p2.plain_calls = 0
        ground = prove_machine([small], binding, grind_config, device=dev)
        grinding = {"permute": k1.launches["permute"]}
        _require(grinding["permute"] > 0, "grinding launched permute no time")
        _require(p2.plain_calls == 0, "grinding ran the plain Poseidon2")
        _require(verify_machine([Sha256Air()],
                                MachineProof.from_bytes(ground.to_bytes()),
                                binding, small_msgs, grind_config),
                 "verifier rejected the ground proof")
        print(f"path: 256-row prove with 8 grinding bits verified, permute "
              f"launches {grinding['permute']} (witness {ground.pow_witness}); "
              f"total {time.perf_counter() - t_start:.1f} s")
        return {"sha": launches, "grinding": grinding}

    def preprocessed_path() -> None:
        """Phase 8: a machine with a preprocessed commit, on the card and
        the CPU, and with host spill and chunked DEEP forced."""
        log_n = 14
        chips, pre = preprocessed_machine(log_n)
        binding = b"chip-smoke preprocessed machine"
        t0 = time.perf_counter()
        on_card = prove_machine(chips, binding, DEFAULT_CONFIG,
                                device=dev).to_bytes()
        card_s = time.perf_counter() - t0
        on_cpu = prove_machine(chips, binding, DEFAULT_CONFIG,
                               device="cpu").to_bytes()
        _require(on_card == on_cpu,
                 "preprocessed machine: card and CPU proofs differ")
        root = preprocessed_root(FixedMulAir(), pre, log_n, log_n,
                                 DEFAULT_CONFIG, device=dev)
        _require(verify_machine([FixedMulAir(), FibonacciAir()],
                                MachineProof.from_bytes(on_card), binding,
                                config=DEFAULT_CONFIG,
                                preprocessed_roots={"FixedMulAir": root}),
                 "preprocessed machine: the verifier rejected the proof")
        try:
            verify_machine([FixedMulAir(), FibonacciAir()],
                           MachineProof.from_bytes(on_card), binding,
                           config=DEFAULT_CONFIG)
        except VerificationError as e:
            missing = str(e)
        else:
            raise RuntimeError("preprocessed machine: verified without its "
                               "vk root")
        forced = prove_machine(chips, binding, DEFAULT_CONFIG, device=dev,
                               spill_bytes=0,
                               chunked_deep_bytes=0).to_bytes()
        _require(forced == on_card, "preprocessed machine: spill and "
                 "chunked DEEP changed the proof bytes")
        print(f"preprocessed: FixedMulAir {1 << log_n}x2 (+2 preprocessed) "
              f"beside FibonacciAir {1 << (log_n - 1)}x2, card prove "
              f"{card_s:.2f} s, {len(on_card)} bytes == the CPU proof; "
              f"verified with the vk root; without it rejected ({missing}); "
              "spill_bytes=0, chunked_deep_bytes=0 give the same bytes")

    compress_blobs = {}

    def compress_path(covered: set) -> dict:
        """Phase 10: the mid-scale compress against its CPU bytes, then
        the compress of the 0x1303 session's proof at full width; returns
        the K1 launches of StarkGuestProver.compress and keeps (journal,
        blob) in compress_blobs."""
        tag = "compress sha:"
        inst, msgs, binding = sha_compress_machine()
        t0 = time.perf_counter()
        inner = prove_machine([inst], binding, DEFAULT_CONFIG, device=dev)
        timings: dict = {}
        vk, outer = recursion_prove([Sha256Air()], inner, binding, msgs,
                                    DEFAULT_CONFIG, DEFAULT_CONFIG,
                                    timings=timings, device=dev)
        blob = outer.to_bytes()
        digest = hashlib.sha256(blob).hexdigest()
        got = {c.name: 1 << c.log_n for c in outer.chips}
        print(f"{tag} Sha256Air {inst.trace.shape[0]}x{inst.trace.shape[1]} "
              f"inner proof and recursion_prove on the card "
              f"{time.perf_counter() - t0:.2f} s: {vk.n_instrs} "
              f"instructions, outer chips {got}; outer proof {len(blob)} "
              f"bytes, sha256 {digest}")
        _require(vk.n_instrs == SHA_COMPRESS_INSTRS,
                 f"{tag} the program has {vk.n_instrs} instructions")
        _require(got == SHA_COMPRESS_CHIPS, f"{tag} the outer chips are {got}")
        _require(digest == COMPRESS_PROOF_SHA256,
                 f"{tag} the card's outer proof differs from the CPU proof's "
                 "digest")
        _require(recursion_verify([Sha256Air()], vk,
                                  MachineProof.from_bytes(blob), binding,
                                  msgs, DEFAULT_CONFIG, DEFAULT_CONFIG),
                 f"{tag} recursion_verify rejected the outer proof")
        print(f"{tag} outer proof == the CPU proof's digest; "
              "recursion_verify ok")

        # the full-width compress: the 0x1303 session's card proof
        spec = COMPRESSES["compress_1303"]
        tag = "compress 1303:"
        if spec.session not in session_proofs:
            session_path(spec.session, covered)
        journal, proof = session_proofs[spec.session]
        _require(hashlib.sha256(proof).hexdigest()
                 == SESSION_PROOF_SHA256[spec.session],
                 f"{tag} the inner proof is not the session's")
        shapes = []
        for name, n, w, pre_w, perm_w in spec.chips:
            lde_rows = n << DEFAULT_CONFIG.log_blowup
            shapes += [(name, what, lde_rows, cols) for what, cols in (
                ("trace", w), ("preprocessed", pre_w), ("perm", perm_w),
                ("quotient", 4 * DEFAULT_CONFIG.blowup)) if cols]
        hold_k1_at(tag, shapes, covered)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        timings = {}
        k1.reset_launches()
        p2.plain_calls = 0
        t0 = time.perf_counter()
        blob = StarkGuestProver().compress(journal, proof, timings=timings)
        torch.cuda.synchronize(dev)
        compress_s = time.perf_counter() - t0
        launches, plain = dict(k1.launches), p2.plain_calls
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        for entry in ("hash_rows", "merkle_levels"):
            _require(launches[entry] > 0,
                     f"{tag} compress launched {entry} no time")
        _require(plain == 0, f"{tag} compress ran the plain Poseidon2")
        obj = cbor.loads(blob)
        vk = RecursionVK.from_bytes(obj["vk"])
        outer = MachineProof.from_bytes(obj["proof"])
        got = {c.name: 1 << c.log_n for c in outer.chips}
        _require(vk.n_instrs == spec.instrs,
                 f"{tag} the program has {vk.n_instrs} instructions")
        _require(got == {name: n for name, n, *_ in spec.chips},
                 f"{tag} the outer chips are {got}")
        digest = hashlib.sha256(blob).hexdigest()
        _require(digest == COMPRESS_1303_SHA256,
                 f"{tag} the blob's digest is {digest}")
        compress_blobs["compress_1303"] = (journal, blob)
        print(f"{tag} StarkGuestProver.compress {compress_s:.2f} s: "
              f"{vk.n_instrs} instructions, {vk.n_pubs} public inputs, outer "
              f"chips {got}")
        print(f"{tag} build_program {timings['build_program']:.2f} s")
        print(f"{tag} outer_chips (vm_trace, sponge_trace) "
              f"{timings['outer_chips']:.2f} s")
        print(f"{tag} outer prove_machine "
              f"{sum(timings[k] for k in STAGES):.2f} s: " + ", ".join(
                  f"{k} {timings[k]:.3f}" for k in STAGES))
        print(f"{tag} peak device memory {peak:.2f} GiB; blob {len(blob)} "
              f"bytes, sha256 {digest}; K1 launches {launches}, total "
              f"{sum(launches.values())}, plain calls {plain}")
        cache = Path(__file__).resolve().parent / "build" / (
            f"vk-cache-{os.getpid()}")
        shutil.rmtree(cache, ignore_errors=True)
        try:
            for label in ("cold", "cached"):
                t0 = time.perf_counter()
                _require(StarkGuestProver().verify_compressed(
                    journal, blob, cache_dir=str(cache)),
                    f"{tag} verify_compressed ({label}) rejected the blob")
                print(f"{tag} verify_compressed ({label} vk cache) "
                      f"{time.perf_counter() - t0:.2f} s ok")
            entries = list(cache.glob("rvk-*.bin"))
            _require(len(entries) == 1, f"{tag} the vk cache holds {entries}")
            trusted = RecursionVK.from_bytes(entries[0].read_bytes())
            _require(trusted.program_root == vk.program_root,
                     f"{tag} the verifier derived another program root")
            bad, pos = _tamper_filtered(journal)
            t0 = time.perf_counter()
            try:
                StarkGuestProver().verify_compressed(bad, blob,
                                                     cache_dir=str(cache))
            except VerificationError as e:
                print(f"{tag} the verifier's own program root == the blob's; "
                      f"journal with filtered byte {pos} changed rejected in "
                      f"{time.perf_counter() - t0:.2f} s ({e}); total "
                      f"{time.perf_counter() - t_start:.1f} s")
            else:
                raise RuntimeError(f"{tag} the blob verified against a "
                                   "tampered journal")
        finally:
            shutil.rmtree(cache, ignore_errors=True)
        return launches

    def shrink_path(covered: set) -> dict:
        """Phase 11: the tiny chain's shrink against the JAX package's
        bytes, then the shrink of the 0x1303 compress blob at full width;
        returns the K1 launches of the full-width shrink."""
        tag = "shrink fib:"
        cfg = StarkConfig(**FIB_CHAIN_CONFIG)
        t0 = time.perf_counter()
        _, vk_a, proof_a = fib_chain(dev)
        a_binding, a_msgs, pre_roots = shrink_statement(
            vk_a, FIB_CHAIN_BINDING, [])
        vk_b, proof_b = recursion_prove_bn(
            outer_airs(), proof_a, a_binding, a_msgs, cfg, cfg,
            inner_preprocessed_roots=pre_roots, device=dev)
        blob = proof_b.to_bytes()
        digest = hashlib.sha256(blob).hexdigest()
        print(f"{tag} Fibonacci(5) proved, compressed and shrunk on the card "
              f"{time.perf_counter() - t0:.2f} s: {vk_b.n_instrs} "
              "instructions, outer chips " + ", ".join(
                  f"{c.name} {1 << c.log_n}" for c in proof_b.chips)
              + f"; proof {len(blob)} bytes, sha256 {digest}")
        _require(digest == SHRINK_PROOF_SHA256,
                 f"{tag} the card's shrink proof differs from the JAX "
                 "package's digest")
        _require(recursion_verify_bn(vk_b, MachineProofBN.from_bytes(blob),
                                     a_binding, a_msgs, cfg),
                 f"{tag} recursion_verify_bn rejected the proof")
        print(f"{tag} proof == the JAX package's digest; recursion_verify_bn "
              "ok")

        # the full-width shrink of the 0x1303 compress blob
        spec = SHRINKS["shrink_1303"]
        tag = "shrink 1303:"
        if spec.compress not in compress_blobs:
            launches_by_path["compress"] = compress_path(covered)
        journal, cblob = compress_blobs[spec.compress]
        _require(hashlib.sha256(cblob).hexdigest() == COMPRESS_1303_SHA256,
                 f"{tag} the compress blob is not 0x1303's")
        obj = cbor.loads(cblob)
        vk_a = RecursionVK.from_bytes(obj["vk"])
        outer_a = MachineProof.from_bytes(obj["proof"])
        msgs = journal_public_messages(journal)
        a_binding, a_msgs, pre_roots = shrink_statement(vk_a, journal, msgs)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        timings: dict = {}
        k1.reset_launches()
        p2.plain_calls = 0
        t0 = time.perf_counter()
        vk_b, proof_b = recursion_prove_bn(
            outer_airs(), outer_a, a_binding, a_msgs, DEFAULT_CONFIG,
            DEFAULT_CONFIG, inner_preprocessed_roots=pre_roots,
            timings=timings, device=dev)
        torch.cuda.synchronize(dev)
        shrink_s = time.perf_counter() - t0
        launches, plain = dict(k1.launches), p2.plain_calls
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        blob = proof_b.to_bytes()
        digest = hashlib.sha256(blob).hexdigest()
        got = {c.name: 1 << c.log_n for c in proof_b.chips}
        print(f"{tag} recursion_prove_bn {shrink_s:.2f} s: "
              f"{vk_b.n_instrs} instructions, {vk_b.n_pubs} public inputs, "
              f"outer chips {got}")
        print(f"{tag} build_program {timings['build_program']:.2f} s")
        print(f"{tag} outer_chips (vm_trace, sponge_trace) "
              f"{timings['outer_chips']:.2f} s")
        print(f"{tag} outer prove_machine_bn {timings['prove_bn_s']:.2f} s: "
              + ", ".join(f"{k} {timings[k]:.3f}" for k in STAGES))
        print(f"{tag} host MiMC (mimc_s, inside the prove) "
              f"{timings['mimc_s']:.2f} s on {native.mimc_threads()} threads "
              f"of {os.cpu_count()} cores, vector path "
              f"{'on' if vector_on else 'off'}")
        print(f"{tag} peak device memory {peak:.2f} GiB; proof {len(blob)} "
              f"bytes, sha256 {digest}; K1 launches {launches}, plain calls "
              f"{plain}")
        _require(vk_b.n_instrs == spec.instrs,
                 f"{tag} the program has {vk_b.n_instrs} instructions")
        _require(got == {name: n for name, n, *_ in spec.chips},
                 f"{tag} the outer chips are {got}")
        _require(sum(launches.values()) == 0 and plain == 0,
                 f"{tag} the shrink hashed with Poseidon2 on the card")
        vk2 = RecursionVKBN.from_bytes(vk_b.to_bytes())
        t0 = time.perf_counter()
        _require(recursion_verify_bn(vk2, MachineProofBN.from_bytes(blob),
                                     a_binding, a_msgs, DEFAULT_CONFIG),
                 f"{tag} recursion_verify_bn rejected the proof")
        print(f"{tag} recursion_verify_bn (proof and vk through bytes) "
              f"{time.perf_counter() - t0:.2f} s ok")
        bad_journal, pos = _tamper_filtered(journal)
        bad_binding, bad_msgs, _ = shrink_statement(
            vk_a, bad_journal, journal_public_messages(bad_journal))
        bad_vk = dataclasses.replace(vk2, program_root=vk2.program_root ^ 1)
        bad_proof = MachineProofBN.from_bytes(blob)
        bad_proof.queries[0].openings[0].trace_row[0] ^= 1
        for what, args in (
                (f"journal with filtered byte {pos} changed",
                 (vk2, MachineProofBN.from_bytes(blob), bad_binding,
                  bad_msgs)),
                ("vk with a changed program root",
                 (bad_vk, MachineProofBN.from_bytes(blob), a_binding,
                  a_msgs)),
                ("proof with one changed opened value",
                 (vk2, bad_proof, a_binding, a_msgs))):
            t0 = time.perf_counter()
            try:
                recursion_verify_bn(*args, DEFAULT_CONFIG)
            except VerificationError as e:
                print(f"{tag} {what} rejected in "
                      f"{time.perf_counter() - t0:.2f} s ({e})")
            else:
                raise RuntimeError(f"{tag} the proof verified with a {what}")
        print(f"{tag} total {time.perf_counter() - t_start:.1f} s")
        return launches

    def hold_msm() -> None:
        """Phase 12a: the host MSM library against the plain version."""
        t0 = time.perf_counter()
        lib_path, _ = native.build_msm()
        build_s = time.perf_counter() - t0
        sizes = {"g1": 1024, "g2": 256, "g1_base": 128, "g2_base": 64}
        points = {"g1": [bn254.G1], "g2": [bn254.G2]}
        add = {"g1": bn254.g1_add, "g2": bn254.g2_add}
        for group, pts in points.items():
            while len(pts) < sizes[group]:      # G, 2G, 3G, ...
                pts.append(add[group](pts[-1], pts[0]))
        t0 = time.perf_counter()
        for group, msm in (("g1", bn254.msm_g1), ("g2", bn254.msm_g2),
                           ("g1_base", bn254.g1_base_mul_batch),
                           ("g2_base", bn254.g2_base_mul_batch)):
            n = sizes[group]
            scalars = [int.from_bytes(host_rng.bytes(32), "little")
                       for _ in range(n)]
            scalars[0], scalars[1] = 0, bn254.R - 1
            args = (scalars,) if group.endswith("base") else (
                points[group], scalars)
            _require(msm(*args) == msm(*args, native=False),
                     f"the C {group} MSM != plain at {n}")
        print(f"snark wrap_bn: build bn254_msm_host.c (-fopenmp) "
              f"{build_s:.2f} s -> {lib_path.name}; C == pure-Python plain: "
              f"msm_g1 at {sizes['g1']} points, msm_g2 at {sizes['g2']}, "
              f"g1_base_mul_batch at {sizes['g1_base']} scalars, "
              f"g2_base_mul_batch at {sizes['g2_base']} (0 and r - 1 among "
              f"the seeded scalars), {time.perf_counter() - t0:.2f} s")

    def snark_path(covered: set) -> dict:
        """Phase 12; returns the K1 launches of the 0x1303 session prove
        whose journal path b seals."""
        # a. the STARK-verifier circuit over a BN machine proof
        tag = "snark wrap_bn:"
        spec = SNARKS["wrap_bn"]
        chips, binding, cfg_kw = wrap_bn_machine()
        cfg = StarkConfig(**cfg_kw)
        k1.reset_launches()
        p2.plain_calls = 0
        t0 = time.perf_counter()
        proof = prove_machine_bn(chips, binding, cfg, device=dev)
        torch.cuda.synchronize(dev)
        prove_s = time.perf_counter() - t0
        blob = proof.to_bytes()
        digest = hashlib.sha256(blob).hexdigest()
        _require(digest == spec.digests["proof"],
                 f"{tag} the card's BN proof differs from the JAX package's")
        _require(verify_machine_bn([FibonacciAir()],
                                   MachineProofBN.from_bytes(blob), binding,
                                   config=cfg),
                 f"{tag} verify_machine_bn rejected the proof")
        t0 = time.perf_counter()
        cs = build_stark_wrap_circuit([FibonacciAir()], proof, binding, [],
                                      cfg, {})
        circuit_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        _require(cs.check(), f"{tag} the circuit is not satisfied")
        check_s = time.perf_counter() - t0
        counts = (len(cs.constraints), cs.n_vars)
        _require(counts == (spec.constraints, spec.variables),
                 f"{tag} the circuit has {counts}")
        digests = r1cs_digests(cs)
        for key in ("assignment", "constraints"):
            _require(digests[key] == spec.digests[key],
                     f"{tag} the circuit's {key} differ from the JAX "
                     "package's")
        del cs
        print(f"{tag} Fibonacci(5) BN machine ({cfg_kw}) proved on the card "
              f"{prove_s:.2f} s: {len(blob)} bytes, sha256 {digest} == the "
              "JAX package's; verify_machine_bn ok")
        print(f"{tag} build_stark_wrap_circuit {circuit_s:.2f} s, "
              f"cs.check() {check_s:.2f} s: {counts[0]} constraints, "
              f"{counts[1]} variables; assignment sha256 "
              f"{digests['assignment']}, constraints sha256 "
              f"{digests['constraints']} == the JAX package's")
        hold_msm()
        launches = {"a": (dict(k1.launches), p2.plain_calls)}

        # b. the journal seals of two sessions' card proofs, one CRS
        sealed = {"1303": "journal_1303", "c02f": "journal_c02f"}
        for name in sealed:
            if name not in session_proofs:
                launches_by_path[name] = session_path(name, covered)
            _require(hashlib.sha256(session_proofs[name][1]).hexdigest()
                     == SESSION_PROOF_SHA256[name],
                     f"snark: the {name} proof is not the session's")
        k1.reset_launches()
        p2.plain_calls = 0
        t0 = time.perf_counter()
        keys = wrap.wrap_setup()
        setup_s = time.perf_counter() - t0
        vk = keys.vk()
        bundled = json.loads((Path(wrap.__file__).parent
                              / "wrap_vk.json").read_text())
        _require(bundled["circuit"] == wrap.wrap_circuit_params()
                 and all(json.loads(json.dumps(vk[k])) == bundled[k]
                         for k in ("alpha1", "beta2", "gamma2", "delta2",
                                   "ic")),
                 "snark: wrap_setup().vk() differs from wrap_vk.json")
        print(f"snark journal: wrap_setup {setup_s:.2f} s; its vk == the "
              "bundled snark/wrap_vk.json")
        for name, label in sealed.items():
            tag = f"snark {label}:"
            spec = SNARKS[label]
            journal = session_proofs[name][0]
            cs = wrap.build_wrap_circuit(journal)
            counts = (len(cs.constraints), cs.n_vars)
            _require(counts == (spec.constraints, spec.variables),
                     f"{tag} the circuit has {counts}")
            digests = r1cs_digests(cs)
            for key in ("assignment", "constraints"):
                _require(digests[key] == spec.digests[key],
                         f"{tag} the circuit's {key} differ from the JAX "
                         "package's")
            t0 = time.perf_counter()
            digest, seal = wrap.wrap_prove(keys, journal)
            prove_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            _require(wrap.wrap_verify(vk, digest, seal),
                     f"{tag} wrap_verify rejected the seal")
            verify_s = time.perf_counter() - t0
            _require(simulate_zktls_verify(vk, journal, seal),
                     f"{tag} simulate_zktls_verify rejected the seal")
            bad, pos = _tamper_filtered(journal)
            _require(not wrap.wrap_verify(vk, wrap.journal_digest_fr(bad),
                                          seal)
                     and not simulate_zktls_verify(vk, bad, seal),
                     f"{tag} the seal verified against a changed journal")
            _require(not wrap.wrap_verify(vk, digest + 1, seal),
                     f"{tag} the seal verified against the digest + 1")
            print(f"{tag} {len(journal)}-byte journal of the card proof, "
                  f"circuit {counts[0]} constraints, {counts[1]} variables "
                  f"(digests == the JAX package's); wrap_prove "
                  f"{prove_s:.2f} s, seal {len(seal)} bytes; wrap_verify "
                  f"{verify_s:.2f} s and simulate_zktls_verify accept; "
                  f"filtered byte {pos} changed and digest + 1 rejected")
        out = Path(__file__).resolve().parent / "build" / (
            f"verifier-evm-{os.getpid()}")
        try:
            files = export_verifier("evm", out)
            got = {f.name: hashlib.sha256(f.read_bytes()).hexdigest()
                   for f in files}
        finally:
            shutil.rmtree(out, ignore_errors=True)
        _require(got == EXPORT_SHA256,
                 f"snark: the exported files differ from the JAX package's "
                 f"({got})")
        launches["b"] = (dict(k1.launches), p2.plain_calls)
        _require(all(sum(got.values()) == 0 and plain == 0
                     for got, plain in launches.values()),
                 f"snark: the BN machine, circuits or Groth16 hashed with "
                 f"Poseidon2 ({launches})")
        print(f"snark: export_verifier('evm') files {sorted(got)} == the "
              f"JAX package's; K1 launches and plain calls in paths a and b "
              f"{launches}; total {time.perf_counter() - t_start:.1f} s")
        return launches_by_path["1303"]

    def service_path() -> dict:
        """Phase 13: live recordings with the port's recorder, then the
        prover service on the card through RemoteGuestProver; returns the
        K1 launches of the remote proves."""
        from urllib.error import HTTPError
        from urllib.request import Request as UrlRequest, urlopen

        tag = "service:"
        live = {}
        for suite, ref in ((0x1303, "1303"), (0xC02F, "c02f")):
            t0 = time.perf_counter()
            gi = record_loopback(suite)
            rec_s = time.perf_counter() - t0
            out = run_guest(gi, require_trust_anchor=False)
            _require(out.replay.cipher_suite.id == suite,
                     f"{tag} the recording negotiated "
                     f"0x{out.replay.cipher_suite.id:04X}")
            _require(len(out.journal) == SESSIONS[ref].journal_bytes,
                     f"{tag} the 0x{suite:04X} journal is "
                     f"{len(out.journal)} bytes")
            live[suite] = (gi, out)
            print(f"{tag} recorded 0x{suite:04X} live on the loopback "
                  f"(TLSInputBuilder, committed test certificate) in "
                  f"{rec_s:.2f} s: tape {len(gi.response.stream)} bytes, "
                  f"random {len(gi.response.random)} bytes; run_guest "
                  f"journal {len(out.journal)} bytes")
        committed = GuestInput.from_cbor(
            SESSIONS["1303"].guest_input.read_bytes())
        live_gi, live_out = live[0x1303]
        store = roots.anchor_spki_hashes() | {
            bytes.fromhex(SESSIONS["1303"].chain["root_spki_sha256"]),
            bytes.fromhex(live_out.chain["root_spki_sha256"])}
        svc = serve("stark", "127.0.0.1", 0).start()
        try:
            remote = RemoteGuestProver(svc.url)
            health = remote.health()
            _require(health == {"status": "ok",
                                "prover": "StarkGuestProver"},
                     f"{tag} health {health}")
            with mock.patch.object(roots, "anchor_spki_hashes",
                                   lambda: store):
                want = run_guest(committed).journal
                k1.reset_launches()
                p2.plain_calls = 0
                t0 = time.perf_counter()
                journal, blob = remote.prove(committed)
                remote_s = time.perf_counter() - t0
                launches = dict(k1.launches)
                _require(journal == want, f"{tag} the remote journal is "
                         "not the local replay's")
                digest = hashlib.sha256(blob).hexdigest()
                _require(digest == SESSION_PROOF_SHA256["1303"],
                         f"{tag} the remote proof is not the session's")
                t0 = time.perf_counter()
                _require(StarkGuestProver().prove(committed)[1] == blob,
                         f"{tag} the local prove gave other bytes")
                local_s = time.perf_counter() - t0
                k1.reset_launches()
                t0 = time.perf_counter()
                live_journal, live_blob = remote.prove(live_gi)
                live_s = time.perf_counter() - t0
                live_launches = dict(k1.launches)
                _require(live_journal == live_out.journal,
                         f"{tag} the live session's remote journal differs")
                _require(StarkGuestProver().verify(live_journal, live_blob),
                         f"{tag} the live session's proof was rejected")
                bad, pos = _tamper_filtered(live_journal)
                try:
                    StarkGuestProver().verify(bad, live_blob)
                except VerificationError as e:
                    rejected = str(e)
                else:
                    raise RuntimeError(f"{tag} the live proof verified "
                                       "against a tampered journal")
            body = committed.to_cbor()
            try:
                urlopen(UrlRequest(f"{svc.url}/v1/prove",
                                   data=body[: len(body) // 2],
                                   method="POST"), timeout=60)
            except HTTPError as e:
                status = e.code
            else:
                status = 200
            _require(status == 400, f"{tag} a truncated body got {status}")
        finally:
            svc.stop()
        for name, got in (("committed", launches), ("live", live_launches)):
            for entry in ("hash_rows", "merkle_levels"):
                _require(got[entry] > 0, f"{tag} the {name} remote prove "
                         f"launched {entry} no time")
        _require(p2.plain_calls == 0, f"{tag} a prove ran the plain Poseidon2")
        print(f"{tag} serve(\"stark\") at {svc.url}: health "
              f"{health}; remote prove of the committed 0x1303 session "
              f"{remote_s:.2f} s (local {local_s:.2f} s), journal == the "
              f"local replay's, proof sha256 {digest} == the session's; K1 "
              f"launches {launches}")
        print(f"{tag} remote prove of the live 0x1303 recording "
              f"{live_s:.2f} s, {len(live_blob)} bytes, K1 launches "
              f"{live_launches}; StarkGuestProver.verify accepts; filtered "
              f"byte {pos} changed rejected ({rejected}); a truncated "
              f"GuestInput body got {status}; total "
              f"{time.perf_counter() - t_start:.1f} s")
        return launches

    def paths_path() -> dict:
        """Phase 14: the four-step NTT against radix-2, and the single-AIR
        prove/verify; returns the K1 launches of the Fibonacci prove."""
        tag = "paths:"
        for log_n in (23, 25):
            x = rand_field(1 << log_n, 8)
            got = {}
            for label, fn in (("radix-2", ntt_mod._ntt_radix2),
                              ("four-step", ntt_mod._ntt_four_step)):
                args = (x, False) if fn is ntt_mod._ntt_radix2 else (
                    x, log_n, False)
                torch.cuda.synchronize(dev)
                torch.cuda.reset_peak_memory_stats(dev)
                base_mem = torch.cuda.memory_allocated(dev)
                y = fn(*args)
                torch.cuda.synchronize(dev)
                peak = (torch.cuda.max_memory_allocated(dev) - base_mem) / 2**30
                ms = _time_ms(lambda: fn(*args), reps=1, runs=3)
                got[label] = (y, ms, peak)
                del y
            _require(torch.equal(got["radix-2"][0], got["four-step"][0]),
                     f"{tag} four-step != radix-2 at 2^{log_n}")
            _require(torch.equal(ntt_mod.ntt(x), got["four-step"][0]),
                     f"{tag} ntt at 2^{log_n} is not the four-step's")
            _require(torch.equal(ntt_mod.intt(got["four-step"][0]), x),
                     f"{tag} intt did not invert at 2^{log_n}")
            print(f"{tag} ntt (2^{log_n}, 8): four-step (ntt's path from "
                  f"2^{ntt_mod._FOUR_STEP_LOG}) == radix-2, intt inverts; "
                  f"radix-2 {got['radix-2'][1]:.2f} ms, "
                  f"{got['radix-2'][2]:.2f} GiB above the input; four-step "
                  f"{got['four-step'][1]:.2f} ms, "
                  f"{got['four-step'][2]:.2f} GiB")
            del got, x

        launches = None
        for name, log_n in (("fib", 16), ("bytes", 15)):
            cfg = StarkConfig(**SINGLES[name][0])
            air, trace, publics = single_air(name, log_n)
            k1.reset_launches()
            p2.plain_calls = 0
            t0 = time.perf_counter()
            card = prove_single(air, trace, publics, cfg, device=dev)
            card_s = time.perf_counter() - t0
            got = dict(k1.launches)
            _require(p2.plain_calls == 0,
                     f"{tag} the {name} prove ran the plain Poseidon2")
            launches = launches or got
            blob = card.to_bytes()
            t0 = time.perf_counter()
            _require(prove_single(air, trace, publics, cfg,
                                  device="cpu").to_bytes() == blob,
                     f"{tag} {name} single-AIR proof: card != CPU")
            cpu_s = time.perf_counter() - t0
            _require(verify_single(air, StarkProof.from_bytes(blob), cfg),
                     f"{tag} verify rejected the {name} proof")
            bad = StarkProof.from_bytes(blob)
            bad.queries[0].trace_row[0] = (bad.queries[0].trace_row[0] + 1) \
                % bb.P
            try:
                verify_single(air, bad, cfg)
            except VerificationError as e:
                rejected = str(e)
            else:
                raise RuntimeError(f"{tag} a tampered {name} opening "
                                   "verified")
            ref_air, ref_trace, ref_publics = single_air(name)
            _require(prove_single(ref_air, ref_trace, ref_publics, cfg,
                                  device=dev).to_bytes()
                     == SINGLES[name][1].read_bytes(),
                     f"{tag} the small {name} proof is not the JAX bytes")
            print(f"{tag} single-AIR {air.name} {trace.shape[0]}x"
                  f"{trace.shape[1]} ({SINGLES[name][0]}) card prove "
                  f"{card_s:.2f} s == the CPU's bytes ({cpu_s:.2f} s), "
                  f"{len(blob)} bytes, K1 launches {got}; verify accepts, a "
                  f"changed opening rejected ({rejected}); at "
                  f"{ref_trace.shape[0]} rows == the committed JAX bytes")
        for entry in ("hash_rows", "merkle_levels"):
            _require(launches[entry] > 0, f"{tag} the Fibonacci prove "
                     f"launched {entry} no time")
        print(f"{tag} total {time.perf_counter() - t_start:.1f} s")
        return launches

    def parallel_path() -> dict:
        """Phase 15: several devices in one process — the sharded NTT and
        LDE, the 0x1303 session proved over the mesh's devices, the
        segment step; returns the K1 launches of the multi-device
        prove."""
        tag = "parallel:"
        t_path = time.perf_counter()
        n_cards = torch.cuda.device_count()
        # every card; one card serves as two logical shards
        mesh = (make_mesh() if n_cards > 1 else make_mesh(1, 2, [dev, dev]))
        devices = list(mesh.devices.flat)
        print(f"{tag} mesh {mesh.shape} over {[str(d) for d in devices]} "
              + ("(every card)" if n_cards > 1 else
                 "(the one card as two logical shards)"))

        def sync_all():
            for d in set(devices):
                torch.cuda.synchronize(d)

        if n_cards > 1:
            # a K1 launch on another card leaves torch's current device
            other = devices[-1]
            torch.cuda.set_device(dev)
            mk.hash_rows(rand_field(1024, 16).to(other))
            torch.cuda.synchronize(other)
            _require(torch.cuda.current_device() == dev.index,
                     f"{tag} a K1 launch on {other} moved the current "
                     f"device to {torch.cuda.current_device()}")
            print(f"{tag} K1 on {other}: torch's current device stays "
                  f"{dev}")

        # (a) the sharded four-step NTT and LDE against the local ones
        t0 = time.perf_counter()
        x = rand_field(1 << 23)
        sharded = make_ntt_sharded(mesh)
        for inverse, local in ((False, ntt_mod.ntt), (True, ntt_mod.intt)):
            _require(torch.equal(sharded(x, inverse=inverse), local(x)),
                     f"{tag} ntt_sharded(inverse={inverse}) at 2^23 != "
                     f"{local.__name__}")
            ms = _time_ms(lambda: sharded(x, inverse=inverse), reps=1,
                          runs=3)
            local_ms = _time_ms(lambda: local(x), reps=1, runs=3)
            print(f"{tag} ntt_sharded(inverse={inverse}) at 2^23 == "
                  f"{local.__name__}: {ms:.2f} ms against {local_ms:.2f} ms "
                  "on one device")
        chips, journal = session_chips.get("1303") or session_machine("1303")
        widest = max(chips, key=lambda c: c.trace.shape)
        vals = rand_field(*widest.trace.shape)
        lde_sharded = make_coset_lde_sharded(mesh)
        args = (vals, DEFAULT_CONFIG.log_blowup, DEFAULT_CONFIG.shift)
        _require(torch.equal(lde_sharded(*args), ntt_mod.coset_lde(*args)),
                 f"{tag} make_coset_lde_sharded != coset_lde")
        ms = _time_ms(lambda: lde_sharded(*args), reps=1, runs=3)
        local_ms = _time_ms(lambda: ntt_mod.coset_lde(*args), reps=1,
                            runs=3)
        print(f"{tag} make_coset_lde_sharded at {widest.air.name}'s "
              f"{tuple(vals.shape)} (0x1303's largest chip) == coset_lde: "
              f"{ms:.2f} ms against {local_ms:.2f} ms on one device; "
              f"(a) {time.perf_counter() - t0:.1f} s")
        del x, vals

        # (b) the 0x1303 session proved over the mesh's devices, beside a
        # one-device prove of the same chips
        t0 = time.perf_counter()
        runs = {}
        for label, kw in (("one device", {"device": dev}),
                          ("the mesh's devices",
                           {"devices": devices, "mesh": mesh})):
            for d in set(devices):
                torch.cuda.reset_peak_memory_stats(d)
            timings: dict = {}
            k1.reset_launches()
            p2.plain_calls = 0
            t1 = time.perf_counter()
            blob = prove_machine(chips, journal, DEFAULT_CONFIG,
                                 timings=timings, **kw).to_bytes()
            sync_all()
            runs[label] = (time.perf_counter() - t1, timings, blob,
                           dict(k1.launches), p2.plain_calls,
                           max(torch.cuda.max_memory_allocated(d)
                               for d in set(devices)) / 2**30)
        for label, (prove_s, timings, blob, got, plain, peak) in \
                runs.items():
            _require(plain == 0, f"{tag} the {label} prove ran the plain "
                     "Poseidon2")
            _require(hashlib.sha256(blob).hexdigest()
                     == SESSION_PROOF_SHA256["1303"],
                     f"{tag} the {label} proof is not the session's")
            print(f"{tag} 0x1303 prove_machine on {label}: {prove_s:.2f} s ("
                  + ", ".join(f"{k} {timings[k]:.3f}" for k in STAGES)
                  + f"), peak device memory {peak:.2f} GiB, K1 launches "
                  f"{got}; sha256 == SESSION_PROOF_SHA256['1303']")
        launches = runs["the mesh's devices"][3]
        for entry in ("hash_rows", "merkle_levels"):
            _require(launches[entry] > 0, f"{tag} the multi-device prove "
                     f"launched {entry} no time")
        blob = runs["the mesh's devices"][2]
        _require(StarkGuestProver().verify(journal, blob),
                 f"{tag} StarkGuestProver rejected the proof")
        bad, pos = _tamper_filtered(journal)
        try:
            StarkGuestProver().verify(bad, blob)
        except VerificationError as e:
            print(f"{tag} verify ok; journal with filtered byte {pos} "
                  f"changed rejected ({e}); (b) "
                  f"{time.perf_counter() - t0:.1f} s")
        else:
            raise RuntimeError(f"{tag} the proof verified against a "
                               "tampered journal")

        # (c) the segment step of the reference's dryrun_multichip: one
        # LDE and leaf hash per segment on its seg device
        t0 = time.perf_counter()
        seg_devs = mesh.axis_devices("seg")
        n_segs = 2 * len(seg_devs)
        segs = [rand_field(1 << 15, 639) for _ in range(n_segs)]
        leaves = [mk.hash_rows(ntt_mod.coset_lde(
            t.to(seg_devs[i * len(seg_devs) // n_segs]), 1, 31))
            for i, t in enumerate(segs)]
        sync_all()
        for t, got in zip(segs, leaves):
            _require(torch.equal(got.to(dev),
                                 mk.hash_rows(ntt_mod.coset_lde(t, 1, 31))),
                     f"{tag} a segment's leaves differ from one device's")
        print(f"{tag} {n_segs} segments of (32768, 639) over "
              f"{[str(d) for d in seg_devs]}: LDE + hash_rows leaves == "
              f"one device's; (c) {time.perf_counter() - t0:.1f} s; total "
              f"{time.perf_counter() - t_path:.1f} s")
        return launches

    launches_by_path = {}
    if "sha" in paths:
        launches_by_path.update(sha_path())
    covered = {(4096, 639), (n_main, w_main), (131072, 16)}
    if "sessions" in paths:
        # 6.-7. each committed session: replayed from its GuestInput, its
        # chips built and K1 held against plain at their shapes, then the
        # main path StarkGuestProver.prove on the card
        for name in ("c02f", "1302", "1303"):
            launches_by_path[name] = session_path(name, covered)
    if "preprocessed" in paths:
        preprocessed_path()
    # 9. the batches
    for name, tamper in (("c02f_x2", 1), ("c02f_x8", 4)):
        if name in paths:
            launches_by_path[name] = batch_path(name, covered, tamper)
    # 10. the compress rung
    if "compress" in paths:
        launches_by_path["compress"] = compress_path(covered)
    # 11. the shrink rung, the slice's full-width path
    if "shrink" in paths:
        launches_by_path["shrink"] = shrink_path(covered)
    # 12. the Groth16 layer
    if "snark" in paths:
        launches_by_path["snark"] = snark_path(covered)
    # 13. the prover service and the live recorder
    if "service" in paths:
        launches_by_path["service"] = service_path()
    # 14. the prover's alternative device paths
    if "paths" in paths:
        launches_by_path["paths"] = paths_path()
    # 15. several devices
    if "parallel" in paths:
        launches_by_path["parallel"] = parallel_path()
    if args.only is not None:
        print(f"--only {','.join(paths)}: done in "
              f"{time.perf_counter() - t_start:.1f} s")
        return 0
    launches = {"permute": launches_by_path["grinding"]["permute"],
                **{k: launches_by_path["compress"][k]
                   for k in ("hash_rows", "merkle_levels")}}

    # 16. kernels (launches: the compress's; permute: the grinding path's)
    print(json.dumps({"kernels": [{
        "name": f"poseidon2_{name}",
        "route": "cuda",
        "source": "zktls_tpu_torch/csrc/poseidon2.cu",
        "replaces": "zktls_tpu/ops/pallas_poseidon2.py:107",
        "launches": launches[name],
        "launches_by_path": {path: got[name]
                             for path, got in launches_by_path.items()
                             if name in got},
        "max_abs_err": errs[name],
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": b["bound_s"] * 1e3,
        "bound_by": b["bound_by"],
        "library_ms": None,
    } for name, (_, ms, plain_ms, b) in timed.items()]}))
    # 17. result
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
