"""Prove a recorded session's machine (or a batch of sessions) with the
PyTorch port on the CPU, and check the proof with both packages' verifiers.

    JAX_PLATFORMS=cpu python scripts/session_proof_cpu.py [--session 1302]
    JAX_PLATFORMS=cpu python scripts/session_proof_cpu.py --batch c02f_x2
    JAX_PLATFORMS=cpu python scripts/session_proof_cpu.py --compress sha
    JAX_PLATFORMS=cpu python scripts/session_proof_cpu.py --compress fib \
        [--reference]
    JAX_PLATFORMS=cpu python scripts/session_proof_cpu.py --shrink fib|sha
    JAX_PLATFORMS=cpu python scripts/session_proof_cpu.py --machine sha|bn \
        [--reference]
    JAX_PLATFORMS=cpu python scripts/session_proof_cpu.py --snark bn|journal \
        [--reference]

Replays the session's committed GuestInput (`--session`: c02f, the
default, 1302 or 1303; `zktls_tpu_torch.workload.SESSIONS`) with the
port's `run_guest` and builds its chips
(`zktls_tpu_torch.workload.session_machine`), proves them with
`prove_machine(chips, binding=journal, device="cpu")` at DEFAULT_CONFIG,
writes the proof to `build/session_<session>.cpu.proof` (or `--out`),
prints its SHA-256 (the digest `chip_smoke.py` holds the card's proof to),
and verifies it with the port's `StarkGuestProver(device="cpu").verify`
and with the JAX package's (unless `--no-reference`), printing each
verifier's outcome; it exits non-zero when the two disagree or reject a
session proof.  Prints the
process's peak resident memory (11–15 GiB for 1302, 8.4 GiB for 1303).
`--batch NAME` (`zktls_tpu_torch.workload.BATCHES`) proves the batch's
merged chips (`workload.batch_machine`) bound to the concatenated journals
instead, writes `build/batch_<batch>.cpu.proof`, and checks it with both
packages' `StarkGuestProver.verify_batch`.  Both reject a batch proof at
StreamParserAir's constraint identity: the reference's AIR admits no trace
of a second session's parser region (tests/test_torch_batch.py).
`--compress sha` proves the 256-row Sha256Air machine of chip_smoke.py
(`zktls_tpu_torch.workload.sha_compress_machine`) and compresses it with
the port's `recursion_prove` on the CPU, inner and outer at DEFAULT_CONFIG,
writes the outer proof to `build/compress_sha.cpu.proof` and prints its
SHA-256 (chip_smoke.py's COMPRESS_PROOF_SHA256), then checks it with the
port's `recursion_verify` against the vk and with the JAX package's
`recursion_verify` from the bare shape (it rebuilds the program and
derives the vk root itself, which must equal the port's).
`--compress fib` compresses the Fibonacci inner of
tests/test_torch_recursion.py with the port and requires its vk and outer
proof bytes to equal the JAX package's, committed in
`zktls_tpu_torch/data/fib_compress.jax.cbor`
(`workload.FIB_COMPRESS_REFERENCE`, which that test reads instead of
compressing with JAX itself); `--reference` also compresses it with the
JAX package again (~4 min of XLA compiles), writes those bytes to
`build/compress_fib.jax.cbor` (or `--out`) and requires them to equal the
committed file.
`--machine sha` proves the 256-row Sha256Air machine of
tests/test_torch_machine.py (`workload.SHA_MACHINE_*`) with the port and
requires its bytes to equal the JAX package's committed proof
(`zktls_tpu_torch/data/sha256_machine.jax.proof`, which that test reads
instead of proving with JAX itself); `--reference` also proves it with the
JAX package again (~3 min of XLA compiles), writes those bytes to
`build/machine_sha.jax.proof` (or `--out`) and requires them to equal the
committed file; it also evaluates the JAX package's constraint-VM
quotient of that chip as tests/test_torch_machine.py does
(`workload.sha_quotient_inputs`) and requires it to equal the committed
`zktls_tpu_torch/data/sha256_quotient.jax.npy` (written to
`build/sha256_quotient.jax.npy`).
`--machine bn` does the same for the BN-committed proof
(`prove_machine_bn`) of the preprocessed machine of
tests/test_torch_shrink.py (`workload.BN_MACHINE_*`,
`zktls_tpu_torch/data/bn_machine.jax.proof`, `build/machine_bn.jax.proof`).
`--shrink fib` proves the tiny chain of tests/test_shrink_bn.py
(Fibonacci(5), compress, shrink; `workload.fib_chain`) with the port on
the CPU and, unless `--no-reference`, with the JAX package, prints both
shrink proofs' SHA-256 (chip_smoke.py's SHRINK_PROOF_SHA256) and requires
them equal; it also writes the JAX package's compress and shrink vks to
`build/fib_chain_vks.jax.cbor` and requires them equal to the committed
`zktls_tpu_torch/data/fib_chain_vks.jax.cbor`
(`workload.FIB_CHAIN_VKS_REFERENCE`, which tests/test_torch_wrap.py
reads).  `--shrink sha` compresses the 256-row Sha256Air machine as
`--compress sha` does and shrinks that compress proof at DEFAULT_CONFIG
(VmAir 2^20 rows), printing the stage seconds, the peak resident memory,
the proof's SHA-256 and the JAX package's `recursion_verify_bn` verdict.
The MiMC library runs on `--threads` threads too.
`--snark bn` runs the `wrap_bn` Groth16 path of `workload.SNARKS` with the
port on the CPU: the Fibonacci(5) BN machine proof (its bytes must equal
the committed JAX proof, `zktls_tpu_torch/data/fib_wrap_bn.jax.proof`),
`build_stark_wrap_circuit` over it (its constraint and variable counts and
`r1cs_digests`), then Groth16 `setup` at `WRAP_BN_SEED`, `prove` at
`WRAP_BN_RANDOMNESS` and `verify` (accept the statement digest, reject it
^ 1), printing each step's seconds and every digest and requiring each to
equal the committed one (~7 min); `--reference` runs the same steps in the
JAX package, writes its BN proof to `build/fib_wrap_bn.jax.proof` (or
`--out`) and requires both packages' bytes and digests equal (~7 min more).
`--snark journal` seals the journals of the c02f and 0x1303 sessions
(`journal_c02f`, `journal_1303`) with the port: `wrap_setup()` (its vk
must equal the bundled `snark/wrap_vk.json`), each journal's circuit
(counts and digests), `wrap_prove`, `wrap_verify` and
`simulate_zktls_verify` (accept; reject a changed filtered byte and the
digest + 1), and `export_verifier("evm")` (file digests, `EXPORT_SHA256`);
`--reference` also holds the JAX package's `wrap_setup().vk()`, circuits
and exported files to the port's and lets its `wrap_verify` and
`simulate_zktls_verify` judge the port's seals.
`--single fib|bytes` proves the single-AIR proof of `workload.SINGLES`
(the Fibonacci AIR of tests/test_stark.py; a byte-range LogUp table with
grinding) with `stark.prover.prove` on the CPU and requires it to equal the JAX
package's committed bytes (`zktls_tpu_torch/data/fib_single.jax.proof`,
`bytes_single.jax.proof`, which tests/test_torch_paths.py reads);
`--reference` also proves it with the JAX package again (~1 min of XLA
compiles), writes those bytes to `build/single_<name>.jax.proof` (or
`--out`) and requires them to equal the committed file.
`--no-reference --out PROOF` proves on a host without the JAX package, such
as the card machine's, and keeps the proof where the caller wants it.
"""

from __future__ import annotations

import argparse
import hashlib
import pathlib
import resource
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
BUILD = ROOT / "build"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--session", default="c02f",
                    choices=("c02f", "1302", "1303"),
                    help="the committed session to prove (default c02f)")
    ap.add_argument("--batch", choices=("c02f_x2", "c02f_x8"),
                    help="prove this batch of committed sessions instead")
    ap.add_argument("--compress", choices=("sha", "fib"),
                    help="compress this machine's proof instead")
    ap.add_argument("--shrink", choices=("fib", "sha"),
                    help="shrink this chain's compress proof instead")
    ap.add_argument("--machine", choices=("sha", "bn"),
                    help="prove tests/test_torch_machine.py's (sha) or "
                         "tests/test_torch_shrink.py's (bn) machine "
                         "against its committed JAX proof instead")
    ap.add_argument("--single", choices=("fib", "bytes"),
                    help="prove this single-AIR proof against its committed "
                         "JAX bytes instead")
    ap.add_argument("--snark", choices=("bn", "journal"),
                    help="run this Groth16 path of workload.SNARKS instead")
    ap.add_argument("--reference", action="store_true",
                    help="--compress fib, --machine, --single, --snark: "
                         "make the JAX "
                         "package's bytes again and hold them to the "
                         "committed file")
    ap.add_argument("--threads", type=int, default=8,
                    help="torch CPU threads (default 8)")
    ap.add_argument("--out", type=pathlib.Path,
                    help="where to write the proof (default "
                         "build/session_<session>.cpu.proof)")
    ap.add_argument("--no-reference", action="store_true",
                    help="skip the JAX package's verifier (on a machine "
                         "without JAX)")
    args = ap.parse_args()
    what = (f"batch_{args.batch}" if args.batch
            else f"compress_{args.compress}" if args.compress
            else f"shrink_{args.shrink}" if args.shrink
            else f"session_{args.session}")
    out = args.out or BUILD / f"{what}.cpu.proof"

    import torch

    from zktls_tpu_torch.provers.stark import StarkGuestProver
    from zktls_tpu_torch.stark.config import DEFAULT_CONFIG
    from zktls_tpu_torch.stark.machine import STAGES, prove_machine
    from zktls_tpu_torch.workload import batch_machine, session_machine

    from zktls_tpu_torch.utils import native

    torch.set_num_threads(args.threads)
    native.set_mimc_threads(args.threads)
    if args.compress == "fib":
        compress_fib(args)
        return
    if args.machine:
        (machine_sha if args.machine == "sha" else machine_bn)(args)
        return
    if args.single:
        single(args)
        return
    if args.snark:
        (snark_bn if args.snark == "bn" else snark_journal)(args)
        return
    if args.compress:
        compress_sha(args, out)
        return
    if args.shrink:
        (shrink_fib if args.shrink == "fib" else shrink_sha)(args, out)
        return
    t0 = time.perf_counter()
    if args.batch:
        chips, journals = batch_machine(args.batch)
        journal = b"".join(journals)
    else:
        chips, journal = session_machine(args.session)
    print(f"run_guest + build_chip_instances "
          f"{time.perf_counter() - t0:.2f} s: "
          + ", ".join(f"{c.air.name} {c.trace.shape[0]}x{c.trace.shape[1]}"
                      for c in chips))
    timings: dict = {}
    t0 = time.perf_counter()
    blob = prove_machine(chips, binding=journal, config=DEFAULT_CONFIG,
                         device="cpu", timings=timings).to_bytes()
    print(f"prove (cpu, {args.threads} threads) "
          f"{time.perf_counter() - t0:.1f} s; stages "
          + ", ".join(f"{k} {timings[k]:.1f}" for k in STAGES))
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_bytes(blob)
    print(f"proof {len(blob)} bytes, sha256 {hashlib.sha256(blob).hexdigest()}"
          f" -> {out}")

    def check(prover, label) -> str:
        """The verifier's outcome: "ok", or the reason it rejected."""
        t0 = time.perf_counter()
        try:
            if args.batch:
                prover.verify_batch(journals, blob)
            else:
                prover.verify(journal, blob)
            outcome = "ok"
        except Exception as exc:  # each package's VerificationError
            if type(exc).__name__ != "VerificationError":
                raise
            outcome = f"rejected: {exc}"
        print(f"{label}.{'verify_batch' if args.batch else 'verify'}: "
              f"{outcome} ({time.perf_counter() - t0:.1f} s)")
        return outcome

    outcomes = [check(StarkGuestProver(device="cpu"), "port StarkGuestProver")]
    if not args.no_reference:
        from zktls_tpu.provers.stark import StarkGuestProver as JaxProver

        outcomes.append(check(JaxProver(), "JAX package StarkGuestProver"))
    print(f"peak resident memory "
          f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.2f}"
          " GiB")
    if len(set(outcomes)) != 1:
        sys.exit("the two packages' verifiers disagree")
    if not args.batch and outcomes[0] != "ok":
        sys.exit("the session proof was rejected")


def _peak_rss() -> str:
    return (f"peak resident memory "
            f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.2f}"
            " GiB")


def compress_sha(args, out: pathlib.Path) -> None:
    """`--compress sha`: the mid-scale compress and both verdicts."""
    from zktls_tpu_torch.stark.chips.sha256 import Sha256Air
    from zktls_tpu_torch.stark.config import DEFAULT_CONFIG
    from zktls_tpu_torch.stark.machine import STAGES, prove_machine
    from zktls_tpu_torch.stark.recursion import (
        recursion_prove,
        recursion_verify,
    )
    from zktls_tpu_torch.workload import sha_compress_machine

    t_all = time.perf_counter()
    inst, msgs, binding = sha_compress_machine()
    inner = prove_machine([inst], binding, DEFAULT_CONFIG, device="cpu")
    print(f"inner: Sha256Air {inst.trace.shape[0]}x{inst.trace.shape[1]} "
          f"proof {len(inner.to_bytes())} bytes, sha256 "
          f"{hashlib.sha256(inner.to_bytes()).hexdigest()}")
    timings: dict = {}
    t0 = time.perf_counter()
    vk, outer = recursion_prove([Sha256Air()], inner, binding, msgs,
                                DEFAULT_CONFIG, DEFAULT_CONFIG,
                                timings=timings, device="cpu")
    blob = outer.to_bytes()
    print(f"recursion_prove (cpu, {args.threads} threads) "
          f"{time.perf_counter() - t0:.1f} s: " + ", ".join(
              f"{k} {timings[k]:.1f}" for k in
              ("build_program", "outer_chips", *STAGES)))
    print(f"program {vk.n_instrs} instructions, {vk.n_pubs} public inputs; "
          "outer chips " + ", ".join(f"{c.name} 2^{c.log_n}"
                                     for c in outer.chips)
          + f"; vk root {list(vk.program_root)}")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_bytes(blob)
    print(f"outer proof {len(blob)} bytes, sha256 "
          f"{hashlib.sha256(blob).hexdigest()} -> {out}")
    t0 = time.perf_counter()
    recursion_verify([Sha256Air()], vk, outer, binding, msgs,
                     DEFAULT_CONFIG, DEFAULT_CONFIG)
    print(f"port recursion_verify (vk): ok "
          f"({time.perf_counter() - t0:.1f} s)")
    if not args.no_reference:
        from zktls_tpu.stark.chips.sha256 import Sha256Air as JSha256Air
        from zktls_tpu.stark.machine import MachineProof as JMachineProof
        from zktls_tpu.stark.recursion import MachineShape as JShape
        from zktls_tpu.stark.recursion import recursion_verify as jverify
        from zktls_tpu.stark.recursion import recursion_vk as jvk

        jouter = JMachineProof.from_bytes(blob)
        shape = JShape.from_bytes(vk.shape.to_bytes())
        t0 = time.perf_counter()
        ref_vk = jvk([JSha256Air()], shape, binding, msgs)
        if tuple(ref_vk.program_root) != tuple(vk.program_root):
            sys.exit("the JAX package derives another vk root")
        jverify([JSha256Air()], ref_vk, jouter, binding, msgs)
        print(f"JAX package recursion_vk == the port's vk root; "
              f"recursion_verify: ok ({time.perf_counter() - t0:.1f} s)")
    print(f"total {time.perf_counter() - t_all:.1f} s; {_peak_rss()}")


def compress_fib(args) -> None:
    """`--compress fib [--reference]` (module docstring)."""
    from zktls_tpu_torch.core import cbor
    from zktls_tpu_torch.models.fibonacci import FibonacciAir, \
        fibonacci_trace
    from zktls_tpu_torch.stark.config import StarkConfig
    from zktls_tpu_torch.stark.machine import ChipInstance, prove_machine
    from zktls_tpu_torch.stark.recursion import recursion_prove
    from zktls_tpu_torch.workload import (
        FIB_COMPRESS_BINDING,
        FIB_COMPRESS_CONFIG,
        FIB_COMPRESS_REFERENCE,
    )

    cfg = StarkConfig(**FIB_COMPRESS_CONFIG)
    trace, pub = fibonacci_trace(5)
    inner = prove_machine(
        [ChipInstance(air=FibonacciAir(), trace=trace, publics=pub)],
        binding=FIB_COMPRESS_BINDING, config=cfg, device="cpu")
    t0 = time.perf_counter()
    vk, outer = recursion_prove([FibonacciAir()], inner,
                                FIB_COMPRESS_BINDING, inner_config=cfg,
                                outer_config=cfg, device="cpu")
    mine = cbor.dumps({"vk": vk.to_bytes(), "proof": outer.to_bytes()})
    print(f"port recursion_prove {time.perf_counter() - t0:.1f} s")

    def reference() -> bytes:
        from zktls_tpu.models.fibonacci import FibonacciAir as JFibonacciAir
        from zktls_tpu.stark.config import StarkConfig as JStarkConfig
        from zktls_tpu.stark.machine import MachineProof as JMachineProof
        from zktls_tpu.stark.recursion import recursion_prove as jprove

        jcfg = JStarkConfig(**FIB_COMPRESS_CONFIG)
        jvk, jouter = jprove([JFibonacciAir()],
                             JMachineProof.from_bytes(inner.to_bytes()),
                             FIB_COMPRESS_BINDING, inner_config=jcfg,
                             outer_config=jcfg)
        return cbor.dumps({"vk": jvk.to_bytes(), "proof": jouter.to_bytes()})

    _hold_to_committed(mine, FIB_COMPRESS_REFERENCE, reference, args,
                       "compress_fib.jax.cbor")


def _hold_to_committed(mine: bytes, path: pathlib.Path, make_reference,
                       args, name: str) -> None:
    """Require the port's bytes to equal the committed JAX bytes at `path`;
    with --reference, make the JAX bytes again (`make_reference()`), write
    them to --out (default build/<name>) and require them equal too."""
    committed = path.read_bytes() if path.exists() else None
    print(f"port bytes sha256 {hashlib.sha256(mine).hexdigest()}; committed "
          f"{path.name}: " + (f"sha256 {hashlib.sha256(committed).hexdigest()}"
                              if committed is not None else "missing"))
    if args.reference:
        t0 = time.perf_counter()
        ref = make_reference()
        out = args.out or BUILD / name
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_bytes(ref)
        print(f"JAX package {time.perf_counter() - t0:.1f} s: sha256 "
              f"{hashlib.sha256(ref).hexdigest()} -> {out}")
        if ref != committed:
            sys.exit("the JAX package's bytes differ from the committed "
                     "file")
    if mine != committed:
        sys.exit("the port's bytes differ from the committed JAX bytes")
    print("port == committed JAX bytes" + (" == live JAX bytes"
                                           if args.reference else ""))


def single(args) -> None:
    """`--single fib|bytes [--reference]` (module docstring)."""
    from zktls_tpu_torch.stark.config import StarkConfig
    from zktls_tpu_torch.stark.prover import prove
    from zktls_tpu_torch.workload import SINGLES, single_air

    cfg, path = SINGLES[args.single]
    air, trace, publics = single_air(args.single)
    t0 = time.perf_counter()
    mine = prove(air, trace, publics, StarkConfig(**cfg),
                 device="cpu").to_bytes()
    print(f"port prove {time.perf_counter() - t0:.1f} s, "
          f"{len(mine)} bytes")

    def reference() -> bytes:
        from zktls_tpu.stark.chips.bytes_table import ByteRangeAir
        from zktls_tpu.models.fibonacci import FibonacciAir
        from zktls_tpu.stark.config import StarkConfig as JStarkConfig
        from zktls_tpu.stark.prover import prove as jprove

        jair = FibonacciAir() if args.single == "fib" else ByteRangeAir()
        return jprove(jair, trace, publics, JStarkConfig(**cfg)).to_bytes()

    _hold_to_committed(mine, path, reference, args,
                       f"single_{args.single}.jax.proof")


def machine_sha(args) -> None:
    """`--machine sha [--reference]` (module docstring)."""
    from zktls_tpu_torch.stark.config import StarkConfig
    from zktls_tpu_torch.stark.machine import prove_machine
    from zktls_tpu_torch.workload import (
        SHA_MACHINE_BINDING,
        SHA_MACHINE_CONFIG,
        SHA_MACHINE_REFERENCE,
        SHA_MACHINE_SEED,
        sha_machine,
    )

    inst, _ = sha_machine(2, 100, SHA_MACHINE_SEED)
    mine = prove_machine([inst], SHA_MACHINE_BINDING,
                         StarkConfig(**SHA_MACHINE_CONFIG),
                         device="cpu").to_bytes()

    def reference() -> bytes:
        from zktls_tpu.stark import machine as jmachine
        from zktls_tpu.stark.chips.sha256 import Sha256Air as JSha256Air
        from zktls_tpu.stark.config import StarkConfig as JStarkConfig

        jinst = jmachine.ChipInstance(air=JSha256Air(), trace=inst.trace,
                                      publics=inst.publics)
        return jmachine.prove_machine(
            [jinst], binding=SHA_MACHINE_BINDING,
            config=JStarkConfig(**SHA_MACHINE_CONFIG)).to_bytes()

    _hold_to_committed(mine, SHA_MACHINE_REFERENCE, reference, args,
                       "machine_sha.jax.proof")
    if args.reference:
        _sha_quotient_reference(inst.trace)


def _sha_quotient_reference(trace) -> None:
    """The JAX package's eval_quotient_vm of the Sha256Air chip at
    `workload.sha_quotient_inputs`, held to the committed values."""
    import jax.numpy as jnp
    import numpy as np

    from zktls_tpu.ops import babybear as jbb
    from zktls_tpu.ops import ntt as jntt
    from zktls_tpu.ops.field_ref import Fp4 as JFp4
    from zktls_tpu.stark.chips.sha256 import Sha256Air as JSha256Air
    from zktls_tpu.stark.config import selector_arrays as jsel
    from zktls_tpu.stark.lowering import eval_quotient_vm as jvm
    from zktls_tpu_torch.ops.field_ref import P
    from zktls_tpu_torch.stark.chips.sha256 import Sha256Air
    from zktls_tpu_torch.stark.lowering import lower_air
    from zktls_tpu_torch.workload import (
        SHA_QUOTIENT_REFERENCE,
        sha_quotient_inputs,
    )

    t0 = time.perf_counter()
    log_n, log_blowup, shift = 8, 2, 31
    coeffs, publics, apow = sha_quotient_inputs(
        lower_air(Sha256Air(), 4, 74).n_constraints)
    challenges = [JFp4(*c) for c in coeffs]
    perm = JSha256Air().generate_perm_trace(trace, [], challenges)

    def lde(x, s=shift):
        return jntt.coset_lde(jbb.to_mont(jnp.asarray(x)), log_blowup, s)

    periodic = np.stack([np.asarray(jnp.tile(
        lde(pat, pow(shift, (1 << log_n) // len(pat), P)),
        (1 << log_n) // len(pat))) for pat in JSha256Air().periodic_columns()])
    sels = jsel(log_n, log_blowup, shift)
    sel_keys = ("is_first_row", "is_last_row", "is_transition")
    want = np.asarray(jvm(
        JSha256Air(), lde(trace), lde(perm), challenges, publics, apow,
        {k: jbb.to_mont(jnp.asarray(sels[k])) for k in sel_keys},
        jbb.to_mont(jnp.asarray(sels["inv_z_h"])), jnp.asarray(periodic),
        log_blowup)).astype(np.uint32)
    out = BUILD / "sha256_quotient.jax.npy"
    out.parent.mkdir(parents=True, exist_ok=True)
    np.save(out, want)
    print(f"JAX package quotient {time.perf_counter() - t0:.1f} s: "
          f"{want.shape}, file sha256 "
          f"{hashlib.sha256(out.read_bytes()).hexdigest()} -> {out}")
    committed = (np.load(SHA_QUOTIENT_REFERENCE)
                 if SHA_QUOTIENT_REFERENCE.exists() else None)
    if committed is None or not np.array_equal(committed, want):
        sys.exit("the JAX package's quotient differs from the committed "
                 "file")
    print("JAX quotient == committed")


def machine_bn(args) -> None:
    """`--machine bn [--reference]` (module docstring)."""
    from zktls_tpu_torch.stark.config import StarkConfig
    from zktls_tpu_torch.stark.machine_bn import prove_machine_bn
    from zktls_tpu_torch.workload import (
        BN_MACHINE_BINDING,
        BN_MACHINE_CONFIG,
        BN_MACHINE_LOG_N,
        BN_MACHINE_REFERENCE,
        FixedMulAir,
        preprocessed_machine,
    )

    chips, _ = preprocessed_machine(BN_MACHINE_LOG_N)
    mine = prove_machine_bn(chips, BN_MACHINE_BINDING,
                            StarkConfig(**BN_MACHINE_CONFIG),
                            device="cpu").to_bytes()

    def reference() -> bytes:
        from zktls_tpu.models.fibonacci import FibonacciAir as JFibonacciAir
        from zktls_tpu.stark.air import Air as JAir
        from zktls_tpu.stark.config import StarkConfig as JStarkConfig
        from zktls_tpu.stark.machine import ChipInstance as JChipInstance
        from zktls_tpu.stark.machine_bn import prove_machine_bn as jprove

        class JFixedMulAir(JAir):
            """The JAX package's side of the port's FixedMulAir."""

            width = 2
            preprocessed_width = 2
            num_public = 0
            max_constraint_degree = 2
            name = "FixedMulAir"
            eval = FixedMulAir.eval

        jchips = [JChipInstance(air=a, trace=c.trace, publics=c.publics,
                                preprocessed=c.preprocessed)
                  for a, c in zip((JFixedMulAir(), JFibonacciAir()), chips)]
        return jprove(jchips, BN_MACHINE_BINDING,
                      JStarkConfig(**BN_MACHINE_CONFIG)).to_bytes()

    _hold_to_committed(mine, BN_MACHINE_REFERENCE, reference, args,
                       "machine_bn.jax.proof")


def _shrink(vk_a, outer_a, binding, msgs, cfg, label: str):
    """Shrink a compress proof with the port on the CPU; prints its stages
    and returns (vk, proof bytes, the statement's binding, messages)."""
    from zktls_tpu_torch.stark.machine import STAGES
    from zktls_tpu_torch.stark.recursion import outer_airs, \
        recursion_prove_bn
    from zktls_tpu_torch.workload import shrink_statement

    a_binding, a_msgs, roots = shrink_statement(vk_a, binding, msgs)
    timings: dict = {}
    t0 = time.perf_counter()
    vk_b, proof_b = recursion_prove_bn(
        outer_airs(), outer_a, a_binding, a_msgs, cfg, cfg,
        inner_preprocessed_roots=roots, timings=timings, device="cpu")
    blob = proof_b.to_bytes()
    print(f"{label}: port recursion_prove_bn {time.perf_counter() - t0:.1f} "
          "s: " + ", ".join(f"{k} {timings[k]:.1f}" for k in (
              "build_program", "outer_chips", *STAGES, "mimc_s")))
    print(f"{label}: program {vk_b.n_instrs} instructions; outer chips "
          + ", ".join(f"{c.name} 2^{c.log_n}" for c in proof_b.chips)
          + f"; proof {len(blob)} bytes, sha256 "
          f"{hashlib.sha256(blob).hexdigest()}")
    return vk_b, blob, a_binding, a_msgs


def shrink_fib(args, out: pathlib.Path) -> None:
    """`--shrink fib` (module docstring)."""
    from zktls_tpu_torch.stark.config import StarkConfig
    from zktls_tpu_torch.stark.machine_bn import MachineProofBN
    from zktls_tpu_torch.stark.recursion import recursion_verify_bn
    from zktls_tpu_torch.workload import (
        FIB_CHAIN_BINDING,
        FIB_CHAIN_CONFIG,
        fib_chain,
    )

    t_all = time.perf_counter()
    cfg = StarkConfig(**FIB_CHAIN_CONFIG)
    _, vk_a, proof_a = fib_chain("cpu")
    vk_b, blob, a_binding, a_msgs = _shrink(vk_a, proof_a, FIB_CHAIN_BINDING,
                                            [], cfg, "fib")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_bytes(blob)
    recursion_verify_bn(vk_b, MachineProofBN.from_bytes(blob), a_binding,
                        a_msgs, cfg)
    print("port recursion_verify_bn: ok")
    if not args.no_reference:
        from zktls_tpu.models.fibonacci import FibonacciAir as JFibonacciAir
        from zktls_tpu.models.fibonacci import fibonacci_trace as jtrace
        from zktls_tpu.stark import recursion as jrec
        from zktls_tpu.stark.config import StarkConfig as JStarkConfig
        from zktls_tpu.stark.machine import ChipInstance as JChipInstance
        from zktls_tpu.stark.machine import prove_machine as jprove_machine

        jcfg = JStarkConfig(**FIB_CHAIN_CONFIG)
        t0 = time.perf_counter()
        trace, pub = jtrace(5)
        jinner = jprove_machine(
            [JChipInstance(air=JFibonacciAir(), trace=trace, publics=pub)],
            binding=FIB_CHAIN_BINDING, config=jcfg)
        jvk_a, jproof_a = jrec.recursion_prove(
            [JFibonacciAir()], jinner, FIB_CHAIN_BINDING, inner_config=jcfg,
            outer_config=jcfg)
        jb = FIB_CHAIN_BINDING + jvk_a.shape.to_bytes()
        jmsgs = jrec._session_messages(jvk_a.shape, FIB_CHAIN_BINDING, [])
        jvk_b, jproof_b = jrec.recursion_prove_bn(
            jrec.outer_airs(), jproof_a, jb, public_messages=jmsgs,
            inner_config=jcfg, outer_config=jcfg,
            inner_preprocessed_roots={"VmAir": list(jvk_a.program_root)})
        jblob = jproof_b.to_bytes()
        print(f"JAX package chain {time.perf_counter() - t0:.1f} s: shrink "
              f"proof {len(jblob)} bytes, sha256 "
              f"{hashlib.sha256(jblob).hexdigest()}")
        if jblob != blob or jvk_b.to_bytes() != vk_b.to_bytes():
            sys.exit("the two packages' shrink proofs or vks differ")
        print("port == JAX package (proof and vk bytes)")
        from zktls_tpu_torch.core import cbor
        from zktls_tpu_torch.workload import FIB_CHAIN_VKS_REFERENCE

        vks = cbor.dumps({"vk_a": jvk_a.to_bytes(),
                          "vk_b": jvk_b.to_bytes()})
        vks_out = BUILD / FIB_CHAIN_VKS_REFERENCE.name
        vks_out.write_bytes(vks)
        print(f"JAX package vks sha256 {hashlib.sha256(vks).hexdigest()} "
              f"-> {vks_out}")
        if (not FIB_CHAIN_VKS_REFERENCE.exists()
                or FIB_CHAIN_VKS_REFERENCE.read_bytes() != vks):
            sys.exit("the JAX package's vks differ from the committed "
                     "file")
        print("JAX package vks == committed")
    print(f"total {time.perf_counter() - t_all:.1f} s; {_peak_rss()}")


def shrink_sha(args, out: pathlib.Path) -> None:
    """`--shrink sha` (module docstring)."""
    from zktls_tpu_torch.stark.chips.sha256 import Sha256Air
    from zktls_tpu_torch.stark.config import DEFAULT_CONFIG
    from zktls_tpu_torch.stark.machine import prove_machine
    from zktls_tpu_torch.stark.recursion import recursion_prove
    from zktls_tpu_torch.workload import sha_compress_machine

    t_all = time.perf_counter()
    inst, msgs, binding = sha_compress_machine()
    inner = prove_machine([inst], binding, DEFAULT_CONFIG, device="cpu")
    t0 = time.perf_counter()
    vk_a, outer = recursion_prove([Sha256Air()], inner, binding, msgs,
                                  DEFAULT_CONFIG, DEFAULT_CONFIG,
                                  device="cpu")
    print(f"compress sha {time.perf_counter() - t0:.1f} s: outer proof "
          f"sha256 {hashlib.sha256(outer.to_bytes()).hexdigest()}")
    vk_b, blob, a_binding, a_msgs = _shrink(vk_a, outer, binding, msgs,
                                            DEFAULT_CONFIG, "shrink sha")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_bytes(blob)
    print(f"-> {out}; {_peak_rss()}")
    if not args.no_reference:
        from zktls_tpu.stark.machine_bn import MachineProofBN as JProofBN
        from zktls_tpu.stark.recursion import RecursionVKBN as JVKBN
        from zktls_tpu.stark.recursion import recursion_verify_bn as jverify

        t0 = time.perf_counter()
        try:
            jverify(JVKBN.from_bytes(vk_b.to_bytes()),
                    JProofBN.from_bytes(blob), a_binding, a_msgs)
            verdict = "ok"
        except Exception as exc:  # the JAX package's VerificationError
            if type(exc).__name__ != "VerificationError":
                raise
            verdict = f"rejected: {exc}"
        print(f"JAX package recursion_verify_bn: {verdict} "
              f"({time.perf_counter() - t0:.1f} s)")
        if verdict != "ok":
            sys.exit("the JAX package rejected the shrink proof")
    print(f"total {time.perf_counter() - t_all:.1f} s")


_MISMATCHED: list[str] = []


def _check_digest(label: str, got: str, want: str) -> None:
    """Print a digest beside the committed one; a mismatch is recorded
    (every digest is printed first) and `_exit_on_mismatch` fails."""
    ok = got == want
    print(f"{label}: sha256 {got} ({'==' if ok else '!='} committed)")
    if not ok:
        _MISMATCHED.append(label)


def _exit_on_mismatch() -> None:
    if _MISMATCHED:
        sys.exit(f"differ from the committed digests: {_MISMATCHED}")


def _wrap_bn_steps(pkg: str, blob: bytes | None = None) -> dict:
    """The `wrap_bn` path in one package ("zktls_tpu_torch" or
    "zktls_tpu"): the BN proof (proved unless `blob` is given), its
    circuit's counts and digests, Groth16 setup / prove / verify; prints
    each step's seconds and returns what the path gave."""
    import importlib

    from zktls_tpu_torch.workload import (
        WRAP_BN_RANDOMNESS,
        WRAP_BN_SEED,
        r1cs_digests,
        wrap_bn_machine,
    )

    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    cfg_cls = mod("stark.config").StarkConfig
    mbn = mod("stark.machine_bn")
    fib = mod("models.fibonacci").FibonacciAir
    chips, binding, cfg_kw = wrap_bn_machine()
    cfg = cfg_cls(**cfg_kw)
    out = {}
    t0 = time.perf_counter()
    if blob is None:
        kw = {"device": "cpu"} if pkg == "zktls_tpu_torch" else {}
        inst = mod("stark.machine").ChipInstance(
            air=fib(), trace=chips[0].trace, publics=chips[0].publics)
        blob = mbn.prove_machine_bn([inst], binding, cfg, **kw).to_bytes()
    proof = mbn.MachineProofBN.from_bytes(blob)
    out["proof_bytes"] = blob
    out["prove_s"] = time.perf_counter() - t0
    sw = mod("snark.stark_wrap")
    g16 = mod("snark.groth16")
    t0 = time.perf_counter()
    cs = sw.build_stark_wrap_circuit([fib()], proof, binding, [], cfg, {})
    out["circuit_s"] = time.perf_counter() - t0
    if not cs.check():
        sys.exit(f"{pkg}: the wrap_bn circuit is not satisfied")
    out["counts"] = (len(cs.constraints), cs.n_vars)
    out.update(r1cs_digests(cs))
    stmt = sw.statement_digest_fr(binding, [], {})
    t0 = time.perf_counter()
    keys = g16.setup(cs, seed=WRAP_BN_SEED)
    out["setup_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    g16_proof = g16.prove(keys, cs, randomness=WRAP_BN_RANDOMNESS)
    out["g16_prove_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["verify"] = (g16.verify(keys.vk(), [stmt], g16_proof),
                     g16.verify(keys.vk(), [stmt ^ 1], g16_proof))
    out["verify_s"] = time.perf_counter() - t0
    out["groth16_bytes"] = g16_proof.to_bytes()
    print(f"{pkg}: BN proof {out['prove_s']:.1f} s, circuit "
          f"{out['circuit_s']:.1f} s ({out['counts'][0]} constraints, "
          f"{out['counts'][1]} variables), setup {out['setup_s']:.1f} s, "
          f"prove {out['g16_prove_s']:.1f} s, verify {out['verify_s']:.1f} "
          f"s (statement: {out['verify'][0]}, statement ^ 1: "
          f"{out['verify'][1]}); {_peak_rss()}")
    return out


def snark_bn(args) -> None:
    """`--snark bn [--reference]` (module docstring)."""
    from zktls_tpu_torch.workload import SNARKS, WRAP_BN_REFERENCE

    spec = SNARKS["wrap_bn"]
    runs = {"port": _wrap_bn_steps("zktls_tpu_torch")}
    if args.reference:
        runs["JAX package"] = _wrap_bn_steps("zktls_tpu")
        out = args.out or BUILD / WRAP_BN_REFERENCE.name
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_bytes(runs["JAX package"]["proof_bytes"])
        print(f"JAX package BN proof -> {out}")
    for label, got in runs.items():
        if got["counts"] != (spec.constraints, spec.variables):
            sys.exit(f"{label}: the circuit has {got['counts']}")
        if got["verify"] != (True, False):
            sys.exit(f"{label}: Groth16 verify gave {got['verify']}")
        _check_digest(f"{label} BN proof",
                      hashlib.sha256(got["proof_bytes"]).hexdigest(),
                      spec.digests["proof"])
        for key in ("assignment", "constraints"):
            _check_digest(f"{label} circuit {key}", got[key],
                          spec.digests[key])
        _check_digest(f"{label} Groth16 proof",
                      hashlib.sha256(got["groth16_bytes"]).hexdigest(),
                      spec.digests["groth16"])
    _exit_on_mismatch()
    if WRAP_BN_REFERENCE.read_bytes() != runs["port"]["proof_bytes"]:
        sys.exit("the port's BN proof differs from the committed JAX bytes")
    print("port == committed JAX bytes and digests"
          + (" == live JAX package" if args.reference else ""))


def snark_journal(args) -> None:
    """`--snark journal [--reference]` (module docstring)."""
    import json
    import tempfile

    from zktls_tpu_torch.core.types import GuestInput
    from zktls_tpu_torch.guest.program import run_guest
    from zktls_tpu_torch.snark import wrap
    from zktls_tpu_torch.verifier_export import (
        export_verifier,
        simulate_zktls_verify,
    )
    from zktls_tpu_torch.workload import (
        EXPORT_SHA256,
        SESSIONS,
        SNARKS,
        r1cs_digests,
    )

    t0 = time.perf_counter()
    keys = wrap.wrap_setup()
    vk = keys.vk()
    print(f"port wrap_setup {time.perf_counter() - t0:.1f} s")
    bundled = json.loads((pathlib.Path(wrap.__file__).parent
                          / "wrap_vk.json").read_text())
    if bundled["circuit"] != wrap.wrap_circuit_params() or any(
            json.loads(json.dumps(vk[k])) != bundled[k]
            for k in ("alpha1", "beta2", "gamma2", "delta2", "ic")):
        sys.exit("the port's wrap_setup().vk() differs from wrap_vk.json")
    print("port wrap_setup().vk() == bundled wrap_vk.json")
    if args.reference:
        from zktls_tpu.snark import wrap as jwrap
        from zktls_tpu.verifier_export import (
            simulate_zktls_verify as jsimulate,
        )

        t0 = time.perf_counter()
        jvk = jwrap.wrap_setup().vk()
        print(f"JAX package wrap_setup {time.perf_counter() - t0:.1f} s")
        if jvk != vk:
            sys.exit("the JAX package's wrap_setup().vk() differs")
        print("JAX package wrap_setup().vk() == the port's")
    for name in ("1303", "c02f"):
        label = f"journal_{name}"
        spec = SNARKS[label]
        journal = run_guest(GuestInput.from_cbor(
            SESSIONS[name].guest_input.read_bytes()),
            require_trust_anchor=False).journal
        cs = wrap.build_wrap_circuit(journal)
        counts = (len(cs.constraints), cs.n_vars)
        if counts != (spec.constraints, spec.variables):
            sys.exit(f"{label}: the circuit has {counts}")
        digests = r1cs_digests(cs)
        if args.reference:
            jd = r1cs_digests(jwrap.build_wrap_circuit(journal))
            if jd != digests:
                sys.exit(f"{label}: the JAX package's circuit differs")
        for key in ("assignment", "constraints"):
            _check_digest(f"{label} circuit {key}", digests[key],
                          spec.digests[key])
        t0 = time.perf_counter()
        digest, seal = wrap.wrap_prove(keys, journal)
        prove_s = time.perf_counter() - t0
        bad = bytearray(journal)
        bad[-1] ^= 1
        verdicts = {
            "wrap_verify": wrap.wrap_verify(vk, digest, seal),
            "simulate_zktls_verify": simulate_zktls_verify(vk, journal, seal),
            "wrap_verify digest + 1": wrap.wrap_verify(vk, digest + 1, seal),
            "simulate_zktls_verify changed journal": simulate_zktls_verify(
                vk, bytes(bad), seal)}
        if args.reference:
            verdicts["JAX wrap_verify"] = jwrap.wrap_verify(vk, digest, seal)
            verdicts["JAX simulate_zktls_verify"] = jsimulate(vk, journal,
                                                              seal)
            verdicts["JAX simulate_zktls_verify changed journal"] = \
                jsimulate(vk, bytes(bad), seal)
        print(f"{label}: {len(journal)}-byte journal, wrap_prove "
              f"{prove_s:.1f} s, seal {len(seal)} bytes; {verdicts}")
        if [v for k, v in verdicts.items()] != [
                not ("+ 1" in k or "changed" in k) for k in verdicts]:
            sys.exit(f"{label}: a verdict is wrong")
    with tempfile.TemporaryDirectory() as tmp:
        files = export_verifier("evm", pathlib.Path(tmp) / "port")
        mine = {f.name: f.read_bytes() for f in files}
        for fname, data in mine.items():
            _check_digest(f"export {fname}",
                          hashlib.sha256(data).hexdigest(),
                          EXPORT_SHA256[fname])
        if args.reference:
            from zktls_tpu.verifier_export import export_verifier as jexport

            ref = {f.name: f.read_bytes()
                   for f in jexport("evm", pathlib.Path(tmp) / "jax")}
            if ref != mine:
                sys.exit("the JAX package's exported files differ")
            print("JAX package export_verifier files == the port's")
    _exit_on_mismatch()
    print(f"{_peak_rss()}")


if __name__ == "__main__":
    main()
