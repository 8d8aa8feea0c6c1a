"""Prove a recorded session's machine (or a batch of sessions) with the
PyTorch port on the CPU, and check the proof with both packages' verifiers.

    JAX_PLATFORMS=cpu python scripts/session_proof_cpu.py [--session 1302]
    JAX_PLATFORMS=cpu python scripts/session_proof_cpu.py --batch c02f_x2
    JAX_PLATFORMS=cpu python scripts/session_proof_cpu.py --compress sha

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
    ap.add_argument("--compress", choices=("sha",),
                    help="compress this machine's proof instead")
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
            else f"session_{args.session}")
    out = args.out or BUILD / f"{what}.cpu.proof"

    import torch

    from zktls_tpu_torch.provers.stark import StarkGuestProver
    from zktls_tpu_torch.stark.config import DEFAULT_CONFIG
    from zktls_tpu_torch.stark.machine import STAGES, prove_machine
    from zktls_tpu_torch.workload import batch_machine, session_machine

    torch.set_num_threads(args.threads)
    if args.compress:
        compress_sha(args, out)
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
              ("build_program", "outer_chips", *STAGES, "vk_from_prog")))
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


if __name__ == "__main__":
    main()
