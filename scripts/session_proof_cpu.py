"""Prove the recorded session's twelve-chip machine with the PyTorch port on
the CPU, and check the proof with both packages' verifiers.

    JAX_PLATFORMS=cpu python scripts/session_proof_cpu.py [--threads 8]

Replays `zktls_tpu_torch/data/session_c02f_p256.guest_input.cbor` with the
port's `run_guest` and builds its chips
(`zktls_tpu_torch.workload.session_machine`), proves them with
`prove_machine(chips, binding=journal, device="cpu")` at DEFAULT_CONFIG,
writes the proof to `build/session_c02f_p256.cpu.proof`, prints its SHA-256
(the digest `chip_smoke.py` holds the card's proof to), and verifies it
with the port's `StarkGuestProver(device="cpu").verify` and with the JAX
package's.
"""

from __future__ import annotations

import argparse
import hashlib
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
OUT = ROOT / "build" / "session_c02f_p256.cpu.proof"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--threads", type=int, default=8,
                    help="torch CPU threads (default 8)")
    args = ap.parse_args()

    import torch

    from zktls_tpu_torch.provers.stark import StarkGuestProver
    from zktls_tpu_torch.stark.config import DEFAULT_CONFIG
    from zktls_tpu_torch.stark.machine import STAGES, prove_machine
    from zktls_tpu_torch.workload import session_machine

    torch.set_num_threads(args.threads)
    t0 = time.perf_counter()
    chips, journal = session_machine()
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
    OUT.parent.mkdir(exist_ok=True)
    OUT.write_bytes(blob)
    print(f"proof {len(blob)} bytes, sha256 {hashlib.sha256(blob).hexdigest()}"
          f" -> {OUT.relative_to(ROOT)}")

    t0 = time.perf_counter()
    # raises VerificationError
    StarkGuestProver(device="cpu").verify(journal, blob)
    print(f"port StarkGuestProver.verify: ok ({time.perf_counter() - t0:.1f}"
          " s)")
    from zktls_tpu.provers.stark import StarkGuestProver as JaxProver

    t0 = time.perf_counter()
    JaxProver().verify(journal, blob)  # raises VerificationError
    print(f"JAX package StarkGuestProver.verify: ok "
          f"({time.perf_counter() - t0:.1f} s)")


if __name__ == "__main__":
    main()
