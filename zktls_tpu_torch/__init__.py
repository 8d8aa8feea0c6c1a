"""zktls_tpu_torch — the PyTorch/CUDA port of zktls_tpu's machine STARK.

A second package beside zktls_tpu (the JAX reference, which it never
imports).  Module paths and names mirror the reference, so each piece has
an obvious counterpart:

  ops/       Baby-Bear field, quartic extension, Poseidon2 (plain torch
             version + the hand-written Hopper kernel in csrc/), Merkle
             trees, NTT/LDE
  core/      the data model (Request, GuestInput and their CBOR/JSON
             codecs), the CBOR codec the proof bytes rest on, the tapes
  stark/     config, challenger, AIR builders, LogUp bus helpers, the
             constraint-VM lowering, the single-AIR prover/verifier
             (`prover.prove`, `verifier.verify`, `proof.StarkProof`), the
             machine prover/verifier, the recursion rungs (`recursion.py`:
             compress and shrink) and the MiMC commitment scheme the
             machine prover runs under for the shrink (`machine_bn.py`,
             `commit_bn.py`)
  parallel/  several devices in one process: the ('seg', 'ntt') mesh
             (`mesh.make_mesh`) and the four-step NTT / coset LDE sharded
             over a mesh axis (`ntt.ntt_sharded`,
             `ntt.make_coset_lde_sharded`), used by
             `prove_machine(devices=, mesh=)`; `devices=["cpu"] * k` runs
             it on the CPU as k logical shards
  routez/    the RV32IM executor (ELF32 loader, interpreter with cycle and
             segment counts): host Python, no device
  snark/     the Groth16 layer: BN254 curve and pairing, R1CS, Groth16,
             the STARK-verifier and journal circuits, MP-MiMC
  utils/     the host Poseidon2 and MiMC in C (csrc/*_host.c), built at
             first use
  stark/chips/, models/
             the chip AIRs of a TLS 1.2 ECDHE(P-256)-RSA-AES128-GCM-SHA256
             session (SHA-256, AES-128, GHASH, GCM control and data, stream
             parser, xor table, Keccak, EC schedule, key schedule, ModMul)
             and their trace builders
  guest/     the guest program: TLS 1.2 / 1.3 replay of a recorded session
             (`program.run_guest`), certificate chains read by the port's
             own DER reader (`der.py`, `x509.py`, `roots.py`), the crypto
             it records, the journal codec
  host/      the live TLS recorder and input builder (`record_tls_call`,
             `TLSInputBuilder`)
  provers/   `stark.StarkGuestProver` (prove, verify, compress, wrap,
             batches), `stark.build_chip_instances`, `mock.MockProver`,
             `service` (the prover service over HTTP and its client)
  cli.py     `python -m zktls_tpu_torch.cli prove -i request.json
             [--fixture session.cbor] [--mock | --network --server URL]`,
             `serve`, `export-verifier`
  data/      the recorded sessions' GuestInputs, the loopback test
             certificate, the JAX package's reference proofs
  convert.py carries the reference's objects across (duck-typed), for the
             tests
  workload.py, profile_prove.py
             the machines chip_smoke.py drives (a seeded Sha256Air machine,
             the recorded session), and a device-time breakdown of a prove

`stark.machine.prove_machine`, `stark.prover.prove` and `StarkGuestProver`
run on the CUDA card unless the caller passes device="cpu"; without a card
and without an explicit CPU device they raise.  The verifiers are host
code.
"""
