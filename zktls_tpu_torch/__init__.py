"""zktls_tpu_torch — the PyTorch/CUDA port of zktls_tpu's machine STARK.

A second package beside zktls_tpu (the JAX reference, which it never
imports).  Module paths and names mirror the reference, so each piece has
an obvious counterpart:

  ops/       Baby-Bear field, quartic extension, Poseidon2 (plain torch
             version + the hand-written Hopper kernel in csrc/), Merkle
             trees, NTT/LDE
  core/      the CBOR codec the proof bytes rest on
  stark/     config, challenger, AIR builders, LogUp bus helpers, the
             constraint-VM lowering, prover/verifier helpers and the
             machine prover/verifier
  stark/chips/sha256.py, guest/crypto/sha256.py
             the SHA-256 compression chip and its event recorder
  convert.py carries chip instances and SHA-256 events across from the
             reference's objects (duck-typed)
  workload.py, profile_prove.py
             the seeded Sha256Air machine chip_smoke.py drives, and a
             device-time breakdown of its prove

`stark.machine.prove_machine` runs on the CUDA card unless the caller
passes device="cpu"; without a card and without an explicit CPU device it
raises.  `stark.machine.verify_machine` is host code.
"""
