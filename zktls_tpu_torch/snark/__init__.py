"""SNARK side of the zktls_tpu_torch port: the BN254 curve and pairing
(bn254.py), R1CS and Groth16 (r1cs.py, groth16.py), the journal wrap and
the MP-MiMC hash the shrink layer commits with (wrap.py), and the
STARK-verifier circuit that wraps a shrink-layer proof (stark_wrap.py).

Port of zktls_tpu.snark: host Python with a C MSM (utils/native.py), as
in the reference; nothing here runs on the card."""
