"""SNARK side of the zktls_tpu_torch port: so far only the MP-MiMC hash
over the BN254 scalar field (`wrap.mimc_hash`) that the shrink layer
commits with (stark/commit_bn.py).  The Groth16 wrap itself (the
reference's zktls_tpu.snark: curve arithmetic, R1CS, Groth16, the
verifier circuit) is not ported yet."""
