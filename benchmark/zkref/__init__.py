"""A frozen copy of the host modules of the PyTorch port that the benchmark
needs, kept here so that a later change to the port cannot change what the
benchmark sends or how it judges:

* the recording client (`host/recorder.py`, `host/input_builder.py`) that
  makes every session the benchmark proves;
* the guest replay (`guest/program.py::run_guest`), which says what journal
  a session must give;
* the machine verifier (`stark/machine.py::verify_machine`, the chip AIRs
  of `stark/chips/`, `stark/verifier.py`) and the host Poseidon2 in C
  (`utils/native.py`, `csrc/poseidon2_host.c`, built into
  `benchmark/build/native/` at first use), which judge every proof.

The files are the port's, with relative imports, as they stood when the
benchmark was defined.  Two changes: `host/recorder.py::record_tls_call`
and `host/input_builder.py::TLSInputBuilder` take `now`, the time the
recording pins (the wall clock when None), so that a seed fixes it.  The
port's device modules that these files import lazily (the Poseidon2 CUDA
kernel, the sharded NTT, the BN254 layer) are left out: the benchmark
calls nothing that needs them.
"""
