"""encode_proof_s: host seconds per traced prove inside the program's
`zktls.encode_proof` span (provers/stark.py::StarkGuestProver.prove,
around `MachineProof.to_bytes`), after the last stage of `timings`.
Nothing when the program opens no such span."""


def read(ctx):
    ns = sum(e - s for s, e, n in ctx.trace.host
             if n == "zktls.encode_proof")
    return ns / 1e9 / ctx.traced if ns and ctx.traced else None
