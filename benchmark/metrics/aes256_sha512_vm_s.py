"""aes256_sha512_vm_s: host seconds per traced prove inside the program's
`zktls.constraint_vm:Sha512Air` and `zktls.constraint_vm:Aes256Air` spans
(stark/machine.py::prove_machine, around each chip's `eval_quotient_vm`):
the two SHA-384/AES-256 chips' part of `constraint_vm_s`.  Nothing when
the program opens neither span."""

SPANS = ("zktls.constraint_vm:Sha512Air", "zktls.constraint_vm:Aes256Air")


def read(ctx):
    ns = sum(e - s for s, e, n in ctx.trace.host if n in SPANS)
    return ns / 1e9 / ctx.traced if ns and ctx.traced else None
