"""aes256_sha512_perm_trace_s: host seconds per traced prove inside the
program's `zktls.perm_trace:Sha512Air` and `zktls.perm_trace:Aes256Air`
spans (stark/machine.py::prove_machine, around each chip's
`perm_trace_m`): the two SHA-384/AES-256 chips' part of `perm_trace_s`.
Nothing when the program opens neither span."""

SPANS = ("zktls.perm_trace:Sha512Air", "zktls.perm_trace:Aes256Air")


def read(ctx):
    ns = sum(e - s for s, e, n in ctx.trace.host if n in SPANS)
    return ns / 1e9 / ctx.traced if ns and ctx.traced else None
