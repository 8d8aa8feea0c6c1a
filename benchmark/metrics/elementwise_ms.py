"""elementwise_ms: device milliseconds per traced prove of torch's
elementwise kernels (every device activity that trace.KINDS puts in no
other kind: the int64 field arithmetic of ops/, the lowering and the
prover)."""

from devtrace import kind


def read(ctx):
    ns = ctx.trace.device_ns(lambda n: kind(n) == "elementwise")
    return ns / 1e6 / ctx.traced if ns and ctx.traced else None
