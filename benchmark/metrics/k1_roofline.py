"""k1_roofline: the least time the card could take for the traced
proves' Poseidon2 states (peaks.poseidon2_work over each proof's chip
shapes, peaks.least_seconds) over the device time of the kernels of K1's
entry points, in percent.  Nothing when no K1 kernel ran."""

from peaks import least_seconds
from devtrace import K1_KERNELS


def read(ctx):
    k1_ns = ctx.trace.device_ns(lambda n: any(k in n for k in K1_KERNELS))
    if not k1_ns or not ctx.works:
        return None
    least = sum(least_seconds(w, ctx.card) for w in ctx.works)
    return 100.0 * least / (k1_ns / 1e9)
