"""device_idle_pct: the share of the traced window (first prove's start to
last prove's end) in which no device activity ran, from the union of the
activities' intervals, in percent."""


def read(ctx):
    window = ctx.trace.window_ns
    return 100.0 * (1 - ctx.trace.busy_ns() / window) if window else None
