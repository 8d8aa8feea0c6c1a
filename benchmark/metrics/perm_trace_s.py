"""perm_trace_s: host seconds per traced prove inside the program's
`zktls.perm_trace:<AirName>` spans (stark/machine.py::prove_machine, around
each chip's `air.generate_perm_trace`): the host part of `perm_commit_s`.
Nothing when the program opens no such span."""


def read(ctx):
    ns = sum(e - s for s, e, n in ctx.trace.host
             if n.startswith("zktls.perm_trace:"))
    return ns / 1e9 / ctx.traced if ns and ctx.traced else None
