"""perm_commit_s: the mean seconds per traced prove of the host LogUp perm traces and their commit (stark/machine.py::prove_machine), as the
program's `timings["perm_commit"]` gives them (a stage of a traced prove
ends with a device synchronise)."""


def read(ctx):
    return ctx.stage_mean("perm_commit")
