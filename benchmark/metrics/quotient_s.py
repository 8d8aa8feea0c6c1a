"""quotient_s: the mean seconds per traced prove of the constraint VM's quotient (stark/machine.py::prove_machine), as the
program's `timings["quotient"]` gives them (a stage of a traced prove
ends with a device synchronise)."""


def read(ctx):
    return ctx.stage_mean("quotient")
