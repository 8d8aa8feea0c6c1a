"""run_guest_s: the mean seconds per traced prove of guest replay (guest/program.py::run_guest), as the
program's `timings["run_guest"]` gives them (a stage of a traced prove
ends with a device synchronise)."""


def read(ctx):
    return ctx.stage_mean("run_guest")
