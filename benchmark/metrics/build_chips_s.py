"""build_chips_s: the mean seconds per traced prove of chip builders (provers/stark.py::build_chip_instances), as the
program's `timings["build_chip_instances"]` gives them (a stage of a traced prove
ends with a device synchronise)."""


def read(ctx):
    return ctx.stage_mean("build_chip_instances")
