"""setup_s: seconds from the process's start to the window's start: the
imports, the recordings and the warm-up prove."""


def read(ctx):
    return ctx.setup_s
