"""prove_s: the window's wall seconds, from its start to the end of its
last prove, over the proves completed in it."""


def read(ctx):
    return ctx.window_s / ctx.completed if ctx.completed else None
