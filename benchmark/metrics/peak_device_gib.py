"""peak_device_gib: torch.cuda.max_memory_allocated() over the window (the
peak statistics are reset at its start), in GiB."""


def read(ctx):
    return ctx.peak_bytes / 2**30 if ctx.completed else None
