"""constraint_vm_s: host seconds per traced prove inside the program's
`zktls.constraint_vm:<AirName>` spans (stark/machine.py::prove_machine,
around each chip's `eval_quotient_vm`): the constraint VM's part of
`quotient_s`, its launches and whatever waits on the card inside it.
Nothing when the program opens no such span."""


def read(ctx):
    ns = sum(e - s for s, e, n in ctx.trace.host
             if n.startswith("zktls.constraint_vm:"))
    return ns / 1e9 / ctx.traced if ns and ctx.traced else None
