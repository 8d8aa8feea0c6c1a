"""aes256_sha512_build_s: host seconds per traced prove inside the
program's `zktls.build:Sha512Air` and `zktls.build:Aes256Air` spans
(provers/stark.py::build_chip_instances, models/aes128_chip.py::
aes_instances): the builders of the two chips only SHA-384 and AES-256
suites carry.  Nothing when the program opens neither span."""

SPANS = ("zktls.build:Sha512Air", "zktls.build:Aes256Air")


def read(ctx):
    ns = sum(e - s for s, e, n in ctx.trace.host if n in SPANS)
    return ns / 1e9 / ctx.traced if ns and ctx.traced else None
