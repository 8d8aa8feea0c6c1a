"""Route Z: the RV32IM executor, the port's copy of zktls_tpu.routez.

An ELF32 loader (`elf.load_elf`) and an RV32IM interpreter with cycle and
segment accounting (`executor.Machine`, `run_elf`), with the reference's
names and semantics: CSR instructions are no-ops, an ECALL with no
handler halts with a0 as the exit code, and a segment boundary is
recorded every `segment_cycles` cycles.  It is host code: pure Python,
no torch, no device.
"""

from .elf import load_elf  # noqa: F401
from .executor import SEGMENT_CYCLES, Halt, Machine, run_elf  # noqa: F401
