"""What the Poseidon2 kernels compile to, and what that costs to issue.

    python3 -m zktls_tpu_torch.sass_count

Builds csrc/poseidon2.cu, disassembles the library with `cuobjdump -sass`
and counts every kernel's machine operations by class.  The permute
kernels are straight-line code (one thread, one state, every round
unrolled), so their static count is the count per state; in the sponge
and tree kernels the rounds are loops and the static count is the code's
size.  Beside a permute kernel's counts: the time the card needs to issue
its integer-pipe operations for 131072 states at 64 per clock per SM, and
the multiply-only bound of `cuda_poseidon2.bound`.  The kernels' measured
times are chip_smoke.py's.  Prints one JSON line; needs one card (for its
SM count and clock), nvcc and cuobjdump.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path

import torch

from .ops import cuda_poseidon2 as k1

N_STATES = 131072

#: instruction classes by opcode (first match); everything in `INT_PIPE`
#: issues on the SM's 64-lane integer pipe
CLASSES = (
    ("mul_wide", re.compile(r"^IMAD\.WIDE")),
    ("mul_high", re.compile(r"^IMAD\.HI")),
    ("imad_move", re.compile(r"^IMAD\.(MOV|SHL|IADD)")),
    ("mul_low", re.compile(r"^IMAD")),
    ("add_min", re.compile(r"^VIADDMNMX")),
    ("min_max", re.compile(r"^VIMNMX|^IMNMX")),
    ("add", re.compile(r"^IADD3|^VIADD|^LEA")),
    ("compare_select", re.compile(r"^ISETP|^SEL|^PLOP3")),
    ("logic_shift_move", re.compile(r"^LOP3|^SHF|^MOV|^PRMT|^I2I|^CS2R|^S2R")),
    ("memory", re.compile(r"^LD|^ST|^ATOM|^RED")),
    ("uniform", re.compile(r"^U[A-Z]|^R2UR|^S2UR")),
    ("control", re.compile(r"^BRA|^EXIT|^BAR|^NOP|^BSSY|^BSYNC|^CALL|^RET|"
                           r"^WARPSYNC|^DEPBAR|^ERRBAR|^MEMBAR|^NANOSLEEP")),
)
INT_PIPE = ("mul_wide", "mul_high", "imad_move", "mul_low", "add_min",
            "min_max", "add", "compare_select", "logic_shift_move")

_INSTR = re.compile(r"^\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\d+\s+)?([A-Z0-9_.]+)")


def _tool(name: str) -> str:
    found = shutil.which(name)
    if found:
        return found
    default = Path("/usr/local/cuda/bin") / name
    if default.exists():
        return str(default)
    raise RuntimeError(f"{name} not found")


def count_sass(lib: Path) -> dict[str, dict[str, int]]:
    """Machine operations per class for every kernel of the library."""
    sass = subprocess.run([_tool("cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    out: dict[str, Counter] = {}
    cur = None
    for line in sass.splitlines():
        if "Function :" in line:
            cur = out.setdefault(line.split("Function :")[1].strip(),
                                 Counter())
            continue
        m = _INSTR.match(line)
        if cur is None or not m:
            continue
        op = m.group(1)
        kind = next((k for k, rx in CLASSES if rx.match(op)), "other:" + op)
        cur[kind] += 1
    return {name: dict(c) for name, c in out.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("sass_count: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card, clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().rsplit(",", 1)
    clock_mhz = float(clock.split()[0])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    path, report = k1.build()
    kernels = {}
    for name, counts in count_sass(path).items():
        int_pipe = sum(counts.get(k, 0) for k in INT_PIPE)
        entry = {"counts": counts, "total": sum(counts.values()),
                 "int_pipe": int_pipe}
        m = re.search(r"kernelILi(\d+)", name)  # a permute kernel
        if m:
            width = int(m.group(1))
            entry.update(
                width=width,
                int_pipe_issue_ms=int_pipe * N_STATES / (
                    k1.INT_MULS_PER_CLOCK_PER_SM * sms * clock_mhz * 1e3),
                multiply_bound_ms=k1.bound(
                    {width: N_STATES}, sms, clock_mhz)["bound_s"] * 1e3)
        kernels[name] = entry
    print(json.dumps({
        "card": card, "sms": sms, "clock_mhz": clock_mhz,
        "states": N_STATES,
        "ptxas": [ln.strip() for ln in report.splitlines()
                  if "registers" in ln or "Compiling" in ln],
        "kernels": kernels}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
