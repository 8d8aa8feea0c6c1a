"""The port's RV32IM executor (zktls_tpu_torch.routez) against the JAX
package's (zktls_tpu.routez): the programs of tests/test_routez.py (its
own encoders and ELF wrapper), the paths those programs leave out (CSR,
FENCE, EBREAK, a syscall handler, the loader's refusals, a cycle limit)
and seeded random RV32I/M programs of ALU, immediate, load/store and
branch instructions.  Both executors must reach the same state: exit
code (or error), registers, pc, cycles, segment boundaries and memory
pages — at the end of each program, and after every instruction of the
random ones."""

import struct

import numpy as np
import pytest

from zktls_tpu import routez as jroutez
from zktls_tpu.routez import executor as jexecutor
from zktls_tpu_torch import routez as troutez
from zktls_tpu_torch.routez import executor as texecutor

from .test_routez import (
    ECALL,
    _wrap_elf,
    add,
    addi,
    b_type,
    bne,
    divu,
    i_type,
    lui,
    lw,
    mul,
    r_type,
    rem,
    s_type,
    sw,
)
from .torch_threads import torch_threads_per_worker  # noqa: F401

PACKAGES = (jroutez, troutez)
HALTS = (jexecutor.Halt, texecutor.Halt)


def _state(m) -> dict:
    return {"pc": m.pc, "regs": list(m.regs), "cycles": m.cycles,
            "segments": list(m.segments),
            "pages": {k: bytes(v) for k, v in m.pages.items()}}


def _words(words) -> bytes:
    return b"".join(struct.pack("<I", w & 0xFFFFFFFF) for w in words)


def _run_both(words, pc=0x1000, regs=None, max_cycles=1 << 20,
              **machine_kw) -> list:
    """(outcome, state) of each package's Machine on the program: the
    outcome is the exit code, or the error's type name and message."""
    out = []
    for pkg in PACKAGES:
        m = pkg.Machine(**machine_kw)
        m.store_bytes(pc, _words(words))
        m.pc = pc
        if regs is not None:
            m.regs[:] = regs
        try:
            outcome = m.run(max_cycles=max_cycles)
        except (ValueError, TimeoutError) as e:
            outcome = (type(e).__name__, str(e))
        out.append((outcome, _state(m)))
    return out


def _same(words, **kw):
    ref, got = _run_both(words, **kw)
    assert got == ref
    return got


# the programs of tests/test_routez.py
SUM_LOOP = [addi(5, 0, 100), addi(11, 0, 0), add(11, 11, 5),
            addi(5, 5, -1), bne(5, 0, -8), addi(10, 11, 0), ECALL]
MUL_DIV_REM = [addi(5, 0, -7), addi(6, 0, 3), mul(10, 5, 6),
               rem(11, 5, 6), divu(12, 5, 0), ECALL]
MEMORY = [lui(5, 0x10), addi(6, 0, 1234), sw(5, 6, 0), lw(10, 5, 0), ECALL]
CSR = [addi(10, 0, 7), i_type(0x73, 5, 2, 0, 0xC00), 0x0000000F, ECALL]
EBREAK = [addi(10, 0, 9), 0x00100073, addi(10, 0, 1), ECALL]
BAD_BRANCH = [b_type(2, 0, 0, 8), ECALL]
BAD_OPCODE = [0x0000007F]


@pytest.mark.parametrize("name,words,code", [
    ("sum_loop", SUM_LOOP, 5050),
    ("mul_div_rem", MUL_DIV_REM, (-21) & 0xFFFFFFFF),
    ("memory", MEMORY, 1234),
    ("csr_and_fence_are_no_ops", CSR, 7),
    ("ebreak_halts", EBREAK, 9),
    ("bad_branch", BAD_BRANCH, ("ValueError", "bad branch funct3 2")),
    ("bad_opcode", BAD_OPCODE,
     ("ValueError", "unimplemented opcode 0x7f at pc 0x1000"))])
def test_reference_programs(name, words, code):
    outcome, state = _same(words)
    assert outcome == code
    if name == "sum_loop":
        assert state["cycles"] == 2 + 3 * 100 + 2
    if name == "mul_div_rem":
        assert state["regs"][11:13] == [(-1) & 0xFFFFFFFF, 0xFFFFFFFF]


def test_cycle_limit():
    outcome, state = _same(SUM_LOOP, max_cycles=50)
    assert outcome == ("TimeoutError", "no halt within 50 cycles")
    assert state["cycles"] == 50


def test_cross_page_bytes():
    for pkg in PACKAGES:
        m = pkg.Machine()
        m.store_bytes(0xFFE, b"\x11\x22\x33\x44\x55\x66")
        assert m.load_bytes(0xFFE, 6) == b"\x11\x22\x33\x44\x55\x66"
        assert sorted(m.pages) == [0, 0x1000]


@pytest.mark.parametrize("segment_cycles", [16, 7, 1 << 21])
def test_segment_accounting(segment_cycles):
    prog = [addi(5, 0, 50), addi(5, 5, -1), bne(5, 0, -4), ECALL]
    states = []
    for pkg, halt in zip(PACKAGES, HALTS):
        m = pkg.Machine(segment_cycles=segment_cycles)
        m.store_bytes(0, _words(prog))
        with pytest.raises(halt):
            while True:
                m.step()
        states.append(_state(m))
    assert states[1] == states[0]
    assert all(s % segment_cycles == 0 for s in states[1]["segments"])
    assert bool(states[1]["segments"]) == (segment_cycles < 102)
    assert texecutor.SEGMENT_CYCLES == jexecutor.SEGMENT_CYCLES


def test_syscall_handler():
    """ECALL goes to on_ecall when one is given: here it writes a7 + a0
    into a1 until a0 reaches 3, then halts with a1."""
    prog = [addi(17, 0, 40), addi(10, 10, 1), ECALL, bne(10, 0, -8)]
    states = []
    for pkg, halt in zip(PACKAGES, HALTS):
        def on_ecall(m, halt=halt):
            m.regs[11] = m.regs[17] + m.regs[10]
            if m.regs[10] == 3:
                raise halt(m.regs[11])

        m = pkg.Machine(on_ecall=on_ecall)
        m.store_bytes(0x1000, _words(prog))
        m.pc = 0x1000
        states.append((m.run(), _state(m)))
    assert states[1] == states[0]
    assert states[1][0] == 43


@pytest.mark.parametrize("words", [[addi(10, 0, 42), ECALL], SUM_LOOP])
def test_run_elf(words):
    elf = _wrap_elf(words)
    (ref_code, ref_m), (code, m) = (pkg.run_elf(elf) for pkg in PACKAGES)
    assert code == ref_code and _state(m) == _state(ref_m)
    # the .bss tail of the image is zero-filled
    assert m.load_bytes(0x1000 + 4 * len(words), 64) == bytes(64)
    assert troutez.load_elf(elf, troutez.Machine()) == 0x1000


@pytest.mark.parametrize("offset,value,match", [
    (0, 0, "not an ELF"), (4, 2, "ELF32"), (5, 2, "little-endian"),
    (18, 62, "RISC-V")])
def test_run_elf_refusals(offset, value, match):
    bad = bytearray(_wrap_elf([ECALL]))
    bad[offset] = value
    errors = []
    for pkg in PACKAGES:
        with pytest.raises(ValueError, match=match) as e:
            pkg.run_elf(bytes(bad))
        errors.append(str(e.value))
    assert errors[1] == errors[0]


# --- seeded random programs ----------------------------------------------

DATA_BASE = 0x20000   # x31 holds it; loads and stores land within ±2 KiB


def _random_program(rng, length: int) -> list[int]:
    """`length` random instructions then ECALL: R-type ALU and M, I-type
    ALU and shifts, LUI/AUIPC, loads and stores off x31, and forward
    branches (so every program halts)."""
    prog = []
    for i in range(length):
        kind = rng.choice(["alu", "mext", "imm", "shift", "upper", "load",
                           "store", "branch"],
                          p=[.2, .15, .2, .1, .05, .1, .1, .1])
        rd = int(rng.integers(0, 31))          # x31 stays the data base
        rs1, rs2 = (int(r) for r in rng.integers(0, 32, 2))
        imm = int(rng.integers(-2048, 2048))
        if kind == "alu":
            f3 = int(rng.integers(0, 8))
            f7 = 0x20 if f3 in (0, 5) and rng.random() < .5 else 0
            prog.append(r_type(0x33, rd, f3, rs1, rs2, f7))
        elif kind == "mext":
            prog.append(r_type(0x33, rd, int(rng.integers(0, 8)), rs1,
                               rs2, 1))
        elif kind == "imm":
            prog.append(i_type(0x13, rd, int(rng.choice([0, 2, 3, 4, 6,
                                                            7])), rs1, imm))
        elif kind == "shift":
            f3 = int(rng.choice([1, 5]))
            sh = int(rng.integers(0, 32))
            hi = 0x400 if f3 == 5 and rng.random() < .5 else 0
            prog.append(i_type(0x13, rd, f3, rs1, hi | sh))
        elif kind == "upper":
            op = int(rng.choice([0x37, 0x17]))
            prog.append(int(rng.integers(0, 1 << 20)) << 12 | rd << 7 | op)
        elif kind == "load":
            prog.append(i_type(0x03, rd, int(rng.choice([0, 1, 2, 4, 5])),
                               31, imm))
        elif kind == "store":
            prog.append(s_type(0x23, int(rng.integers(0, 3)), 31, rs2, imm))
        else:
            left = length - i               # instructions up to the ECALL
            off = 4 * int(rng.integers(1, min(left, 8) + 1))
            prog.append(b_type(int(rng.choice([0, 1, 4, 5, 6, 7])), rs1,
                               rs2, off))
    return prog + [ECALL]


@pytest.mark.parametrize("seed", range(10))
def test_random_programs(seed):
    """Both executors step through the program in lockstep: the same
    state after every instruction, then the same exit code."""
    rng = np.random.default_rng(seed)
    regs = [0] + [int(v) for v in rng.integers(0, 1 << 32, 30,
                                                 dtype=np.uint64)]
    regs.append(DATA_BASE)
    # small values and the signed extremes, where M and shifts differ
    for r, v in zip(rng.choice(np.arange(1, 31), 6, replace=False),
                    (0, 1, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF, 3)):
        regs[int(r)] = v
    words = _random_program(rng, 120)
    machines = []
    for pkg in PACKAGES:
        m = pkg.Machine(segment_cycles=16)
        m.store_bytes(0x1000, _words(words))
        m.pc = 0x1000
        m.regs[:] = regs
        machines.append(m)
    codes = []
    while not codes:
        for m, halt in zip(machines, HALTS):
            try:
                m.step()
            except halt as h:
                codes.append(h.code)
        assert _state(machines[1]) == _state(machines[0])
    assert len(codes) == 2 and codes[1] == codes[0]
    state = _state(machines[1])
    assert state["segments"] == list(range(16, state["cycles"] + 1, 16))
