"""RV32IM executor: the port's copy of zktls_tpu.routez.executor, the
sequential witness-generation core of Route Z, in pure Python on the host
(no device).

Mirrors the role of the reference's `sp1-core-executor` /
`risc0-circuit-rv32im` step functions (SURVEY.md §2.2.B/C): execute the
guest ISA, count cycles and split execution into po2-bounded segments.

Implements the full RV32IM unprivileged ISA (I base + M extension), small
and auditable; memory is a sparse page map so ELF images load at their
linked addresses.  ECALL dispatches to a pluggable syscall handler —
SP1 and RISC0 use different guest ABIs, so the binding layer supplies the
right one.
"""

from __future__ import annotations

from dataclasses import dataclass, field

__all__ = ["Machine", "Halt", "run_elf", "SEGMENT_CYCLES"]

MASK32 = 0xFFFFFFFF
PAGE = 4096
#: default segment bound (matches the reference's po2-capped continuations,
#: SURVEY.md §2.2.C "segments (po2 cap)")
SEGMENT_CYCLES = 1 << 21


class Halt(Exception):
    def __init__(self, code: int):
        super().__init__(f"guest halted with exit code {code}")
        self.code = code


def _sext(v: int, bits: int) -> int:
    m = 1 << (bits - 1)
    return (v ^ m) - m


@dataclass
class Machine:
    pc: int = 0
    regs: list[int] = field(default_factory=lambda: [0] * 32)
    pages: dict[int, bytearray] = field(default_factory=dict)
    cycles: int = 0
    #: completed segment boundaries (cycle counts), the resumable artifact
    segments: list[int] = field(default_factory=list)
    segment_cycles: int = SEGMENT_CYCLES
    #: syscall handler: fn(machine) — reads a7/a0.., may raise Halt
    on_ecall: object = None

    # -- memory ------------------------------------------------------------

    def _page(self, addr: int) -> bytearray:
        base = addr & ~(PAGE - 1)
        pg = self.pages.get(base)
        if pg is None:
            pg = bytearray(PAGE)
            self.pages[base] = pg
        return pg

    def load_bytes(self, addr: int, n: int) -> bytes:
        out = bytearray()
        while n:
            off = addr & (PAGE - 1)
            take = min(n, PAGE - off)
            out += self._page(addr)[off : off + take]
            addr += take
            n -= take
        return bytes(out)

    def store_bytes(self, addr: int, data: bytes) -> None:
        pos = 0
        while pos < len(data):
            off = addr & (PAGE - 1)
            take = min(len(data) - pos, PAGE - off)
            self._page(addr)[off : off + take] = data[pos : pos + take]
            addr += take
            pos += take

    def _lw(self, addr: int) -> int:
        return int.from_bytes(self.load_bytes(addr, 4), "little")

    def _sw(self, addr: int, v: int) -> None:
        self.store_bytes(addr, (v & MASK32).to_bytes(4, "little"))

    # -- execution -----------------------------------------------------------

    def step(self) -> None:
        inst = self._lw(self.pc)
        self.cycles += 1
        if self.cycles % self.segment_cycles == 0:
            self.segments.append(self.cycles)
        opcode = inst & 0x7F
        rd = (inst >> 7) & 0x1F
        rs1 = (inst >> 15) & 0x1F
        rs2 = (inst >> 20) & 0x1F
        funct3 = (inst >> 12) & 0x7
        funct7 = inst >> 25
        r = self.regs
        pc_next = (self.pc + 4) & MASK32

        def wr(v: int) -> None:
            if rd:
                r[rd] = v & MASK32

        if opcode == 0x37:            # LUI
            wr(inst & 0xFFFFF000)
        elif opcode == 0x17:          # AUIPC
            wr(self.pc + (inst & 0xFFFFF000))
        elif opcode == 0x6F:          # JAL
            imm = (_sext(inst >> 31, 1) << 20) | (((inst >> 21) & 0x3FF) << 1) \
                | (((inst >> 20) & 1) << 11) | (((inst >> 12) & 0xFF) << 12)
            wr(pc_next)
            pc_next = (self.pc + imm) & MASK32
        elif opcode == 0x67:          # JALR
            imm = _sext(inst >> 20, 12)
            target = (r[rs1] + imm) & MASK32 & ~1
            wr(pc_next)
            pc_next = target
        elif opcode == 0x63:          # branches
            imm = (_sext(inst >> 31, 1) << 12) | (((inst >> 25) & 0x3F) << 5) \
                | (((inst >> 8) & 0xF) << 1) | (((inst >> 7) & 1) << 11)
            a, b = r[rs1], r[rs2]
            sa, sb = _sext(a, 32), _sext(b, 32)
            taken = {
                0: a == b, 1: a != b, 4: sa < sb, 5: sa >= sb,
                6: a < b, 7: a >= b,
            }.get(funct3)
            if taken is None:
                raise ValueError(f"bad branch funct3 {funct3}")
            if taken:
                pc_next = (self.pc + imm) & MASK32
        elif opcode == 0x03:          # loads
            addr = (r[rs1] + _sext(inst >> 20, 12)) & MASK32
            if funct3 == 0:
                wr(_sext(self.load_bytes(addr, 1)[0], 8))
            elif funct3 == 1:
                wr(_sext(int.from_bytes(self.load_bytes(addr, 2),
                                        "little"), 16))
            elif funct3 == 2:
                wr(self._lw(addr))
            elif funct3 == 4:
                wr(self.load_bytes(addr, 1)[0])
            elif funct3 == 5:
                wr(int.from_bytes(self.load_bytes(addr, 2), "little"))
            else:
                raise ValueError(f"bad load funct3 {funct3}")
        elif opcode == 0x23:          # stores
            imm = _sext((inst >> 25) << 5 | ((inst >> 7) & 0x1F), 12)
            addr = (r[rs1] + imm) & MASK32
            if funct3 == 0:
                self.store_bytes(addr, bytes([r[rs2] & 0xFF]))
            elif funct3 == 1:
                self.store_bytes(addr, (r[rs2] & 0xFFFF).to_bytes(2,
                                                                  "little"))
            elif funct3 == 2:
                self._sw(addr, r[rs2])
            else:
                raise ValueError(f"bad store funct3 {funct3}")
        elif opcode == 0x13:          # ALU immediate
            imm = _sext(inst >> 20, 12)
            a = r[rs1]
            if funct3 == 0:
                wr(a + imm)
            elif funct3 == 2:
                wr(1 if _sext(a, 32) < imm else 0)
            elif funct3 == 3:
                wr(1 if a < (imm & MASK32) else 0)
            elif funct3 == 4:
                wr(a ^ imm)
            elif funct3 == 6:
                wr(a | imm)
            elif funct3 == 7:
                wr(a & imm)
            elif funct3 == 1:
                wr(a << (imm & 0x1F))
            elif funct3 == 5:
                sh = imm & 0x1F
                if (inst >> 30) & 1:
                    wr(_sext(a, 32) >> sh)
                else:
                    wr(a >> sh)
        elif opcode == 0x33:          # ALU register (incl. M extension)
            a, b = r[rs1], r[rs2]
            sa, sb = _sext(a, 32), _sext(b, 32)
            if funct7 == 1:           # RV32M
                if funct3 == 0:
                    wr(a * b)
                elif funct3 == 1:     # MULH
                    wr((sa * sb) >> 32)
                elif funct3 == 2:     # MULHSU
                    wr((sa * b) >> 32)
                elif funct3 == 3:     # MULHU
                    wr((a * b) >> 32)
                elif funct3 == 4:     # DIV
                    if b == 0:
                        wr(MASK32)
                    elif sa == -(1 << 31) and sb == -1:
                        wr(a)
                    else:
                        q = abs(sa) // abs(sb)
                        wr(q if (sa < 0) == (sb < 0) else -q)
                elif funct3 == 5:     # DIVU
                    wr(MASK32 if b == 0 else a // b)
                elif funct3 == 6:     # REM
                    if b == 0:
                        wr(a)
                    elif sa == -(1 << 31) and sb == -1:
                        wr(0)
                    else:
                        rmd = abs(sa) % abs(sb)
                        wr(rmd if sa >= 0 else -rmd)
                elif funct3 == 7:     # REMU
                    wr(a if b == 0 else a % b)
            else:
                if funct3 == 0:
                    wr(a - b if funct7 == 0x20 else a + b)
                elif funct3 == 1:
                    wr(a << (b & 0x1F))
                elif funct3 == 2:
                    wr(1 if sa < sb else 0)
                elif funct3 == 3:
                    wr(1 if a < b else 0)
                elif funct3 == 4:
                    wr(a ^ b)
                elif funct3 == 5:
                    sh = b & 0x1F
                    wr(_sext(a, 32) >> sh if funct7 == 0x20 else a >> sh)
                elif funct3 == 6:
                    wr(a | b)
                elif funct3 == 7:
                    wr(a & b)
        elif opcode == 0x73:          # SYSTEM
            if inst == 0x00000073:    # ECALL
                if self.on_ecall is not None:
                    self.on_ecall(self)
                else:
                    raise Halt(r[10])  # default ABI: a0 = exit code
            elif inst == 0x00100073:  # EBREAK
                raise Halt(r[10])
            else:
                pass                  # CSR ops: no-op in the skeleton
        elif opcode == 0x0F:          # FENCE
            pass
        else:
            raise ValueError(
                f"unimplemented opcode {opcode:#x} at pc {self.pc:#x}")
        self.pc = pc_next

    def run(self, max_cycles: int = 1 << 32) -> int:
        try:
            while self.cycles < max_cycles:
                self.step()
        except Halt as h:
            return h.code
        raise TimeoutError(f"no halt within {max_cycles} cycles")


def run_elf(elf_bytes: bytes, *, on_ecall=None,
            max_cycles: int = 1 << 32) -> tuple[int, Machine]:
    """Load an RV32 ELF and run to halt; returns (exit_code, machine)."""
    from .elf import load_elf

    m = Machine(on_ecall=on_ecall)
    entry = load_elf(elf_bytes, m)
    m.pc = entry
    code = m.run(max_cycles=max_cycles)
    return code, m
