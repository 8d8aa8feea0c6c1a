"""Minimal ELF32 loader for RV32 guest binaries (the port's copy of
zktls_tpu.routez.elf; host code).

Loads PT_LOAD segments into the executor's sparse memory and returns the
entry point — the same job `risc0-binfmt`'s ELF→MemoryImage step does
(SURVEY.md §2.2.C)."""

from __future__ import annotations

import struct

__all__ = ["load_elf"]

EM_RISCV = 243
PT_LOAD = 1


def load_elf(data: bytes, machine) -> int:
    """Load PT_LOAD segments into `machine`; returns the entry address."""
    if data[:4] != b"\x7fELF":
        raise ValueError("not an ELF file")
    if data[4] != 1:
        raise ValueError("need ELF32")
    if data[5] != 1:
        raise ValueError("need little-endian ELF")
    (e_type, e_machine, _ver, e_entry, e_phoff, _shoff, _flags, _ehsize,
     e_phentsize, e_phnum) = struct.unpack_from("<HHIIIIIHHH", data, 16)
    if e_machine != EM_RISCV:
        raise ValueError(f"not a RISC-V ELF (machine {e_machine})")
    for i in range(e_phnum):
        off = e_phoff + i * e_phentsize
        (p_type, p_offset, p_vaddr, _paddr, p_filesz, p_memsz, _pflags,
         _align) = struct.unpack_from("<IIIIIIII", data, off)
        if p_type != PT_LOAD:
            continue
        seg = data[p_offset : p_offset + p_filesz]
        machine.store_bytes(p_vaddr, seg)
        if p_memsz > p_filesz:  # .bss
            machine.store_bytes(p_vaddr + p_filesz,
                                bytes(p_memsz - p_filesz))
    return e_entry
