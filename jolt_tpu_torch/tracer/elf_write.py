"""ELF encoding: RV32IM instruction words and a minimal ELF32 writer
(jolt_tpu/tracer/elf_write.py).

The reference takes guests as ELF files from the RISC-V toolchain
(tracer/src/lib.rs:73-118 decodes them).  This is the inverse of
`elf.decode_word`: it renders ELFInstruction programs into instruction
words and wraps them in a minimal, spec-valid ELF32 image, so the
decode -> trace -> prove path runs from real ELF bytes without a cross
toolchain.  The bytes equal jolt_tpu's `write_elf`.
"""
from __future__ import annotations

import struct

from ..vm.rv_trace import RAM_START_ADDRESS, ELFInstruction, RV32IM

_R_TABLE = {
    RV32IM.ADD: (0x0, 0x00), RV32IM.SUB: (0x0, 0x20),
    RV32IM.XOR: (0x4, 0x00), RV32IM.OR: (0x6, 0x00),
    RV32IM.AND: (0x7, 0x00), RV32IM.SLL: (0x1, 0x00),
    RV32IM.SRL: (0x5, 0x00), RV32IM.SRA: (0x5, 0x20),
    RV32IM.SLT: (0x2, 0x00), RV32IM.SLTU: (0x3, 0x00),
    RV32IM.MUL: (0x0, 0x01), RV32IM.MULH: (0x1, 0x01),
    RV32IM.MULHSU: (0x2, 0x01), RV32IM.MULHU: (0x3, 0x01),
    RV32IM.DIV: (0x4, 0x01), RV32IM.DIVU: (0x5, 0x01),
    RV32IM.REM: (0x6, 0x01), RV32IM.REMU: (0x7, 0x01),
}
_I_ALU = {RV32IM.ADDI: 0x0, RV32IM.XORI: 0x4, RV32IM.ORI: 0x6,
          RV32IM.ANDI: 0x7, RV32IM.SLTI: 0x2, RV32IM.SLTIU: 0x3}
_SHIFTS = {RV32IM.SLLI: (0x1, 0x00), RV32IM.SRLI: (0x5, 0x00),
           RV32IM.SRAI: (0x5, 0x20)}
_LOADS = {RV32IM.LB: 0x0, RV32IM.LH: 0x1, RV32IM.LW: 0x2,
          RV32IM.LBU: 0x4, RV32IM.LHU: 0x5}
_STORES = {RV32IM.SB: 0x0, RV32IM.SH: 0x1, RV32IM.SW: 0x2}
_BRANCHES = {RV32IM.BEQ: 0x0, RV32IM.BNE: 0x1, RV32IM.BLT: 0x4,
             RV32IM.BGE: 0x5, RV32IM.BLTU: 0x6, RV32IM.BGEU: 0x7}


def _simm(u32: int, bits: int, what: str) -> int:
    """u32-stored immediate -> signed value, range-checked to `bits`."""
    v = u32 & 0xFFFFFFFF
    v = v - (1 << 32) if v & (1 << 31) else v
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    if not lo <= v <= hi:
        raise ValueError(f"{what} immediate {v} exceeds {bits} bits")
    return v & ((1 << bits) - 1)


def encode_word(instr: ELFInstruction) -> int:
    """ELFInstruction -> 32-bit RV32IM instruction word (decode_word⁻¹)."""
    op = instr.opcode
    rd = instr.rd or 0
    rs1 = instr.rs1 or 0
    rs2 = instr.rs2 or 0
    imm = instr.imm or 0

    if op in _R_TABLE:
        f3, f7 = _R_TABLE[op]
        return (f7 << 25) | (rs2 << 20) | (rs1 << 15) | (f3 << 12) \
            | (rd << 7) | 0x33
    if op in _I_ALU:
        i = _simm(imm, 12, op.name)
        return (i << 20) | (rs1 << 15) | (_I_ALU[op] << 12) | (rd << 7) | 0x13
    if op in _SHIFTS:
        f3, f7 = _SHIFTS[op]
        if not 0 <= imm < 32:
            raise ValueError(f"{op.name} shamt {imm} out of range")
        return (f7 << 25) | (imm << 20) | (rs1 << 15) | (f3 << 12) \
            | (rd << 7) | 0x13
    if op in _LOADS:
        i = _simm(imm, 12, op.name)
        return (i << 20) | (rs1 << 15) | (_LOADS[op] << 12) | (rd << 7) | 0x03
    if op in _STORES:
        i = _simm(imm, 12, op.name)
        return ((i >> 5) << 25) | (rs2 << 20) | (rs1 << 15) \
            | (_STORES[op] << 12) | ((i & 0x1F) << 7) | 0x23
    if op in _BRANCHES:
        i = _simm(imm, 13, op.name)
        return (((i >> 12) & 1) << 31) | (((i >> 5) & 0x3F) << 25) \
            | (rs2 << 20) | (rs1 << 15) | (_BRANCHES[op] << 12) \
            | (((i >> 1) & 0xF) << 8) | (((i >> 11) & 1) << 7) | 0x63
    if op is RV32IM.JAL:
        i = _simm(imm, 21, "JAL")
        return (((i >> 20) & 1) << 31) | (((i >> 1) & 0x3FF) << 21) \
            | (((i >> 11) & 1) << 20) | (((i >> 12) & 0xFF) << 12) \
            | (rd << 7) | 0x6F
    if op is RV32IM.JALR:
        i = _simm(imm, 12, "JALR")
        return (i << 20) | (rs1 << 15) | (rd << 7) | 0x67
    if op in (RV32IM.LUI, RV32IM.AUIPC):
        if imm & 0xFFF:
            raise ValueError(f"{op.name} immediate has low bits set")
        base = 0x37 if op is RV32IM.LUI else 0x17
        return (imm & 0xFFFFF000) | (rd << 7) | base
    if op is RV32IM.FENCE:
        return 0x0F
    if op is RV32IM.ECALL:
        return 0x73
    if op is RV32IM.EBREAK:
        return 0x00100073
    raise ValueError(f"cannot encode {op.name} (virtual/unsupported opcode)")


def elf_image(instructions: list[ELFInstruction], data: bytes = b"",
              data_addr: int | None = None, entry: int | None = None
              ) -> bytes:
    """A minimal ELF32 (EM_RISCV) image that decode_elf can read.

    One executable .text section at the program's base address, an
    optional writable .data section, and .shstrtab.  No program headers:
    decode_elf (like tracer/src/lib.rs) walks sections, not segments.
    """
    if not instructions:
        raise ValueError("empty program")
    base = instructions[0].address
    words = bytearray()
    for k, ins in enumerate(instructions):
        if ins.address != base + 4 * k:
            raise ValueError("non-contiguous .text (gaps unsupported)")
        words += struct.pack("<I", encode_word(ins))
    text = bytes(words)

    shstrtab = b"\x00.text\x00.data\x00.shstrtab\x00"
    name_off = {"": 0, ".text": 1, ".data": 7, ".shstrtab": 13}

    ehsize, shentsize = 52, 40
    sections = [("", b"", 0, 0, 0)]                      # SHT_NULL
    sections.append((".text", text, base, 1, 0x6))       # PROGBITS, AX
    if data:
        sections.append((".data", data,
                         data_addr if data_addr is not None
                         else base + len(text), 1, 0x3))  # PROGBITS, WA
    sections.append((".shstrtab", shstrtab, 0, 3, 0))    # STRTAB

    # layout: file header | section payloads | section-header table
    off = ehsize
    offsets = []
    for _, payload, _, _, _ in sections:
        offsets.append(off)
        off += len(payload)
    shoff = off

    shdrs = b"".join(
        struct.pack("<10I", name_off[name], sh_type, flags, addr,
                    o if sh_type else 0, len(payload), 0, 0,
                    4 if sh_type else 0, 0)
        for (name, payload, addr, sh_type, flags), o
        in zip(sections, offsets))

    ehdr = struct.pack(
        "<4sBBBBB7xHHIIIIIHHHHHH",
        b"\x7fELF", 1, 1, 1, 0, 0,      # ELFCLASS32, LSB, EV_CURRENT
        2, 243,                          # ET_EXEC, EM_RISCV
        1,                               # e_version
        entry if entry is not None else RAM_START_ADDRESS,
        0, shoff, 0,                     # e_phoff, e_shoff, e_flags
        ehsize, 0, 0,                    # e_ehsize, phentsize, phnum
        shentsize, len(sections), len(sections) - 1)
    return ehdr + b"".join(p for _, p, _, _, _ in sections) + shdrs


def write_elf(path: str, instructions: list[ELFInstruction],
              data: bytes = b"", data_addr: int | None = None,
              entry: int | None = None) -> None:
    """Write `elf_image(...)` to `path`."""
    image = elf_image(instructions, data, data_addr, entry)
    with open(path, "wb") as f:
        f.write(image)
