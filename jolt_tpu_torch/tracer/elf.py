"""ELF decoding: the RV32IM disassembler (jolt_tpu/tracer/elf.py;
reference: tracer/src/lib.rs:73-118 and decode.rs: a linear sweep of the
executable sections at or above RAM_START_ADDRESS, unrecognized words
becoming UNIMPL).

`decode_elf` reads the ELF32 little-endian file and section headers with
`struct` (no pyelftools); `decode_word` decodes one instruction word.
"""
from __future__ import annotations

import os
import struct

from ..vm.rv_trace import RAM_START_ADDRESS, ELFInstruction, RV32IM

SHT_NOBITS = 8
SHF_EXECINSTR = 0x4
_EHDR = struct.Struct("<16sHHIIIIIHHHHHH")   # ELF32 file header, 52 bytes
_SHDR = struct.Struct("<10I")                # ELF32 section header, 40 bytes


def _sign(v: int, bits: int) -> int:
    return v - (1 << bits) if v & (1 << (bits - 1)) else v


def _u32_imm(v: int) -> int:
    return v & 0xFFFFFFFF


def decode_word(word: int, address: int) -> ELFInstruction:
    opcode = word & 0x7F
    rd = (word >> 7) & 0x1F
    funct3 = (word >> 12) & 0x7
    rs1 = (word >> 15) & 0x1F
    rs2 = (word >> 20) & 0x1F
    funct7 = (word >> 25) & 0x7F

    def instr(op, **kw):
        return ELFInstruction(address=address, opcode=op, **kw)

    if opcode == 0x33:  # R-type
        table = {
            (0x0, 0x00): RV32IM.ADD, (0x0, 0x20): RV32IM.SUB,
            (0x4, 0x00): RV32IM.XOR, (0x6, 0x00): RV32IM.OR,
            (0x7, 0x00): RV32IM.AND, (0x1, 0x00): RV32IM.SLL,
            (0x5, 0x00): RV32IM.SRL, (0x5, 0x20): RV32IM.SRA,
            (0x2, 0x00): RV32IM.SLT, (0x3, 0x00): RV32IM.SLTU,
            (0x0, 0x01): RV32IM.MUL, (0x1, 0x01): RV32IM.MULH,
            (0x2, 0x01): RV32IM.MULHSU, (0x3, 0x01): RV32IM.MULHU,
            (0x4, 0x01): RV32IM.DIV, (0x5, 0x01): RV32IM.DIVU,
            (0x6, 0x01): RV32IM.REM, (0x7, 0x01): RV32IM.REMU,
        }
        op = table.get((funct3, funct7))
        if op is None:
            return instr(RV32IM.UNIMPL)
        return instr(op, rd=rd, rs1=rs1, rs2=rs2)

    if opcode == 0x13:  # I-type ALU
        imm = _sign(word >> 20, 12)
        shamt = (word >> 20) & 0x1F
        if funct3 == 0x0:
            return instr(RV32IM.ADDI, rd=rd, rs1=rs1, imm=_u32_imm(imm))
        if funct3 == 0x4:
            return instr(RV32IM.XORI, rd=rd, rs1=rs1, imm=_u32_imm(imm))
        if funct3 == 0x6:
            return instr(RV32IM.ORI, rd=rd, rs1=rs1, imm=_u32_imm(imm))
        if funct3 == 0x7:
            return instr(RV32IM.ANDI, rd=rd, rs1=rs1, imm=_u32_imm(imm))
        if funct3 == 0x2:
            return instr(RV32IM.SLTI, rd=rd, rs1=rs1, imm=_u32_imm(imm))
        if funct3 == 0x3:
            return instr(RV32IM.SLTIU, rd=rd, rs1=rs1, imm=_u32_imm(imm))
        if funct3 == 0x1:
            return instr(RV32IM.SLLI, rd=rd, rs1=rs1, imm=shamt)
        if funct3 == 0x5:
            op = RV32IM.SRAI if funct7 == 0x20 else RV32IM.SRLI
            return instr(op, rd=rd, rs1=rs1, imm=shamt)
        return instr(RV32IM.UNIMPL)

    if opcode == 0x03:  # loads
        imm = _sign(word >> 20, 12)
        op = {0x0: RV32IM.LB, 0x1: RV32IM.LH, 0x2: RV32IM.LW,
              0x4: RV32IM.LBU, 0x5: RV32IM.LHU}.get(funct3)
        if op is None:
            return instr(RV32IM.UNIMPL)
        return instr(op, rd=rd, rs1=rs1, imm=_u32_imm(imm))

    if opcode == 0x23:  # stores
        imm = _sign(((word >> 25) << 5) | rd, 12)
        op = {0x0: RV32IM.SB, 0x1: RV32IM.SH, 0x2: RV32IM.SW}.get(funct3)
        if op is None:
            return instr(RV32IM.UNIMPL)
        return instr(op, rs1=rs1, rs2=rs2, imm=_u32_imm(imm))

    if opcode == 0x63:  # branches
        imm = _sign((((word >> 31) & 1) << 12) | (((word >> 7) & 1) << 11)
                    | (((word >> 25) & 0x3F) << 5)
                    | (((word >> 8) & 0xF) << 1), 13)
        op = {0x0: RV32IM.BEQ, 0x1: RV32IM.BNE, 0x4: RV32IM.BLT,
              0x5: RV32IM.BGE, 0x6: RV32IM.BLTU, 0x7: RV32IM.BGEU}.get(funct3)
        if op is None:
            return instr(RV32IM.UNIMPL)
        return instr(op, rs1=rs1, rs2=rs2, imm=_u32_imm(imm))

    if opcode == 0x6F:  # JAL
        imm = _sign((((word >> 31) & 1) << 20)
                    | (((word >> 12) & 0xFF) << 12)
                    | (((word >> 20) & 1) << 11)
                    | (((word >> 21) & 0x3FF) << 1), 21)
        return instr(RV32IM.JAL, rd=rd, imm=_u32_imm(imm))

    if opcode == 0x67 and funct3 == 0x0:  # JALR
        imm = _sign(word >> 20, 12)
        return instr(RV32IM.JALR, rd=rd, rs1=rs1, imm=_u32_imm(imm))

    if opcode == 0x37:  # LUI
        return instr(RV32IM.LUI, rd=rd, imm=word & 0xFFFFF000)
    if opcode == 0x17:  # AUIPC
        return instr(RV32IM.AUIPC, rd=rd, imm=word & 0xFFFFF000)
    if opcode == 0x0F:
        return instr(RV32IM.FENCE)
    if opcode == 0x73:
        if word == 0x73:
            return instr(RV32IM.ECALL)
        if word == 0x00100073:
            return instr(RV32IM.EBREAK)

    return instr(RV32IM.UNIMPL)


def _sections(elf: bytes):
    """(sh_type, sh_flags, sh_addr, payload) of each section in the
    section-header table, index 0 included, as pyelftools walks them."""
    if len(elf) < _EHDR.size or elf[:4] != b"\x7fELF":
        raise ValueError("not an ELF file")
    if elf[4] != 1 or elf[5] != 1:
        raise ValueError("not a 32-bit little-endian ELF file")
    (_, _, _, _, entry, _, shoff, _, _, _, _, shentsize, shnum,
     _) = _EHDR.unpack_from(elf)
    if shoff and shentsize != _SHDR.size:
        raise ValueError(f"ELF section headers of {shentsize} bytes")

    def header(i: int):
        off = shoff + i * _SHDR.size
        if off + _SHDR.size > len(elf):
            raise ValueError("ELF section header past the end of the file")
        return _SHDR.unpack_from(elf, off)

    if shoff and shnum == 0:          # extended numbering: count in sh_size
        shnum = header(0)[5]
    out = []
    for i in range(shnum if shoff else 0):
        _, sh_type, flags, addr, offset, size = header(i)[:6]
        payload = b""
        if sh_type != SHT_NOBITS:
            if offset + size > len(elf):
                raise ValueError("ELF section data past the end of the file")
            payload = elf[offset:offset + size]
        out.append((sh_type, flags, addr, payload))
    return entry, out


def decode_elf(elf) -> tuple[list[ELFInstruction], list[tuple[int, int]],
                             int]:
    """Decode an ELF image, given as bytes or as a path: (instructions,
    memory init [(address, byte)], entry).

    Mirrors tracer::decode (lib.rs:73-118): executable sections at or above
    RAM_START_ADDRESS are swept word by word; the other sections there,
    NOBITS aside, become memory init.
    """
    if not isinstance(elf, (bytes, bytearray, memoryview)):
        with open(os.fspath(elf), "rb") as f:
            elf = f.read()
    entry, sections = _sections(bytes(elf))
    instructions = []
    memory_init: list[tuple[int, int]] = []
    for sh_type, flags, addr, data in sections:
        if addr < RAM_START_ADDRESS or sh_type == SHT_NOBITS:
            continue
        if flags & SHF_EXECINSTR:
            for off in range(0, len(data) - 3, 4):
                word = int.from_bytes(data[off:off + 4], "little")
                instructions.append(decode_word(word, addr + off))
        else:
            memory_init.extend((addr + off, b) for off, b in enumerate(data))
    return instructions, memory_init, entry
