"""Trace step construction: RVTraceRow -> prover witness inputs.

Reference: common/src/rv_trace.rs:46-217 (memory-op conversion),
jolt-core/src/jolt/trace/rv.rs (opcode -> lookup instruction + operands),
jolt-core/src/jolt/vm/mod.rs:63-99 (JoltTraceStep + padding).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .bytecode import BytecodeRow
from .rv_trace import (MEMORY_OPS_PER_INSTRUCTION, NUM_CIRCUIT_FLAGS, RV32IM,
                       ELFInstruction, MemoryState, RVTraceRow)

_R_TYPE = {RV32IM.ADD, RV32IM.SUB, RV32IM.XOR, RV32IM.OR, RV32IM.AND,
           RV32IM.SLL, RV32IM.SRL, RV32IM.SRA, RV32IM.SLT, RV32IM.SLTU,
           RV32IM.MUL, RV32IM.MULH, RV32IM.MULHU, RV32IM.MULHSU, RV32IM.MULU,
           RV32IM.DIV, RV32IM.DIVU, RV32IM.REM, RV32IM.REMU,
           RV32IM.VIRTUAL_ASSERT_LTE,
           RV32IM.VIRTUAL_ASSERT_VALID_SIGNED_REMAINDER,
           RV32IM.VIRTUAL_ASSERT_VALID_UNSIGNED_REMAINDER,
           RV32IM.VIRTUAL_ASSERT_EQ, RV32IM.VIRTUAL_ASSERT_VALID_DIV0}
_I_TYPE = {RV32IM.ADDI, RV32IM.XORI, RV32IM.ORI, RV32IM.ANDI, RV32IM.SLLI,
           RV32IM.SRLI, RV32IM.SRAI, RV32IM.SLTI, RV32IM.SLTIU, RV32IM.LB,
           RV32IM.LH, RV32IM.LW, RV32IM.LBU, RV32IM.LHU, RV32IM.JALR,
           RV32IM.FENCE, RV32IM.VIRTUAL_MOVE, RV32IM.VIRTUAL_MOVSIGN,
           RV32IM.VIRTUAL_ADVICE, RV32IM.ECALL, RV32IM.EBREAK}
_S_TYPE = {RV32IM.SB, RV32IM.SH, RV32IM.SW}
_SB_TYPE = {RV32IM.BEQ, RV32IM.BNE, RV32IM.BLT, RV32IM.BGE, RV32IM.BLTU,
            RV32IM.BGEU}
_U_TYPE = {RV32IM.LUI, RV32IM.AUIPC}
_UJ_TYPE = {RV32IM.JAL}

# opcode -> (lookup instruction name, operand mode) per trace/rv.rs:98-180
# operand modes: rs1_rs2, rs1_imm, pc_imm, rs2_only, load_value, advice, rs1_only
LOOKUP_MAP: dict[RV32IM, tuple[str, str]] = {
    RV32IM.ADD: ("add", "rs1_rs2"), RV32IM.SUB: ("sub", "rs1_rs2"),
    RV32IM.XOR: ("xor", "rs1_rs2"), RV32IM.OR: ("or", "rs1_rs2"),
    RV32IM.AND: ("and", "rs1_rs2"), RV32IM.SLL: ("sll", "rs1_rs2"),
    RV32IM.SRL: ("srl", "rs1_rs2"), RV32IM.SRA: ("sra", "rs1_rs2"),
    RV32IM.SLT: ("slt", "rs1_rs2"), RV32IM.SLTU: ("sltu", "rs1_rs2"),
    RV32IM.ADDI: ("add", "rs1_imm"), RV32IM.XORI: ("xor", "rs1_imm"),
    RV32IM.ORI: ("or", "rs1_imm"), RV32IM.ANDI: ("and", "rs1_imm"),
    RV32IM.SLLI: ("sll", "rs1_imm"), RV32IM.SRLI: ("srl", "rs1_imm"),
    RV32IM.SRAI: ("sra", "rs1_imm"), RV32IM.SLTI: ("slt", "rs1_imm"),
    RV32IM.SLTIU: ("sltu", "rs1_imm"),
    RV32IM.BEQ: ("beq", "rs1_rs2"), RV32IM.BNE: ("bne", "rs1_rs2"),
    RV32IM.BLT: ("slt", "rs1_rs2"), RV32IM.BLTU: ("sltu", "rs1_rs2"),
    RV32IM.BGE: ("bge", "rs1_rs2"), RV32IM.BGEU: ("bgeu", "rs1_rs2"),
    RV32IM.JAL: ("add", "pc_imm"), RV32IM.JALR: ("add", "rs1_imm"),
    RV32IM.AUIPC: ("add", "pc_imm"),
    RV32IM.SB: ("sb", "rs2_only"), RV32IM.SH: ("sh", "rs2_only"),
    RV32IM.SW: ("sw", "rs2_only"),
    RV32IM.LB: ("lb", "load_value"), RV32IM.LH: ("lh", "load_value"),
    RV32IM.LW: ("sw", "load_value"), RV32IM.LBU: ("sb", "load_value"),
    RV32IM.LHU: ("sh", "load_value"),
    RV32IM.MUL: ("mul", "rs1_rs2"), RV32IM.MULU: ("mulu", "rs1_rs2"),
    RV32IM.MULHU: ("mulhu", "rs1_rs2"),
    RV32IM.VIRTUAL_ADVICE: ("virtual_advice", "advice"),
    RV32IM.VIRTUAL_MOVE: ("virtual_move", "rs1_only"),
    RV32IM.VIRTUAL_MOVSIGN: ("virtual_movsign", "rs1_only"),
    RV32IM.VIRTUAL_ASSERT_EQ: ("beq", "rs1_rs2"),
    RV32IM.VIRTUAL_ASSERT_LTE: ("virtual_assert_lte", "rs1_rs2"),
    RV32IM.VIRTUAL_ASSERT_VALID_UNSIGNED_REMAINDER:
        ("virtual_assert_valid_unsigned_remainder", "rs1_rs2"),
    RV32IM.VIRTUAL_ASSERT_VALID_SIGNED_REMAINDER:
        ("virtual_assert_valid_signed_remainder", "rs1_rs2"),
    RV32IM.VIRTUAL_ASSERT_VALID_DIV0:
        ("virtual_assert_valid_div0", "rs1_rs2"),
}


def instruction_format(op: RV32IM) -> str:
    for fmt, s in (("R", _R_TYPE), ("I", _I_TYPE), ("S", _S_TYPE),
                   ("SB", _SB_TYPE), ("U", _U_TYPE), ("UJ", _UJ_TYPE)):
        if op in s:
            return fmt
    raise ValueError(op)


@dataclass
class JoltTraceStep:
    """One step of the prover-facing trace (vm/mod.rs:63-99)."""
    bytecode_row: BytecodeRow
    instruction_index: int        # index into the VM instruction set, -1 = none
    lookup_x: int
    lookup_y: int
    memory_ops_is_write: list[bool]
    memory_ops_addr: list[int]
    memory_ops_val: list[int]
    circuit_flags: list[bool]

    @staticmethod
    def no_op() -> "JoltTraceStep":
        return JoltTraceStep(
            bytecode_row=BytecodeRow.no_op(0),
            instruction_index=-1, lookup_x=0, lookup_y=0,
            memory_ops_is_write=[False, False, True, False, False, False, False],
            memory_ops_addr=[0] * 7, memory_ops_val=[0] * 7,
            circuit_flags=[False] * NUM_CIRCUIT_FLAGS)


def trace_row_to_step(row: RVTraceRow, instruction_name_to_index,
                      num_instructions: int) -> JoltTraceStep:
    instr = row.instruction
    op = instr.opcode
    fmt = instruction_format(op)
    rs = row.register_state

    # lookup operands (trace/rv.rs:98-180)
    lookup = LOOKUP_MAP.get(op)
    if lookup is None:
        instr_index, x, y = -1, 0, 0
    else:
        name, mode = lookup
        instr_index = instruction_name_to_index.get(name, -1)
        imm_u = (instr.imm or 0) & 0xFFFFFFFF
        if mode == "rs1_rs2":
            x, y = rs.rs1_val or 0, rs.rs2_val or 0
        elif mode == "rs1_imm":
            x, y = rs.rs1_val or 0, imm_u
        elif mode == "pc_imm":
            x, y = instr.address, imm_u
        elif mode == "rs2_only":
            x, y = rs.rs2_val or 0, 0
        elif mode == "load_value":
            assert row.memory_state is not None and not row.memory_state.is_write
            x, y = row.memory_state.value, 0
        elif mode == "advice":
            x, y = row.advice_value or 0, 0
        elif mode == "rs1_only":
            x, y = rs.rs1_val or 0, 0
        else:
            raise ValueError(mode)

    # memory ops (rv_trace.rs:46-217)
    is_w = [False, False, True, False, False, False, False]
    addr = [0] * 7
    val = [0] * 7

    def set_reg_reads():
        addr[0] = instr.rs1 or 0
        addr[1] = instr.rs2 or 0

    def set_rd():
        addr[2] = instr.rd or 0
        val[2] = rs.rd_post_val or 0

    def rs1_offset():
        imm = instr.imm or 0
        return (rs.rs1_val + imm) & 0xFFFFFFFF

    def mem_bytes(n, write):
        base = rs1_offset()
        if write:
            post = row.memory_state.value
            for k in range(n):
                is_w[3 + k] = True
                addr[3 + k] = base + k
                val[3 + k] = (post >> (8 * k)) & 0xFF
        else:
            for k in range(n):
                addr[3 + k] = base + k

    if fmt == "R":
        set_reg_reads()
        set_rd()
    elif fmt == "U" or fmt == "UJ":
        set_rd()
    elif fmt == "SB":
        set_reg_reads()
    elif fmt == "S":
        set_reg_reads()
        n = {RV32IM.SB: 1, RV32IM.SH: 2, RV32IM.SW: 4}[op]
        mem_bytes(n, True)
    elif fmt == "I":
        if op in (RV32IM.FENCE, RV32IM.ECALL, RV32IM.EBREAK):
            pass
        else:
            addr[0] = instr.rs1 or 0
            set_rd()
            if op in (RV32IM.LB, RV32IM.LBU):
                mem_bytes(1, False)
            elif op in (RV32IM.LH, RV32IM.LHU):
                mem_bytes(2, False)
            elif op == RV32IM.LW:
                mem_bytes(4, False)

    return JoltTraceStep(
        bytecode_row=BytecodeRow.from_instruction(
            instr, instr_index if instr_index >= 0 else None,
            num_instructions),
        instruction_index=instr_index, lookup_x=x, lookup_y=y,
        memory_ops_is_write=is_w, memory_ops_addr=addr, memory_ops_val=val,
        circuit_flags=instr.to_circuit_flags())


def pad_trace(steps: list[JoltTraceStep]) -> list[JoltTraceStep]:
    n = len(steps)
    target = 1 if n <= 1 else 1 << (n - 1).bit_length()
    return steps + [JoltTraceStep.no_op() for _ in range(target - n)]
