"""RV32IM emulator producing prover traces.

Reference: tracer/src/emulator/cpu.rs (4.4k-line interpreter) + lib.rs:26-70.
Off the critical path (SURVEY §2.2): a compact Python interpreter over
`ELFInstruction` programs is sufficient — it must only reproduce the exact
RVTraceRow stream: register/memory state captures, JoltDevice-mapped I/O, and
the PC-repeat termination heuristic (lib.rs:48-60).

M-extension opcodes (DIV/REM/MULH/MULHSU) are expanded into virtual
sequences at trace time by the host layer (host.py).
"""
from __future__ import annotations

from dataclasses import dataclass

from ..vm.rv_trace import (RAM_START_ADDRESS, ELFInstruction, JoltDevice,
                           MemoryState, RegisterState, RV32IM, RVTraceRow)


def _s32(v: int) -> int:
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v & (1 << 31) else v


def _u32(v: int) -> int:
    return v & 0xFFFFFFFF


class Emulator:
    def __init__(self, bytecode: list[ELFInstruction], device: JoltDevice):
        self.program = {i.address: i for i in bytecode}
        self.device = device
        self.regs = [0] * 64  # 32 real + 32 virtual registers
        self.pc = min(self.program) if self.program else RAM_START_ADDRESS
        self.memory: dict[int, int] = {}  # byte-addressed RAM
        self.rows: list[RVTraceRow] = []

    # -- memory (byte ops; JoltDevice-mapped I/O, mmu.rs:286-489) ----------
    def load_byte(self, a: int) -> int:
        if self.device.is_input(a):
            return self.device.load(a)
        return self.memory.get(a, 0)

    def store_byte(self, a: int, v: int) -> None:
        if self.device.is_output(a) or self.device.is_panic(a):
            self.device.store(a, v)
        self.memory[a] = v & 0xFF

    def load(self, a: int, n: int) -> int:
        return sum(self.load_byte(a + k) << (8 * k) for k in range(n))

    def store(self, a: int, v: int, n: int) -> None:
        for k in range(n):
            self.store_byte(a + k, (v >> (8 * k)) & 0xFF)

    # -- execution ----------------------------------------------------------
    def run(self, max_steps: int = 1 << 20) -> list[RVTraceRow]:
        for _ in range(max_steps):
            prev_pc = self.pc
            self.step()
            if self.pc == prev_pc:  # PC repeat => termination (lib.rs:48-60)
                break
        return self.rows

    def step(self) -> None:
        instr = self.program.get(self.pc)
        if instr is None:
            raise RuntimeError(f"no instruction at PC {self.pc:#x}")
        op = instr.opcode
        rs1 = instr.rs1 or 0
        rs2 = instr.rs2 or 0
        rd = instr.rd or 0
        imm = _s32(instr.imm or 0)
        x1 = self.regs[rs1]
        x2 = self.regs[rs2]
        pc = self.pc
        next_pc = pc + 4
        rd_val = None
        mem_state = None
        advice = None

        if op in (RV32IM.ADD, RV32IM.ADDI):
            rd_val = _u32(x1 + (x2 if op == RV32IM.ADD else imm))
        elif op == RV32IM.SUB:
            rd_val = _u32(x1 - x2)
        elif op in (RV32IM.XOR, RV32IM.XORI):
            rd_val = x1 ^ (x2 if op == RV32IM.XOR else _u32(imm))
        elif op in (RV32IM.OR, RV32IM.ORI):
            rd_val = x1 | (x2 if op == RV32IM.OR else _u32(imm))
        elif op in (RV32IM.AND, RV32IM.ANDI):
            rd_val = x1 & (x2 if op == RV32IM.AND else _u32(imm))
        elif op in (RV32IM.SLL, RV32IM.SLLI):
            sh = (x2 if op == RV32IM.SLL else imm) % 32
            rd_val = _u32(x1 << sh)
        elif op in (RV32IM.SRL, RV32IM.SRLI):
            sh = (x2 if op == RV32IM.SRL else imm) % 32
            rd_val = x1 >> sh
        elif op in (RV32IM.SRA, RV32IM.SRAI):
            sh = (x2 if op == RV32IM.SRA else imm) % 32
            rd_val = _u32(_s32(x1) >> sh)
        elif op in (RV32IM.SLT, RV32IM.SLTI):
            rhs = _s32(x2) if op == RV32IM.SLT else imm
            rd_val = int(_s32(x1) < rhs)
        elif op in (RV32IM.SLTU, RV32IM.SLTIU):
            rhs = x2 if op == RV32IM.SLTU else _u32(imm)
            rd_val = int(x1 < rhs)
        elif op == RV32IM.LUI:
            rd_val = _u32(imm)
        elif op == RV32IM.AUIPC:
            rd_val = _u32(pc + imm)
        elif op == RV32IM.JAL:
            rd_val = _u32(pc + 4)
            next_pc = _u32(pc + imm)
        elif op == RV32IM.JALR:
            rd_val = _u32(pc + 4)
            next_pc = _u32(x1 + imm)
        elif op in (RV32IM.BEQ, RV32IM.BNE, RV32IM.BLT, RV32IM.BGE,
                    RV32IM.BLTU, RV32IM.BGEU):
            taken = {
                RV32IM.BEQ: x1 == x2, RV32IM.BNE: x1 != x2,
                RV32IM.BLT: _s32(x1) < _s32(x2),
                RV32IM.BGE: _s32(x1) >= _s32(x2),
                RV32IM.BLTU: x1 < x2, RV32IM.BGEU: x1 >= x2,
            }[op]
            if taken:
                next_pc = _u32(pc + imm)
        elif op in (RV32IM.LB, RV32IM.LBU, RV32IM.LH, RV32IM.LHU, RV32IM.LW):
            n = {RV32IM.LB: 1, RV32IM.LBU: 1, RV32IM.LH: 2, RV32IM.LHU: 2,
                 RV32IM.LW: 4}[op]
            a = _u32(x1 + imm)
            v = self.load(a, n)
            mem_state = MemoryState(False, a, v)
            if op == RV32IM.LB:
                rd_val = _u32(_s32(v | (0xFFFFFF00 if v & 0x80 else 0)))
            elif op == RV32IM.LH:
                rd_val = _u32(v | (0xFFFF0000 if v & 0x8000 else 0))
            else:
                rd_val = v
        elif op in (RV32IM.SB, RV32IM.SH, RV32IM.SW):
            n = {RV32IM.SB: 1, RV32IM.SH: 2, RV32IM.SW: 4}[op]
            a = _u32(x1 + imm)
            v = x2 & ((1 << (8 * n)) - 1)
            self.store(a, v, n)
            mem_state = MemoryState(True, a, v)
        elif op == RV32IM.MUL:
            rd_val = _u32(_s32(x1) * _s32(x2))
        elif op == RV32IM.MULU:
            rd_val = _u32(x1 * x2)
        elif op == RV32IM.MULHU:
            rd_val = (x1 * x2) >> 32
        elif op == RV32IM.MULH:
            rd_val = _u32((_s32(x1) * _s32(x2)) >> 32)
        elif op == RV32IM.MULHSU:
            rd_val = _u32((_s32(x1) * x2) >> 32)
        elif op in (RV32IM.DIV, RV32IM.REM):
            from ..vm.virtual_sequences import _signed_divmod
            q, r = _signed_divmod(x1, x2)
            rd_val = q if op == RV32IM.DIV else r
        elif op in (RV32IM.DIVU, RV32IM.REMU):
            from ..vm.virtual_sequences import _unsigned_divmod
            q, r = _unsigned_divmod(x1, x2)
            rd_val = q if op == RV32IM.DIVU else r
        elif op in (RV32IM.FENCE, RV32IM.ECALL, RV32IM.EBREAK):
            pass
        elif op == RV32IM.VIRTUAL_MOVE:
            rd_val = x1
        elif op == RV32IM.VIRTUAL_MOVSIGN:
            rd_val = 0xFFFFFFFF if x1 & (1 << 31) else 0
        else:
            raise NotImplementedError(f"emulator: {op}")

        fmt_uses_rs1 = instr.rs1 is not None
        fmt_uses_rs2 = instr.rs2 is not None
        reg_state = RegisterState(
            rs1_val=x1 if fmt_uses_rs1 else None,
            rs2_val=x2 if fmt_uses_rs2 else None,
            rd_post_val=None)
        if rd_val is not None and instr.rd is not None:
            if rd != 0:
                self.regs[rd] = rd_val
            reg_state.rd_post_val = self.regs[rd] if rd != 0 else 0
        elif instr.rd is not None:
            reg_state.rd_post_val = self.regs[rd] if rd != 0 else 0

        self.rows.append(RVTraceRow(instruction=instr,
                                    register_state=reg_state,
                                    memory_state=mem_state,
                                    advice_value=advice))
        self.pc = next_pc
