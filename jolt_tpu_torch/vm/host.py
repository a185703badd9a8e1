"""Host-side program construction: mini-assembler + tracing.

Reference: jolt-core/src/host/mod.rs builds guests with cargo + a RISC-V
toolchain; here programs are constructed directly as ELFInstruction lists
(a mini-assembler).  The trace path mirrors host/mod.rs:178-214: run the
emulator, expand M-extension rows into their virtual sequences, convert
rows to JoltTraceSteps.  The emulator is the port's C++ tracer
(native/tracer.cpp); the Python one (tracer/emulator.py) is its oracle.
"""
from __future__ import annotations

from ..native import trace_native
from ..tracer.emulator import Emulator
from .bytecode import BytecodeRow
from .rv_trace import (DEFAULT_MAX_INPUT_SIZE, DEFAULT_MAX_OUTPUT_SIZE,
                       RAM_START_ADDRESS, ELFInstruction, JoltDevice, RV32IM)
from .trace import LOOKUP_MAP, JoltTraceStep, trace_row_to_step
from .virtual_sequences import expand_bytecode, expand_m_extension


class Assembler:
    """Builds ELFInstruction programs at RAM_START_ADDRESS."""

    def __init__(self, base: int = RAM_START_ADDRESS):
        self.base = base
        self.instructions: list[ELFInstruction] = []
        self.labels: dict[str, int] = {}
        self.fixups: list[tuple[int, str]] = []  # (instr index, label)

    def _pc(self) -> int:
        return self.base + 4 * len(self.instructions)

    def label(self, name: str) -> None:
        self.labels[name] = self._pc()

    def emit(self, opcode: RV32IM, rd=None, rs1=None, rs2=None, imm=None,
             label: str | None = None) -> None:
        self.instructions.append(ELFInstruction(
            address=self._pc(), opcode=opcode, rd=rd, rs1=rs1, rs2=rs2,
            imm=imm))
        if label is not None:
            self.fixups.append((len(self.instructions) - 1, label))

    # convenience mnemonics
    def addi(self, rd, rs1, imm):
        self.emit(RV32IM.ADDI, rd=rd, rs1=rs1, imm=imm & 0xFFFFFFFF)

    def add(self, rd, rs1, rs2):
        self.emit(RV32IM.ADD, rd=rd, rs1=rs1, rs2=rs2)

    def bne(self, rs1, rs2, label):
        self.emit(RV32IM.BNE, rs1=rs1, rs2=rs2, label=label)

    def beq(self, rs1, rs2, label):
        self.emit(RV32IM.BEQ, rs1=rs1, rs2=rs2, label=label)

    def jal(self, rd, label):
        self.emit(RV32IM.JAL, rd=rd, label=label)

    def sw(self, rs1, rs2, imm):
        self.emit(RV32IM.SW, rs1=rs1, rs2=rs2, imm=imm & 0xFFFFFFFF)

    def lw(self, rd, rs1, imm):
        self.emit(RV32IM.LW, rd=rd, rs1=rs1, imm=imm & 0xFFFFFFFF)

    def finish(self) -> list[ELFInstruction]:
        for idx, label in self.fixups:
            target = self.labels[label]
            offset = target - self.instructions[idx].address
            self.instructions[idx].imm = offset & 0xFFFFFFFF
        return self.instructions


def fibonacci_program(n: int) -> list[ELFInstruction]:
    """fib(n) via an add/bne loop; result left in x2."""
    asm = Assembler()
    asm.addi(2, 0, 0)   # a = 0
    asm.addi(3, 0, 1)   # b = 1
    asm.addi(1, 0, 0)   # i = 0
    asm.addi(4, 0, n)   # n
    asm.label("loop")
    asm.add(5, 2, 3)    # t = a + b
    asm.add(2, 3, 0)    # a = b
    asm.add(3, 5, 0)    # b = t
    asm.addi(1, 1, 1)   # i += 1
    asm.bne(1, 4, "loop")
    asm.label("halt")
    asm.jal(0, "halt")  # self-loop => PC repeat => trace termination
    return asm.finish()


def trace_program(program: list[ELFInstruction], vm,
                  inputs: bytes = b"",
                  max_input_size: int = DEFAULT_MAX_INPUT_SIZE,
                  max_output_size: int = DEFAULT_MAX_OUTPUT_SIZE,
                  native: bool = True,
                  ) -> tuple[list[JoltTraceStep], JoltDevice, list[BytecodeRow]]:
    """Run the emulator and convert rows to prover trace steps
    (host/mod.rs:178-214).  Returns (steps, program I/O, bytecode rows).
    `native` runs the C++ tracer (a failed build or trace raises);
    `native=False` the Python emulator."""
    device = JoltDevice.new(max_input_size, max_output_size)
    device.inputs.extend(inputs)
    raw_rows = trace_native(program, device) if native \
        else Emulator(program, device).run()
    steps, bytecode_rows = rows_to_steps(program, raw_rows, vm)
    return steps, device, bytecode_rows


def rows_to_steps(program: list[ELFInstruction], raw_rows, vm
                  ) -> tuple[list[JoltTraceStep], list[BytecodeRow]]:
    """The emulator's rows -> (prover trace steps, bytecode rows)."""
    # M-extension rows expand into virtual sequences (host/mod.rs:185-195)
    rows = [r for raw in raw_rows for r in expand_m_extension(raw)]
    ni = len(vm.instruction_classes)
    steps = [trace_row_to_step(r, vm.name_to_index, ni) for r in rows]
    bytecode_rows = [
        BytecodeRow.from_instruction(
            i, vm.name_to_index.get(_lookup_name(i)), ni)
        for i in expand_bytecode(program)]
    return steps, bytecode_rows


def _lookup_name(instr: ELFInstruction):
    entry = LOOKUP_MAP.get(instr.opcode)
    return entry[0] if entry else None
