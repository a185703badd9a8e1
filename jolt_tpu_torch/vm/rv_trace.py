"""Shared trace IR: opcodes, circuit flags, instructions, device, layout.

Reference: common/src/rv_trace.rs + common/src/constants.rs.  These types are
the contract between the tracer (emulator) and the prover; all layout math
(register/IO/RAM witness indices, virtual registers, PC compression) must
match the reference exactly.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field

# --- constants (common/src/constants.rs) -----------------------------------
XLEN = 32
RISCV_REGISTER_COUNT = 32
VIRTUAL_REGISTER_COUNT = 32
REGISTER_COUNT = RISCV_REGISTER_COUNT + VIRTUAL_REGISTER_COUNT  # 64
BYTES_PER_INSTRUCTION = 4
REG_OPS_PER_INSTRUCTION = 3
RAM_OPS_PER_INSTRUCTION = 4
MEMORY_OPS_PER_INSTRUCTION = REG_OPS_PER_INSTRUCTION + RAM_OPS_PER_INSTRUCTION
RAM_START_ADDRESS = 0x80000000
DEFAULT_MEMORY_SIZE = 10 * 1024 * 1024
DEFAULT_STACK_SIZE = 4096
DEFAULT_MAX_INPUT_SIZE = 4096
DEFAULT_MAX_OUTPUT_SIZE = 4096


def virtual_register_index(index: int) -> int:
    return index + VIRTUAL_REGISTER_COUNT


def memory_address_to_witness_index(address: int, ram_witness_offset: int) -> int:
    return address + ram_witness_offset - RAM_START_ADDRESS


class RV32IM(enum.Enum):
    ADD = enum.auto(); SUB = enum.auto(); XOR = enum.auto(); OR = enum.auto()
    AND = enum.auto(); SLL = enum.auto(); SRL = enum.auto(); SRA = enum.auto()
    SLT = enum.auto(); SLTU = enum.auto(); ADDI = enum.auto(); XORI = enum.auto()
    ORI = enum.auto(); ANDI = enum.auto(); SLLI = enum.auto(); SRLI = enum.auto()
    SRAI = enum.auto(); SLTI = enum.auto(); SLTIU = enum.auto(); LB = enum.auto()
    LH = enum.auto(); LW = enum.auto(); LBU = enum.auto(); LHU = enum.auto()
    SB = enum.auto(); SH = enum.auto(); SW = enum.auto(); BEQ = enum.auto()
    BNE = enum.auto(); BLT = enum.auto(); BGE = enum.auto(); BLTU = enum.auto()
    BGEU = enum.auto(); JAL = enum.auto(); JALR = enum.auto(); LUI = enum.auto()
    AUIPC = enum.auto(); ECALL = enum.auto(); EBREAK = enum.auto()
    MUL = enum.auto(); MULH = enum.auto(); MULHU = enum.auto()
    MULHSU = enum.auto(); MULU = enum.auto(); DIV = enum.auto()
    DIVU = enum.auto(); REM = enum.auto(); REMU = enum.auto()
    FENCE = enum.auto(); UNIMPL = enum.auto()
    VIRTUAL_MOVSIGN = enum.auto(); VIRTUAL_MOVE = enum.auto()
    VIRTUAL_ADVICE = enum.auto(); VIRTUAL_ASSERT_LTE = enum.auto()
    VIRTUAL_ASSERT_VALID_UNSIGNED_REMAINDER = enum.auto()
    VIRTUAL_ASSERT_VALID_SIGNED_REMAINDER = enum.auto()
    VIRTUAL_ASSERT_EQ = enum.auto()
    VIRTUAL_ASSERT_VALID_DIV0 = enum.auto()


_LOADS = {RV32IM.LB, RV32IM.LH, RV32IM.LW, RV32IM.LBU, RV32IM.LHU}
_STORES = {RV32IM.SB, RV32IM.SH, RV32IM.SW}
_BRANCHES = {RV32IM.BEQ, RV32IM.BNE, RV32IM.BLT, RV32IM.BGE, RV32IM.BLTU,
             RV32IM.BGEU}
_JUMPS = {RV32IM.JAL, RV32IM.JALR}
_ASSERTS = {RV32IM.VIRTUAL_ASSERT_EQ, RV32IM.VIRTUAL_ASSERT_LTE,
            RV32IM.VIRTUAL_ASSERT_VALID_DIV0,
            RV32IM.VIRTUAL_ASSERT_VALID_SIGNED_REMAINDER,
            RV32IM.VIRTUAL_ASSERT_VALID_UNSIGNED_REMAINDER}
_CONCAT = {RV32IM.XOR, RV32IM.XORI, RV32IM.OR, RV32IM.ORI, RV32IM.AND,
           RV32IM.ANDI, RV32IM.SLL, RV32IM.SRL, RV32IM.SRA, RV32IM.SLLI,
           RV32IM.SRLI, RV32IM.SRAI, RV32IM.SLT, RV32IM.SLTU, RV32IM.SLTI,
           RV32IM.SLTIU} | _BRANCHES | (_ASSERTS - {RV32IM.VIRTUAL_ASSERT_EQ}) \
           | {RV32IM.VIRTUAL_ASSERT_EQ}


class CircuitFlags(enum.IntEnum):
    """12 R1CS circuit flags, in bit-pack order (rv_trace.rs:240-267)."""
    LeftOperandIsPC = 0
    RightOperandIsImm = 1
    Load = 2
    Store = 3
    Jump = 4
    Branch = 5
    WriteLookupOutputToRD = 6
    ImmSignBit = 7
    ConcatLookupQueryChunks = 8
    Virtual = 9
    Assert = 10
    DoNotUpdatePC = 11


NUM_CIRCUIT_FLAGS = len(CircuitFlags)


@dataclass
class ELFInstruction:
    address: int
    opcode: RV32IM
    rs1: int | None = None
    rs2: int | None = None
    rd: int | None = None
    imm: int | None = None  # signed 32-bit representation as i64
    virtual_sequence_remaining: int | None = None

    def to_circuit_flags(self) -> list[bool]:
        op = self.opcode
        flags = [False] * NUM_CIRCUIT_FLAGS
        flags[CircuitFlags.LeftOperandIsPC] = op in (RV32IM.JAL, RV32IM.LUI,
                                                     RV32IM.AUIPC)
        flags[CircuitFlags.RightOperandIsImm] = op in (
            RV32IM.ADDI, RV32IM.XORI, RV32IM.ORI, RV32IM.ANDI, RV32IM.SLLI,
            RV32IM.SRLI, RV32IM.SRAI, RV32IM.SLTI, RV32IM.SLTIU, RV32IM.AUIPC,
            RV32IM.JAL, RV32IM.JALR)
        flags[CircuitFlags.Load] = op in _LOADS
        flags[CircuitFlags.Store] = op in _STORES
        flags[CircuitFlags.Jump] = op in _JUMPS
        flags[CircuitFlags.Branch] = op in _BRANCHES
        flags[CircuitFlags.WriteLookupOutputToRD] = op not in (
            _STORES | _BRANCHES | _JUMPS | {RV32IM.LUI} | _ASSERTS)
        mask = 1 << 31
        flags[CircuitFlags.ImmSignBit] = (self.imm is not None
                                          and (self.imm & mask) == mask)
        flags[CircuitFlags.ConcatLookupQueryChunks] = op in _CONCAT
        flags[CircuitFlags.Virtual] = self.virtual_sequence_remaining is not None
        flags[CircuitFlags.Assert] = op in _ASSERTS
        flags[CircuitFlags.DoNotUpdatePC] = (
            self.virtual_sequence_remaining is not None
            and self.virtual_sequence_remaining != 0)
        return flags


@dataclass
class RegisterState:
    rs1_val: int | None = None
    rs2_val: int | None = None
    rd_post_val: int | None = None


@dataclass
class MemoryState:
    """Read {address, value} or Write {address, post_value}."""
    is_write: bool
    address: int
    value: int


@dataclass
class RVTraceRow:
    instruction: ELFInstruction
    register_state: RegisterState
    memory_state: MemoryState | None = None
    advice_value: int | None = None


@dataclass
class MemoryLayout:
    """Witness layout: registers || inputs || outputs || panic || pad || RAM
    (rv_trace.rs:706-754)."""
    max_input_size: int
    max_output_size: int

    def __post_init__(self):
        total = REGISTER_COUNT + self.max_input_size + self.max_output_size + 1
        self.ram_witness_offset = 1 << (total - 1).bit_length()
        self.input_start = (RAM_START_ADDRESS - self.ram_witness_offset
                            + REGISTER_COUNT)
        self.input_end = self.input_start + self.max_input_size
        self.output_start = self.input_end + 1
        self.output_end = self.output_start + self.max_output_size
        self.panic = self.output_end + 1


@dataclass
class JoltDevice:
    """Memory-mapped guest I/O (rv_trace.rs:637-704)."""
    memory_layout: MemoryLayout
    inputs: bytearray = field(default_factory=bytearray)
    outputs: bytearray = field(default_factory=bytearray)
    panic: bool = False

    @staticmethod
    def new(max_input_size: int = DEFAULT_MAX_INPUT_SIZE,
            max_output_size: int = DEFAULT_MAX_OUTPUT_SIZE) -> "JoltDevice":
        return JoltDevice(MemoryLayout(max_input_size, max_output_size))

    def load(self, address: int) -> int:
        internal = address - self.memory_layout.input_start
        if internal >= len(self.inputs) or internal < 0:
            return 0
        return self.inputs[internal]

    def store(self, address: int, value: int) -> None:
        if address == self.memory_layout.panic:
            self.panic = True
            return
        internal = address - self.memory_layout.output_start
        if len(self.outputs) <= internal:
            self.outputs.extend(b"\x00" * (internal + 1 - len(self.outputs)))
        self.outputs[internal] = value & 0xFF

    def is_input(self, address: int) -> bool:
        return (self.memory_layout.input_start <= address
                < self.memory_layout.input_end)

    def is_output(self, address: int) -> bool:
        return (self.memory_layout.output_start <= address
                < self.memory_layout.panic)

    def is_panic(self, address: int) -> bool:
        return address == self.memory_layout.panic
