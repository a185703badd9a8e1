"""The frozen reference proofs in `fixtures/port/`: their cases, the
programs they prove, and the array format a proof is kept in.

scripts/freeze_port_fixtures.py proves each case with jolt_tpu and writes
`fixtures/port/<case>.npz`; the port's tests and chip_smoke.py prove the
same case with the port and compare `proof_arrays` of it with the file.
The functions here take any package's transcript and commitments (they
read `state_history`, `.point` and `.evals` only), and the program builders
any package's assembler and opcode enum (the port's by default), so both
sides build the same arrays from the same programs.

Each fib3 file holds the transcript's `state_history` (uint8 [events + 1,
32]); the others hold its first 8 bytes per state (uint8 [events + 1, 8])
and the last state whole (uint8 [32]).  Each holds the read/write and
init/final commitments in transcript byte order: HyperKZG points as
x || y big-endian (uint8 [k, 64], zeros at infinity); mock commitments
(which the transcript never sees) as their evaluations (uint8 [sum of
lengths, 32] big-endian, with int64 lengths [k]) for the fib3 cases, and as
the SHA-256 of those bytes (uint8 [k, 32], with the lengths) for the
others, whose init/final columns hold 2^16 evaluations each.  The HyperKZG
case at full width keeps the SHA-256 of each point's 64 bytes (uint8
[k, 32]) and the SHA-256 and length of the proof's arkworks bytes
(`ark_sha256` uint8 [32], `ark_len` int64).
"""
from __future__ import annotations

import hashlib

import numpy as np

from .guests import (SHA2_INPUT, _Asm, multi_function_program,
                     sha2_chain_program)
from .host import fibonacci_program
from .rv_trace import (DEFAULT_MAX_INPUT_SIZE, DEFAULT_MAX_OUTPUT_SIZE,
                       RAM_START_ADDRESS, RV32IM, MemoryLayout)

FIB_N = 3              # the fib3 cases: fibonacci(3) on the mini VM
M_MINI = 1 << 8
SRS_LEN = 1 << 8
RV32I_FIB_N = 8
MULTIFN_N = 4          # multi_function(4): JAL calls and JALR returns
# The rv32i_vm() cases (C = 4, M = 2^16, the mock PCS), each proved and
# verified by jolt_tpu.
RV32I_CASES = ("rv32i_fib8_mock", "rv32i_muldiv_mock", "rv32i_loadstore_mock",
               "rv32i_sha2_1_mock", "rv32i_multifn4_mock")
# The same at full width with HyperKZG over the 2^16-point SRS fixture
# (seed 0x6A6F6C74); its file adds the SHA-256 and length of the proof's
# arkworks bytes (`ark_sha256`, `ark_len`).
RV32I_HYPERKZG_CASES = ("rv32i_loadstore_hyperkzg",)
# The RV32I instructions whose subtables need M = 2^16 (jolt_tpu asserts it
# in `subtables(C, M)`); the narrow VM carries the other 23.
WIDE_ONLY = ("lh", "sh", "sw", "virtual_movsign", "mulhu", "virtual_move")
# loadstore_program's 32 input bytes: the top bit set in every other byte,
# so signed loads sign-extend.
LOADSTORE_INPUT = bytes((0x80 + 37 * i) & 0xFF for i in range(32))


def narrow_instructions(rv32i_instructions) -> list:
    return [c for c in rv32i_instructions if c.name not in WIDE_ONLY]


def narrow_program(asm_cls=_Asm, ops=RV32IM) -> list:
    """A short program over the narrow VM's instructions, with operands
    where each lookup equals its native result at M = 2^8: the
    operand-concatenating lookups see 16-bit operands, so every operand
    stays below 2^15 (positive at that width too), and no ADD or SUB
    carries out of 32 bits (SUB's x + 2^32 - y always does, so SUB stays
    out).  Loads and stores stay out too: the VM fills the RAM columns only
    when it has all five load/store instructions (`loadstore_program` runs
    them on rv32i_vm()).  The M-extension sequences write x0, since their
    last step, VIRTUAL_MOVE, has no lookup in this VM."""
    asm = asm_cls()
    asm.addi(1, 0, 1234)
    asm.addi(2, 0, 567)
    asm.addi(10, 0, 3)
    asm.add(3, 1, 2)
    asm.and_(5, 1, 2)
    asm.or_(6, 1, 2)
    asm.xor(7, 1, 2)
    asm.emit(ops.XORI, rd=21, rs1=1, imm=0x5A)
    asm.emit(ops.SLT, rd=8, rs1=2, rs2=1)
    asm.emit(ops.SLTU, rd=9, rs1=1, rs2=2)
    asm.emit(ops.SLL, rd=11, rs1=1, rs2=10)
    asm.emit(ops.SRL, rd=12, rs1=1, rs2=10)
    asm.emit(ops.SRA, rd=13, rs1=1, rs2=10)
    asm.emit(ops.MUL, rd=14, rs1=1, rs2=10)
    asm.addi(17, 0, 0)
    asm.addi(18, 0, 2)
    asm.label("loop")
    asm.addi(17, 17, 1)
    asm.emit(ops.BGE, rs1=2, rs2=1, label="skip")
    asm.emit(ops.BGEU, rs1=1, rs2=2, label="next")
    asm.label("skip")
    asm.addi(19, 19, 1)
    asm.label("next")
    asm.beq(17, 18, "done")
    asm.bne(17, 18, "loop")
    asm.label("done")
    for op in (ops.DIVU, ops.REMU, ops.DIV, ops.REM):
        asm.emit(op, rd=0, rs1=1, rs2=2)
    asm.label("halt")
    asm.jal(0, "halt")
    return asm.finish()


def muldiv_mix_program(asm_cls=_Asm, ops=RV32IM) -> list:
    """jolt_tpu's tests/test_rv32i_e2e.py M-extension program: MUL, DIVU,
    REMU, DIV, REM and MULH, each DIV/REM/MULH expanding into its virtual
    sequence."""
    asm = asm_cls()
    asm.addi(1, 0, 123)
    asm.addi(2, 0, 45)
    asm.addi(3, 0, 7)
    asm.emit(ops.MUL, rd=4, rs1=1, rs2=2)
    asm.emit(ops.DIVU, rd=5, rs1=4, rs2=3)
    asm.emit(ops.REMU, rd=6, rs1=4, rs2=3)
    asm.emit(ops.DIV, rd=7, rs1=4, rs2=3)
    asm.emit(ops.REM, rd=8, rs1=4, rs2=3)
    asm.emit(ops.MULH, rd=9, rs1=4, rs2=2)
    asm.label("halt")
    asm.jal(0, "halt")
    return asm.finish()


def loadstore_program(asm_cls=_Asm, ops=RV32IM) -> list:
    """Every load and store width over the input region, RAM and the
    output region: LW, LH, LHU, LB and LBU of the 32 input bytes
    (LOADSTORE_INPUT), SW, SH and SB of them and of a LUI constant into
    RAM, byte and halfword stores over a stored word, loads back at every
    width (one through a negative offset), and SW, SH and SB of the
    results into the output region.  `loadstore_expected` gives the
    output."""
    ml = MemoryLayout(DEFAULT_MAX_INPUT_SIZE, DEFAULT_MAX_OUTPUT_SIZE)
    data = RAM_START_ADDRESS + 0x1000
    asm = asm_cls()

    def load(op, rd, rs1, imm):
        asm.emit(op, rd=rd, rs1=rs1, imm=imm & 0xFFFFFFFF)

    def store(op, rs1, rs2, imm):
        asm.emit(op, rs1=rs1, rs2=rs2, imm=imm & 0xFFFFFFFF)

    asm.li(5, ml.input_start)
    asm.li(6, ml.output_start)
    asm.emit(ops.LUI, rd=7, imm=data)                 # RAM base
    asm.emit(ops.LUI, rd=13, imm=0xDEADB000)
    asm.addi(13, 13, 0x7EF)                           # x13 = 0xDEADB7EF
    load(ops.LW, 8, 5, 0)
    load(ops.LH, 9, 5, 4)
    load(ops.LHU, 10, 5, 6)
    load(ops.LB, 11, 5, 8)
    load(ops.LBU, 12, 5, 9)
    store(ops.SW, 7, 8, 0)
    store(ops.SH, 7, 9, 4)
    store(ops.SH, 7, 10, 6)
    store(ops.SB, 7, 11, 8)
    store(ops.SB, 7, 12, 9)
    store(ops.SB, 7, 11, 11)
    store(ops.SW, 7, 13, 12)
    store(ops.SH, 7, 13, 16)
    store(ops.SB, 7, 13, 19)
    store(ops.SB, 7, 12, 1)                           # over the stored word
    store(ops.SH, 7, 9, 14)
    load(ops.LW, 14, 7, 0)
    load(ops.LH, 15, 7, 12)
    load(ops.LHU, 16, 7, 14)
    load(ops.LB, 17, 7, 13)
    load(ops.LBU, 18, 7, 15)
    load(ops.LW, 19, 7, 8)
    asm.addi(21, 7, 20)
    load(ops.LH, 20, 21, -4)
    load(ops.LW, 22, 7, 4)
    store(ops.SW, 6, 14, 0)
    store(ops.SW, 6, 15, 4)
    store(ops.SH, 6, 16, 8)
    store(ops.SB, 6, 17, 10)
    store(ops.SB, 6, 18, 11)
    store(ops.SW, 6, 19, 12)
    store(ops.SW, 6, 20, 16)
    store(ops.SW, 6, 22, 20)
    load(ops.LW, 23, 5, 28)
    store(ops.SW, 6, 23, 24)
    asm.label("halt")
    asm.jal(0, "halt")
    return asm.finish()


def loadstore_expected(inputs: bytes = LOADSTORE_INPUT) -> bytes:
    """Host oracle: the 28 output bytes `loadstore_program` writes."""
    def u(b: bytes) -> int:
        return int.from_bytes(b, "little")

    def sext(v: int, bits: int) -> int:
        return (v - (1 << bits) if v >> (bits - 1) else v) & 0xFFFFFFFF

    ram = bytearray(20)
    x8, x9, x10 = u(inputs[0:4]), sext(u(inputs[4:6]), 16), u(inputs[6:8])
    x11, x12, x13 = sext(inputs[8], 8), inputs[9], 0xDEADB7EF
    ram[0:4] = x8.to_bytes(4, "little")
    ram[4:6] = (x9 & 0xFFFF).to_bytes(2, "little")
    ram[6:8] = x10.to_bytes(2, "little")
    ram[8], ram[9], ram[11] = x11 & 0xFF, x12, x11 & 0xFF
    ram[12:16] = x13.to_bytes(4, "little")
    ram[16:18] = (x13 & 0xFFFF).to_bytes(2, "little")
    ram[19] = x13 & 0xFF
    ram[1] = x12
    ram[14:16] = (x9 & 0xFFFF).to_bytes(2, "little")
    words = [u(ram[0:4]), sext(u(ram[12:14]), 16)]
    out = b"".join(w.to_bytes(4, "little") for w in words)
    out += ram[14:16] + bytes([ram[13], ram[15]]) + ram[8:12]
    out += sext(u(ram[16:18]), 16).to_bytes(4, "little")
    out += ram[4:8] + inputs[28:32]
    return out


def case_program(case: str, asm_cls=_Asm, ops=RV32IM, fib=fibonacci_program,
                 sha2=sha2_chain_program, multifn=multi_function_program
                 ) -> tuple[list, bytes]:
    """(program, inputs) of `narrow_mock` or one of RV32I_CASES and
    RV32I_HYPERKZG_CASES, built with
    the given package's assembler, opcodes and guests (the port's by
    default)."""
    if case == "narrow_mock":
        return narrow_program(asm_cls, ops), b""
    if case == "rv32i_fib8_mock":
        return fib(RV32I_FIB_N), b""
    if case == "rv32i_muldiv_mock":
        return muldiv_mix_program(asm_cls, ops), b""
    if case in ("rv32i_loadstore_mock", "rv32i_loadstore_hyperkzg"):
        return loadstore_program(asm_cls, ops), LOADSTORE_INPUT
    if case == "rv32i_sha2_1_mock":
        return sha2(1), SHA2_INPUT
    if case == "rv32i_multifn4_mock":
        return multifn(MULTIFN_N), b""
    raise ValueError(f"unknown case {case}")


def history_array(state_history) -> np.ndarray:
    return np.frombuffer(b"".join(state_history), dtype=np.uint8).reshape(
        len(state_history), 32)


def commitment_arrays(prefix: str, commitments, digest: bool = False
                      ) -> dict:
    """HyperKZG points (objects with .point) or mock evaluations (.evals)
    -> arrays, keyed `<prefix>_points`, `<prefix>_evals`/`_lens`, or with
    `digest` `<prefix>_digests` (SHA-256 of each point's 64 bytes) or
    `<prefix>_digests`/`_lens` (SHA-256 of each commitment's evaluation
    bytes)."""
    if hasattr(commitments[0], "point"):
        rows = [b"\x00" * 64 if c.point.is_infinity else
                int(c.point.x).to_bytes(32, "big")
                + int(c.point.y).to_bytes(32, "big") for c in commitments]
        if digest:
            rows = [hashlib.sha256(r).digest() for r in rows]
            return {f"{prefix}_digests": np.frombuffer(
                b"".join(rows), dtype=np.uint8).reshape(len(rows), 32)}
        return {f"{prefix}_points": np.frombuffer(
            b"".join(rows), dtype=np.uint8).reshape(len(rows), 64)}
    lens = np.array([len(c.evals) for c in commitments], dtype=np.int64)
    if digest:
        rows = [hashlib.sha256(b"".join(int(e.v).to_bytes(32, "big")
                                        for e in c.evals)).digest()
                for c in commitments]
        return {f"{prefix}_digests": np.frombuffer(
                    b"".join(rows), dtype=np.uint8).reshape(len(rows), 32),
                f"{prefix}_lens": lens}
    flat = b"".join(int(e.v).to_bytes(32, "big")
                    for c in commitments for e in c.evals)
    return {f"{prefix}_evals": np.frombuffer(flat, dtype=np.uint8).reshape(
                -1, 32), f"{prefix}_lens": lens}


def proof_arrays(transcript, commitments, digest: bool = False,
                 ark: bytes | None = None) -> dict:
    """The transcript and commitments as arrays; with `digest`, the
    transcript as the first 8 bytes of each state (where two runs part)
    and the whole last state (which binds every event before it); with
    `ark`, the SHA-256 and length of those proof bytes."""
    hist = history_array(transcript.state_history)
    out = {"state_prefixes": hist[:, :8].copy(), "final_state": hist[-1]} \
        if digest else {"state_history": hist}
    out.update(commitment_arrays("rw", commitments["read_write"], digest))
    out.update(commitment_arrays("if", commitments["init_final"], digest))
    if ark is not None:
        out["ark_sha256"] = np.frombuffer(hashlib.sha256(ark).digest(),
                                          dtype=np.uint8)
        out["ark_len"] = np.array(len(ark), dtype=np.int64)
    return out


def differing(got: dict, want: dict) -> list[str]:
    """The keys where two proofs' arrays differ (or one lacks them)."""
    return sorted(k for k in set(got) | set(want)
                  if k not in got or k not in want
                  or got[k].shape != want[k].shape
                  or not (got[k] == want[k]).all())
