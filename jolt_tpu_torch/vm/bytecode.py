"""Bytecode memory checking: the read-only "decode" stage.

Reference: jolt-core/src/jolt/vm/bytecode.rs (jolt_tpu/vm/bytecode.py).
Each trace step reads one row of the preprocessed bytecode; offline memory
checking proves every read matches the committed program.  Fingerprints
are 8-tuples [virtual_address, elf_address, bitflags, rd, rs1, rs2, imm, t]
combined with gamma powers (bytecode.rs:472-492).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..field import device as fd
from ..field.host import FElt
from ..field.spec import FieldSpec, fr_spec
from ..lasso.memory_checking import MemoryCheckingProver
from ..lasso.surge import cumcount
from ..utils.math import next_power_of_two
from .rv_trace import BYTES_PER_INSTRUCTION, RAM_START_ADDRESS, ELFInstruction


@dataclass
class BytecodeRow:
    address: int
    bitflags: int
    rd: int
    rs1: int
    rs2: int
    imm: int
    virtual_sequence_remaining: int | None = None

    @staticmethod
    def no_op(address: int) -> "BytecodeRow":
        return BytecodeRow(address, 0, 0, 0, 0, 0)

    @staticmethod
    def pack_bitflags(instruction: ELFInstruction, instruction_index,
                      num_instructions: int) -> int:
        """circuit flags || one-hot instruction flag (bytecode.rs:162-184)."""
        bits = 0
        for flag in instruction.to_circuit_flags():
            bits |= int(flag)
            bits <<= 1
        if instruction_index is not None:
            bits <<= instruction_index
            bits |= 1
            bits <<= num_instructions - instruction_index - 1
        else:
            bits <<= num_instructions - 1
        return bits

    @staticmethod
    def from_instruction(instruction: ELFInstruction, instruction_index,
                         num_instructions: int) -> "BytecodeRow":
        imm = instruction.imm if instruction.imm is not None else 0
        return BytecodeRow(
            address=instruction.address,
            bitflags=BytecodeRow.pack_bitflags(instruction, instruction_index,
                                               num_instructions),
            rd=instruction.rd or 0,
            rs1=instruction.rs1 or 0,
            rs2=instruction.rs2 or 0,
            imm=imm & 0xFFFFFFFF,
            virtual_sequence_remaining=instruction.virtual_sequence_remaining,
        )


def _compress_address(address: int) -> int:
    """ELF address -> 1-based instruction index (0 stays the no-op)."""
    if address == 0:
        return 0
    assert address >= RAM_START_ADDRESS
    assert address % BYTES_PER_INSTRUCTION == 0
    return 1 + (address - RAM_START_ADDRESS) // BYTES_PER_INSTRUCTION


class BytecodePreprocessing:
    """Address compression + committed init/final values
    (bytecode.rs:230-291), on `device`."""

    def __init__(self, bytecode: list[BytecodeRow], device,
                 spec: FieldSpec | None = None):
        self.spec = spec or fr_spec()
        self.device = device
        bytecode = [BytecodeRow(**vars(r)) for r in bytecode]  # copy
        self.virtual_address_map: dict[tuple[int, int], int] = {}
        virtual_address = 1  # no-op prepended at 0
        for row in bytecode:
            assert row.address >= RAM_START_ADDRESS
            row.address = _compress_address(row.address)
            key = (row.address, row.virtual_sequence_remaining or 0)
            assert key not in self.virtual_address_map
            self.virtual_address_map[key] = virtual_address
            virtual_address += 1

        bytecode.insert(0, BytecodeRow.no_op(0))
        self.virtual_address_map[(0, 0)] = 0
        self.code_size = next_power_of_two(len(bytecode))
        while len(bytecode) < self.code_size:
            bytecode.append(BytecodeRow.no_op(0))
        self.bytecode = bytecode

        vals = np.array(
            [[r.address for r in bytecode], [r.bitflags for r in bytecode],
             [r.rd for r in bytecode], [r.rs1 for r in bytecode],
             [r.rs2 for r in bytecode], [r.imm for r in bytecode]],
            dtype=np.uint64)
        self.v_init_final_host = vals  # [6, K]
        self.v_init_final = fd.u64_to_mont_device(self.spec, vals, device)


@dataclass
class BytecodePolynomials:
    a_read_write: torch.Tensor  # [16, T]
    v_read_write: torch.Tensor  # [16, 6, T]
    t_read: torch.Tensor        # [16, T]
    t_final: torch.Tensor       # [16, K]

    def read_write_values(self):
        return ([self.a_read_write]
                + [fd.col(self.v_read_write, i) for i in range(6)]
                + [self.t_read])

    def init_final_values(self):
        return [self.t_final]


def generate_witness(pre: BytecodePreprocessing,
                     trace_rows: list[BytecodeRow], T: int
                     ) -> BytecodePolynomials:
    """Bytecode witness (bytecode.rs:295-440).

    trace_rows: the per-step bytecode rows with uncompressed ELF addresses
    (address 0 = padding no-op); T = padded power-of-two trace length.
    Padding steps read virtual address 0, whose row is the no-op."""
    a = np.zeros(T, dtype=np.int64)
    v = np.zeros((6, T), dtype=np.uint64)
    for j, row in enumerate(trace_rows):
        addr = _compress_address(row.address)
        a[j] = pre.virtual_address_map[(addr, row.virtual_sequence_remaining
                                        or 0)]
        v[:, j] = (addr, row.bitflags, row.rd, row.rs1, row.rs2, row.imm)

    t_read, t_final = cumcount(a, pre.code_size)

    spec, dev = pre.spec, pre.device
    return BytecodePolynomials(
        a_read_write=fd.u64_to_mont_device(spec, a.astype(np.uint64), dev),
        v_read_write=fd.u64_to_mont_device(spec, v, dev),
        t_read=fd.u64_to_mont_device(spec, t_read, dev),
        t_final=fd.u64_to_mont_device(spec, t_final, dev),
    )


def _scalar(x: torch.Tensor, ndim: int) -> torch.Tensor:
    """A limb vector [16] as [16, 1, ...] for broadcasting over ndim dims."""
    return x.reshape((fd.L,) + (1,) * ndim)


def _bytecode_rw_leaves(spec: FieldSpec, a, v, t, gamma_powers, tau):
    """Read/write fingerprint leaves [16, 2, T]; tuple order
    [a, v0..v5, t] with gamma powers (bytecode.rs:496-592)."""
    acc = fd.fsub(spec, a, _scalar(tau, 1))
    for i in range(6):
        acc = fd.fadd(spec, acc, fd.fmul(spec, v[:, i],
                                         _scalar(gamma_powers[:, i + 1], 1)))
    g7 = _scalar(gamma_powers[:, 7], 1)
    read = fd.fadd(spec, acc, fd.fmul(spec, t, g7))
    write = fd.fadd(spec, read, g7)
    return torch.stack([read, write], dim=1)


def _bytecode_if_leaves(spec: FieldSpec, v_init_final, t_final, identity,
                        gamma_powers, tau):
    """Init/final leaves [16, 2, K]."""
    acc = fd.fsub(spec, identity, _scalar(tau, 1))
    for i in range(6):
        acc = fd.fadd(spec, acc, fd.fmul(spec, v_init_final[:, i],
                                         _scalar(gamma_powers[:, i + 1], 1)))
    final = fd.fadd(spec, acc, fd.fmul(spec, t_final,
                                       _scalar(gamma_powers[:, 7], 1)))
    return torch.stack([acc, final], dim=1)


class BytecodeMemoryChecking(MemoryCheckingProver):
    def __init__(self, pre: BytecodePreprocessing):
        self.pre = pre
        self.spec = pre.spec

    def protocol_name(self) -> bytes:
        return b"Bytecode memory checking"

    def compute_leaves(self, polynomials: BytecodePolynomials, gamma: FElt,
                       tau: FElt):
        spec, dev = self.spec, self.pre.device
        powers = [FElt(1, spec)]
        for _ in range(7):
            powers.append(powers[-1] * gamma)
        gp = fd.ints_to_device(spec, [p.v for p in powers], dev)   # [16, 8]
        tau_dev = fd.scalar_to_device(spec, tau.v, dev)
        rw = _bytecode_rw_leaves(spec, polynomials.a_read_write,
                                 polynomials.v_read_write, polynomials.t_read,
                                 gp, tau_dev)
        identity = fd.u64_to_mont_device(
            spec, np.arange(self.pre.code_size, dtype=np.uint64), dev)
        inf = _bytecode_if_leaves(spec, self.pre.v_init_final,
                                  polynomials.t_final, identity, gp, tau_dev)
        return rw, inf
