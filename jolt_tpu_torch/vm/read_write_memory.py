"""Registers/RAM offline memory checking (Spice-style), + output sumcheck.

Reference: jolt-core/src/jolt/vm/read_write_memory.rs
(jolt_tpu/vm/read_write_memory.py).  One unified address space: 64
registers || program inputs || outputs || panic || padding || RAM.  Each
step performs 7 memory ops (rs1/rs2 reads, rd write, 4 RAM bytes);
read/write multisets are checked per channel against one init/final pair.

Fork parity: the reference's OutputSumcheck io_witness_range compares
witness indices against an ADDRESS-space bound, making the range
polynomial identically zero (read_write_memory.rs:1189-1198); the port
replicates the same transcript.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..field import device as fd
from ..field.host import FElt
from ..field.spec import FieldSpec
from ..lasso.memory_checking import MemoryCheckingProof, MultisetHashes
from ..poly import mle
from ..subprotocols.grand_product import (BatchedDenseGrandProduct,
                                          verify_grand_product)
from ..parallel.sharding import shard_sumcheck_polys
from ..subprotocols.sumcheck import (SumcheckInstanceProof, VerificationError,
                                     prove_arbitrary)
from ..transcript import Transcript
from ..utils.math import log2_strict, next_power_of_two
from .rv_trace import (MEMORY_OPS_PER_INSTRUCTION, REGISTER_COUNT,
                       JoltDevice, MemoryLayout,
                       memory_address_to_witness_index)

RS1, RS2, RD, RAM_1, RAM_2, RAM_3, RAM_4 = range(7)

MEMCHECK_PROTOCOL = b"Registers/RAM memory checking"


def remap_address(a: int, layout: MemoryLayout) -> int:
    if a >= layout.input_start:
        return memory_address_to_witness_index(a, layout.ram_witness_offset)
    if a < REGISTER_COUNT:
        return a
    raise ValueError(f"unexpected address {a}")


@dataclass
class ReadWriteMemoryPreprocessing:
    min_bytecode_address: int = 0
    bytecode_bytes: bytes = b""


@dataclass
class ReadWriteMemoryPolynomials:
    a_ram: torch.Tensor        # [16, T]
    v_read: torch.Tensor       # [16, 7, T]
    v_write_rd: torch.Tensor   # [16, T]
    v_write_ram: torch.Tensor  # [16, 4, T]
    v_final: torch.Tensor      # [16, K]
    t_read: torch.Tensor       # [16, 7, T]
    t_write_ram: torch.Tensor  # [16, 4, T]
    t_final: torch.Tensor      # [16, K]
    v_init: torch.Tensor       # [16, K]
    t_read_host: np.ndarray    # [7, T] u64 (for the timestamp range check)

    def read_write_values(self):
        out = [self.a_ram]
        out += [fd.col(self.v_read, i) for i in range(7)]
        out.append(self.v_write_rd)
        out += [fd.col(self.v_write_ram, i) for i in range(4)]
        out += [fd.col(self.t_read, i) for i in range(7)]
        out += [fd.col(self.t_write_ram, i) for i in range(4)]
        return out

    def init_final_values(self):
        return [self.v_final, self.t_final]


def generate_witness(pre: ReadWriteMemoryPreprocessing, program_io: JoltDevice,
                     load_store_flags: np.ndarray, ops_is_write: np.ndarray,
                     ops_addr: np.ndarray, ops_val: np.ndarray,
                     spec: FieldSpec, device) -> ReadWriteMemoryPolynomials:
    """Witness generation (read_write_memory.rs:243-850).

    load_store_flags: [5, T] u8 (LB, LH, SB, SH, SW lookup flags);
    ops_is_write/addr/val: [7, T] per-channel memory ops (addresses in the
    VM address space; 0 = no-op).  The per-address timestamp/value state
    updates are inherently sequential: a host scan."""
    layout = program_io.memory_layout
    T = ops_addr.shape[1]
    assert T == next_power_of_two(T)

    max_trace_address = 0
    for i in range(3, 7):
        nz = ops_addr[i][ops_addr[i] != 0]
        if nz.size:
            max_trace_address = max(
                max_trace_address,
                max(remap_address(int(a), layout) for a in nz))
    memory_size = next_power_of_two(layout.ram_witness_offset
                                    + max_trace_address)

    v_init = np.zeros(memory_size, dtype=np.uint64)
    idx = memory_address_to_witness_index(pre.min_bytecode_address,
                                          layout.ram_witness_offset) \
        if pre.bytecode_bytes else 0
    for b in pre.bytecode_bytes:
        v_init[idx] = b
        idx += 1
    idx = memory_address_to_witness_index(layout.input_start,
                                          layout.ram_witness_offset)
    for b in program_io.inputs:
        v_init[idx] = b
        idx += 1

    v_final = v_init.copy()
    t_final = np.zeros(memory_size, dtype=np.uint64)
    a_ram = np.zeros(T, dtype=np.uint64)
    v_read = np.zeros((7, T), dtype=np.uint64)
    t_read = np.zeros((7, T), dtype=np.uint64)
    v_write_rd = np.zeros(T, dtype=np.uint64)
    v_write_ram = np.zeros((4, T), dtype=np.uint64)
    t_write_ram = np.zeros((4, T), dtype=np.uint64)

    lb_f, lh_f, sb_f, sh_f, sw_f = (load_store_flags[i] for i in range(5))
    ram_active = (lb_f | lh_f | sb_f | sh_f | sw_f).astype(bool)

    for j in range(T):
        ts = j
        # registers
        for ch in (RS1, RS2):
            a = int(ops_addr[ch, j])
            assert not ops_is_write[ch, j]
            v_read[ch, j] = v_final[a]
            t_read[ch, j] = t_final[a]
            t_final[a] = ts
        a = int(ops_addr[RD, j])
        assert ops_is_write[RD, j]
        v_read[RD, j] = v_final[a]
        t_read[RD, j] = t_final[a]
        v_write_rd[j] = ops_val[RD, j]
        v_final[a] = ops_val[RD, j]
        t_final[a] = ts + 1

        # RAM bytes
        if not ram_active[j]:
            continue  # all RAM arrays stay 0 for this step
        a_ram[j] = remap_address(int(ops_addr[RAM_1, j]), layout)

        def ram_op(channel, ram_index):
            raa = remap_address(int(ops_addr[channel, j]), layout)
            v_old = v_final[raa]
            v_read[channel, j] = v_old
            t_read[channel, j] = t_final[raa]
            if ops_is_write[channel, j]:
                v_new = int(ops_val[channel, j])
                v_write_ram[ram_index, j] = v_new
                t_write_ram[ram_index, j] = ts + 1
                v_final[raa] = v_new
                t_final[raa] = ts + 1
            else:
                v_write_ram[ram_index, j] = v_old
                t_write_ram[ram_index, j] = ts
                t_final[raa] = ts

        ram_op(RAM_1, 0)
        if lh_f[j] or sh_f[j] or sw_f[j]:
            ram_op(RAM_2, 1)
        if sw_f[j]:
            ram_op(RAM_3, 2)
            ram_op(RAM_4, 3)

    to_dev = lambda arr: fd.u64_to_mont_device(spec, arr, device)  # noqa: E731
    return ReadWriteMemoryPolynomials(
        a_ram=to_dev(a_ram), v_read=to_dev(v_read),
        v_write_rd=to_dev(v_write_rd), v_write_ram=to_dev(v_write_ram),
        v_final=to_dev(v_final), t_read=to_dev(t_read),
        t_write_ram=to_dev(t_write_ram), t_final=to_dev(t_final),
        v_init=to_dev(v_init), t_read_host=t_read)


# ---------------------------------------------------------------------------
# leaves
# ---------------------------------------------------------------------------

def _scalar(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(fd.L, 1)


def _fingerprint(spec, a, v, t, gamma, gamma2, tau):
    """t * gamma^2 + v * gamma + a - tau over [16, n] rows."""
    return fd.fadd(spec, fd.fadd(spec, fd.fmul(spec, t, gamma2),
                                 fd.fmul(spec, v, gamma)),
                   fd.fsub(spec, a, tau))


def _rwm_rw_leaves(spec: FieldSpec, polys: ReadWriteMemoryPolynomials,
                   a_rd, a_rs1, a_rs2, identity, gamma, tau):
    """14 interleaved read/write fingerprint layers [16, 14, T]
    (read_write_memory.rs:903-960)."""
    g = _scalar(gamma)
    g2 = _scalar(fd.fmul(spec, gamma, gamma))
    t = _scalar(tau)
    one = fd.ones(spec, (1,), identity.device)
    layers = []
    for i in range(MEMORY_OPS_PER_INSTRUCTION):
        if i == RS1:
            a = a_rs1
        elif i == RS2:
            a = a_rs2
        elif i == RD:
            a = a_rd
        else:
            off = fd.scalar_to_device(spec, i - RAM_1, identity.device)
            a = fd.fadd(spec, polys.a_ram, _scalar(off))
        if i in (RS1, RS2):
            v_w = polys.v_read[:, i]     # rs1/rs2 writes restore the read value
            t_w = identity
        elif i == RD:
            v_w = polys.v_write_rd
            t_w = fd.fadd(spec, identity, one)
        else:
            v_w = polys.v_write_ram[:, i - RAM_1]
            t_w = polys.t_write_ram[:, i - RAM_1]
        layers.append(_fingerprint(spec, a, polys.v_read[:, i],
                                   polys.t_read[:, i], g, g2, t))
        layers.append(_fingerprint(spec, a, v_w, t_w, g, g2, t))
    return torch.stack(layers, dim=1)


def _rwm_if_leaves(spec: FieldSpec, v_init, v_final, t_final, identity,
                   gamma, tau):
    g = _scalar(gamma)
    g2 = _scalar(fd.fmul(spec, gamma, gamma))
    t = _scalar(tau)
    init = fd.fadd(spec, fd.fmul(spec, v_init, g), fd.fsub(spec, identity, t))
    final = _fingerprint(spec, identity, v_final, t_final, g, g2, t)
    return torch.stack([init, final], dim=1)


@dataclass
class OutputSumcheckProof:
    num_rounds: int
    sumcheck_proof: SumcheckInstanceProof
    opening: FElt


def _output_comb(spec, params):
    eq, io_range, v_final, v_io = params
    return fd.fmul(spec, fd.fmul(spec, eq, io_range),
                   fd.fsub(spec, v_final, v_io))


@dataclass
class ReadWriteMemoryProof:
    memory_checking_proof: MemoryCheckingProof
    output_proof: OutputSumcheckProof
    timestamp_validity_proof: object


def _identity_dev(spec, n, device):
    return fd.u64_to_mont_device(spec, np.arange(n, dtype=np.uint64), device)


def prove_memory_checking(polys: ReadWriteMemoryPolynomials,
                          bytecode_polys, transcript: Transcript,
                          spec: FieldSpec, mesh=None) -> MemoryCheckingProof:
    """With `mesh`, both grand products split their batch axis over it."""
    gamma = transcript.challenge_scalar()
    tau = transcript.challenge_scalar()
    transcript.append_protocol_name(MEMCHECK_PROTOCOL)

    dev = polys.a_ram.device
    g = fd.scalar_to_device(spec, gamma.v, dev)
    t = fd.scalar_to_device(spec, tau.v, dev)
    T = polys.a_ram.shape[-1]
    # exogenous register addresses: bytecode v_read_write rows rd, rs1, rs2
    bv = bytecode_polys.v_read_write
    rw = _rwm_rw_leaves(spec, polys, bv[:, 2], bv[:, 3], bv[:, 4],
                        _identity_dev(spec, T, dev), g, t)
    inf = _rwm_if_leaves(spec, polys.v_init, polys.v_final, polys.t_final,
                         _identity_dev(spec, polys.v_final.shape[-1], dev),
                         g, t)

    rw_circuit = BatchedDenseGrandProduct.construct(rw, spec, mesh=mesh)
    if_circuit = BatchedDenseGrandProduct.construct(inf, spec, mesh=mesh)
    del rw, inf                # the pair trees hold their own copies
    rw_hashes = rw_circuit.claims()
    if_hashes = if_circuit.claims()

    hashes = MultisetHashes(rw_hashes[0::2], rw_hashes[1::2],
                            [if_hashes[0]], [if_hashes[1]])
    _check_multiset(hashes)
    hashes.append_to_transcript(transcript)

    rw_proof, _ = rw_circuit.prove(transcript)
    if_proof, _ = if_circuit.prove(transcript)
    return MemoryCheckingProof(hashes, rw_proof, if_proof)


def _check_multiset(h: MultisetHashes):
    spec = h.read_hashes[0].spec
    read = FElt(1, spec)
    write = FElt(1, spec)
    for r in h.read_hashes:
        read = read * r
    for w in h.write_hashes:
        write = write * w
    if h.init_hashes[0] * write != h.final_hashes[0] * read:
        raise VerificationError("Registers/RAM multiset hashes don't match")


def verify_memory_checking(proof: MemoryCheckingProof, transcript: Transcript,
                           spec: FieldSpec) -> None:
    transcript.challenge_scalar()   # gamma
    transcript.challenge_scalar()   # tau
    transcript.append_protocol_name(MEMCHECK_PROTOCOL)
    h = proof.multiset_hashes
    _check_multiset(h)
    h.append_to_transcript(transcript)
    rw = [x for pair in zip(h.read_hashes, h.write_hashes) for x in pair]
    inf = [h.init_hashes[0], h.final_hashes[0]]
    verify_grand_product(proof.read_write_grand_product, rw, transcript)
    verify_grand_product(proof.init_final_grand_product, inf, transcript)


# ---------------------------------------------------------------------------
# output sumcheck (read_write_memory.rs:1157-1343)
# ---------------------------------------------------------------------------

def _io_values(program_io: JoltDevice, size: int) -> list[int]:
    """Inputs, outputs and the panic bit at their witness indices."""
    layout = program_io.memory_layout
    v_io = [0] * size
    idx = memory_address_to_witness_index(layout.input_start,
                                          layout.ram_witness_offset)
    for b in program_io.inputs:
        v_io[idx] = b
        idx += 1
    idx = memory_address_to_witness_index(layout.output_start,
                                          layout.ram_witness_offset)
    for b in program_io.outputs:
        v_io[idx] = b
        idx += 1
    v_io[memory_address_to_witness_index(layout.panic,
                                         layout.ram_witness_offset)] = \
        int(program_io.panic)
    return v_io


def prove_outputs(polys: ReadWriteMemoryPolynomials, program_io: JoltDevice,
                  opening_accumulator, transcript: Transcript,
                  spec: FieldSpec, mesh=None) -> OutputSumcheckProof:
    """With `mesh`, the output sumcheck's tensors split on the hypercube
    axis (jolt_tpu's read_write_memory.py:381-383)."""
    layout = program_io.memory_layout
    dev = polys.v_final.device
    memory_size = polys.v_final.shape[-1]
    num_rounds = log2_strict(memory_size)
    r_eq = transcript.challenge_vector(num_rounds)
    eq = mle.eq_evals_device(spec, r_eq, dev)
    # fork parity: the witness-index vs address comparison makes this range
    # polynomial identically zero (see module docstring)
    i = np.arange(memory_size, dtype=np.int64)
    io_witness_range = ((i >= layout.input_start)
                        & (i < layout.ram_witness_offset)).astype(np.uint64)
    v_io = np.array(_io_values(program_io, memory_size), dtype=np.uint64)

    to_dev = lambda arr: fd.u64_to_mont_device(spec, arr, dev)  # noqa: E731
    sc_polys = (eq, to_dev(io_witness_range), polys.v_final, to_dev(v_io))
    if mesh is not None:
        sc_polys = shard_sumcheck_polys(mesh, sc_polys)
    proof, r_sumcheck, openings = prove_arbitrary(
        num_rounds, sc_polys, _output_comb, 3, transcript, spec)

    opening_accumulator.append([polys.v_final],
                               mle.eq_evals_device(spec, r_sumcheck, dev),
                               r_sumcheck, [openings[2]], transcript)
    return OutputSumcheckProof(num_rounds, proof, openings[2])


def verify_outputs(proof: OutputSumcheckProof, program_io: JoltDevice,
                   v_final_commitment, opening_accumulator,
                   transcript: Transcript, spec: FieldSpec) -> None:
    layout = program_io.memory_layout
    r_eq = transcript.challenge_vector(proof.num_rounds)
    sumcheck_claim, r_sumcheck = proof.sumcheck_proof.verify(
        FElt(0, spec), proof.num_rounds, 3, transcript)
    eq_eval = mle.eq_evaluate_host(r_eq, r_sumcheck)

    nonzero_memory_size = layout.ram_witness_offset
    log_nz = log2_strict(nonzero_memory_size)
    io_witness_range = [FElt(1 if i >= layout.input_start else 0, spec)
                        for i in range(nonzero_memory_size)]
    io_range_eval = mle.evaluate_host(io_witness_range, r_sumcheck[:log_nz])
    r_prod = FElt(1, spec)
    for rv in r_sumcheck[log_nz:]:
        r_prod = r_prod * rv
    io_range_eval = io_range_eval * r_prod

    v_io = _io_values(program_io, nonzero_memory_size)
    v_io_eval = mle.evaluate_host([FElt(v, spec) for v in v_io],
                                  r_sumcheck[:log_nz]) * r_prod

    if eq_eval * io_range_eval * (proof.opening - v_io_eval) != sumcheck_claim:
        raise VerificationError("Output sumcheck check failed")

    opening_accumulator.append([v_final_commitment], r_sumcheck,
                               [proof.opening], transcript)
