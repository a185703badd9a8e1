"""The Jolt zkVM orchestrator: preprocess / prove / verify.

Reference: jolt-core/src/jolt/vm/mod.rs:244-663 (jolt_tpu/vm/jolt.py).
The transcript's event order, which determines every challenge, is:
  preamble -> vk_digest -> all commitments (read/write then init/final)
  -> bytecode memory checking -> instruction lookups (primary sumcheck +
  memory checking) -> registers/RAM memory checking -> output sumcheck ->
  timestamp validity -> Spartan (outer + inner) -> batched opening reduction.
The prover and the verifier walk it in the same order.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .._device import resolve_device
from ..field import device as fd
from ..field.spec import FieldSpec, fr_spec
from ..instructions.utils import chunk_operand_vec
from ..parallel.sharding import check_first
from ..poly.opening_proof import (ProverOpeningAccumulator, ReducedOpeningProof,
                                  VerifierOpeningAccumulator)
from ..transcript import Transcript
from ..utils.math import log2_strict, next_power_of_two
from ..utils.profiling import span
from . import bytecode as bc
from . import instruction_lookups as il
from . import r1cs as r1cs_mod
from . import read_write_memory as rwm
from . import timestamp_range_check as ts
from .commit_layout import build_commit_layout
from .rv_trace import NUM_CIRCUIT_FLAGS, RAM_START_ADDRESS, JoltDevice
from .trace import JoltTraceStep, pad_trace


@dataclass
class JoltPreprocessing:
    instruction_lookups: il.InstructionLookupsPreprocessing
    bytecode: bc.BytecodePreprocessing
    read_write_memory: rwm.ReadWriteMemoryPreprocessing
    pcs: object
    device: object


@dataclass
class JoltProof:
    trace_length: int
    program_io: JoltDevice
    bytecode: object
    read_write_memory: rwm.ReadWriteMemoryProof
    instruction_lookups: il.InstructionLookupsProof
    r1cs: r1cs_mod.UniformSpartanProof
    opening_proof: ReducedOpeningProof


class JoltVM:
    """A Jolt VM instance parametrized by its instruction set + subtables
    (rv32i_vm.rs instruction_set!/subtable_enum! analog)."""

    def __init__(self, instruction_classes, subtable_order, C: int, M: int,
                 load_store_lookup_names=("lb", "lh", "sb", "sh", "sw"),
                 spec: FieldSpec | None = None):
        self.spec = spec or fr_spec()
        self.C, self.M = C, M
        self.instruction_classes = list(instruction_classes)
        self.subtable_order = list(subtable_order)
        self.name_to_index = {cls.name: k
                              for k, cls in enumerate(self.instruction_classes)}
        self.load_store_indices = [self.name_to_index[n]
                                   for n in load_store_lookup_names
                                   if n in self.name_to_index]
        self.layout = r1cs_mod.build_input_layout(C,
                                                  len(self.instruction_classes))
        self.num_aux = sum(1 for n in self.layout if n.startswith("aux_"))

    def commit_layout(self, num_memories: int):
        """Named commitment-ordering layout (shared by prove and verify)."""
        return build_commit_layout(self.C, num_memories,
                                   len(self.instruction_classes),
                                   NUM_CIRCUIT_FLAGS, self.num_aux)

    def required_srs_len(self, program_io: JoltDevice,
                         trace: list[JoltTraceStep], bytecode_rows) -> int:
        """Longest polynomial a real PCS must commit for this trace:
        max(T, M [il final_cts], RAM memory_size, bytecode K)
        (rv32i_vm.rs:228 sizes the HyperKZG SRS from the commit shapes)."""
        T = next_power_of_two(len(trace))
        layout = program_io.memory_layout
        max_addr = 0
        for s in trace:
            for ch in range(3, 7):
                a = s.memory_ops_addr[ch]
                if a:
                    max_addr = max(max_addr, rwm.remap_address(a, layout))
        mem_size = next_power_of_two(layout.ram_witness_offset + max_addr)
        k_bc = next_power_of_two(len(bytecode_rows) + 1)
        return max(T, self.M, mem_size, k_bc)

    # -- preprocessing ------------------------------------------------------
    def preprocess(self, bytecode_rows: list[bc.BytecodeRow], pcs,
                   memory_init: bytes = b"",
                   min_bytecode_address: int = RAM_START_ADDRESS,
                   device=None) -> JoltPreprocessing:
        """Subtables and bytecode on `device` (default: the device of the
        PCS's SRS, else the CUDA card)."""
        if device is None:
            pk = getattr(pcs, "pk", None)
            device = pk.g1_jac[0].device if pk is not None else None
        dev = resolve_device(device)
        with span("preprocess::instruction_lookups"):
            ilp = il.InstructionLookupsPreprocessing(
                self.instruction_classes, self.subtable_order, self.C,
                self.M, dev, self.spec)
        with span("preprocess::bytecode"):
            bcp = bc.BytecodePreprocessing(bytecode_rows, dev, self.spec)
        with span("preprocess::read_write_memory"):
            rwp = rwm.ReadWriteMemoryPreprocessing(min_bytecode_address,
                                                   memory_init)
        return JoltPreprocessing(instruction_lookups=ilp, bytecode=bcp,
                                 read_write_memory=rwp, pcs=pcs, device=dev)

    def _preamble(self, transcript: Transcript, program_io: JoltDevice,
                  trace_length: int) -> None:
        transcript.append_u64(trace_length)
        transcript.append_u64(self.C)
        transcript.append_u64(self.M)
        transcript.append_u64(len(self.instruction_classes))
        transcript.append_u64(len(self.subtable_order))
        transcript.append_u64(program_io.memory_layout.max_input_size)
        transcript.append_u64(program_io.memory_layout.max_output_size)
        transcript.append_bytes(bytes(program_io.inputs))
        transcript.append_bytes(bytes(program_io.outputs))
        transcript.append_u64(int(program_io.panic))

    def _constraints(self, program_io: JoltDevice, T: int):
        builder, non_uniform = r1cs_mod.build_jolt_constraints(
            self.layout, self.C,
            RAM_START_ADDRESS - program_io.memory_layout.ram_witness_offset,
            self.name_to_index, log2_strict(self.M))
        key = r1cs_mod.UniformSpartanKey(self.layout, builder.constraints,
                                         non_uniform, T, self.spec)
        return builder, non_uniform, key

    # -- witness assembly ---------------------------------------------------
    def _flattened_polys(self, bc_polys, rwm_polys, il_polys, r1cs_polys
                         ) -> list:
        """The R1CS inputs in layout order; the aux slots are filled by
        r1cs.compute_aux."""
        C = self.C
        out = [bc_polys.a_read_write]
        out += [fd.col(bc_polys.v_read_write, i) for i in range(6)]
        out += [rwm_polys.a_ram]
        out += [fd.col(rwm_polys.v_read, i) for i in range(7)]
        out += [rwm_polys.v_write_rd]
        out += [fd.col(rwm_polys.v_write_ram, i) for i in range(4)]
        out += [fd.col(il_polys.dim, i) for i in range(C)]
        out += [il_polys.lookup_outputs]
        out += [fd.col(r1cs_polys["chunks_x"], i) for i in range(C)]
        out += [fd.col(r1cs_polys["chunks_y"], i) for i in range(C)]
        out += [fd.col(r1cs_polys["circuit_flags"], i)
                for i in range(NUM_CIRCUIT_FLAGS)]
        out += [fd.col(il_polys.instruction_flags, i)
                for i in range(len(self.instruction_classes))]
        out += [None] * (len(self.layout) - len(out))  # aux, filled later
        return out

    # -- prove --------------------------------------------------------------
    def prove(self, program_io: JoltDevice, trace: list[JoltTraceStep],
              pre: JoltPreprocessing, mesh=None):
        """Returns (proof, commitments, transcript, opening accumulator);
        the last two are the verifier's debug oracles.

        With `mesh` (parallel/sharding.py: `make_mesh`), the whole prover
        runs multi-device, as jolt_tpu's prove(mesh=) does: the commit
        MSMs split the point axis (HyperKZG's; Hyrax and Zeromorph commit
        unsharded, as jolt_tpu's), the grand products the batch axis, and
        every sumcheck (primary lookups, outputs, Spartan outer and inner,
        the opening reduction) the hypercube axis.  The mesh's first device must be the one the
        preprocessing lives on.  The transcript bytes are the unsharded
        prover's."""
        spec, dev = self.spec, pre.device
        if mesh is not None:
            check_first(mesh, dev)
        trace_length = len(trace)
        trace = pad_trace(trace)
        T = len(trace)

        transcript = Transcript(b"Jolt transcript")
        self._preamble(transcript, program_io, trace_length)

        # --- witness generation -------------------------------------------
        with span("witness_generation"):
            instr_idx = np.array([s.instruction_index for s in trace],
                                 dtype=np.int64)
            xs = np.array([s.lookup_x for s in trace], dtype=np.uint64)
            ys = np.array([s.lookup_y for s in trace], dtype=np.uint64)
            il_polys = il.generate_witness(pre.instruction_lookups,
                                           instr_idx, xs, ys)

            load_store_flags = np.stack(
                [il_polys.instruction_flag_bits[k]
                 for k in self.load_store_indices]) \
                if len(self.load_store_indices) == 5 \
                else np.zeros((5, T), np.uint8)
            ops_is_write = np.array([s.memory_ops_is_write for s in trace]).T
            ops_addr = np.array([s.memory_ops_addr for s in trace],
                                dtype=np.uint64).T
            ops_val = np.array([s.memory_ops_val for s in trace],
                               dtype=np.uint64).T
            rwm_polys = rwm.generate_witness(pre.read_write_memory,
                                             program_io, load_store_flags,
                                             ops_is_write, ops_addr, ops_val,
                                             spec, dev)

            bc_polys = bc.generate_witness(pre.bytecode,
                                           [s.bytecode_row for s in trace], T)
            ts_polys = ts.generate_witness(rwm_polys.t_read_host, spec, dev)

            # r1cs witness: chunks + circuit flags (inputs.rs:163-214)
            log_M = log2_strict(self.M)
            chunks_x = np.zeros((self.C, T), dtype=np.uint64)
            chunks_y = np.zeros((self.C, T), dtype=np.uint64)
            cflags = np.array([s.circuit_flags for s in trace],
                              dtype=np.uint64).T
            active = instr_idx >= 0
            if active.any():
                chunks_x[:, active] = chunk_operand_vec(xs[active], self.C,
                                                        log_M // 2)
                chunks_y[:, active] = chunk_operand_vec(ys[active], self.C,
                                                        log_M // 2)
            r1cs_polys = {name: fd.u64_to_mont_device(spec, arr, dev)
                          for name, arr in (("chunks_x", chunks_x),
                                            ("chunks_y", chunks_y),
                                            ("circuit_flags", cflags))}

            builder, non_uniform, key = self._constraints(program_io, T)
            flattened = self._flattened_polys(bc_polys, rwm_polys, il_polys,
                                              r1cs_polys)
            r1cs_mod.compute_aux(builder, flattened, T, spec)

        # --- commitments ----------------------------------------------------
        pcs = pre.pcs
        rw_polys = (bc_polys.read_write_values()
                    + rwm_polys.read_write_values()
                    + il_polys.read_write_values()
                    + ts_polys.read_write_values()
                    + [fd.col(r1cs_polys["chunks_x"], i) for i in range(self.C)]
                    + [fd.col(r1cs_polys["chunks_y"], i) for i in range(self.C)]
                    + [fd.col(r1cs_polys["circuit_flags"], i)
                       for i in range(NUM_CIRCUIT_FLAGS)]
                    + [flattened[i] for i in range(len(self.layout))
                       if self.layout[i].startswith("aux_")])
        if_polys = (bc_polys.init_final_values()
                    + rwm_polys.init_final_values()
                    + il_polys.init_final_values())
        lay = self.commit_layout(pre.instruction_lookups.num_memories)
        lay.check_rw(rw_polys)
        lay.check_if(if_polys)
        with span("JoltPolynomials::commit"):
            rw_commitments = pcs.batch_commit(rw_polys, mesh=mesh)
            if_commitments = pcs.batch_commit(if_polys, mesh=mesh)
        del rw_polys, if_polys

        transcript.append_scalar(key.vk_digest)
        for com in rw_commitments + if_commitments:
            com.append_to_transcript(transcript)

        acc = ProverOpeningAccumulator(spec)

        # --- component proofs -----------------------------------------------
        with span("BytecodeProof::prove_memory_checking"):
            bc_mc = bc.BytecodeMemoryChecking(pre.bytecode)
            bc_mc.mesh = mesh
            bytecode_proof = bc_mc.prove_memory_checking(bc_polys, transcript)
        with span("InstructionLookupsProof::prove"):
            instruction_proof = il.prove_instruction_lookups(
                pre.instruction_lookups, il_polys, acc, transcript, mesh=mesh)
        with span("ReadWriteMemoryProof::prove"):
            mc_proof = rwm.prove_memory_checking(rwm_polys, bc_polys,
                                                 transcript, spec, mesh=mesh)
            output_proof = rwm.prove_outputs(rwm_polys, program_io, acc,
                                             transcript, spec, mesh=mesh)
            ts_proof = ts.prove_timestamp_validity(ts_polys, rwm_polys, acc,
                                                   transcript, spec,
                                                   mesh=mesh)
            memory_proof = rwm.ReadWriteMemoryProof(mc_proof, output_proof,
                                                    ts_proof)
        with span("UniformSpartanProof::prove"):
            spartan_proof = r1cs_mod.spartan_prove(builder, non_uniform, key,
                                                   flattened, T, acc,
                                                   transcript, spec,
                                                   mesh=mesh)
        with span("reduce_and_prove"):
            opening_proof = acc.reduce_and_prove(pcs, transcript, mesh=mesh)

        proof = JoltProof(trace_length, program_io, bytecode_proof,
                          memory_proof, instruction_proof, spartan_proof,
                          opening_proof)
        commitments = {"read_write": rw_commitments,
                       "init_final": if_commitments}
        return proof, commitments, transcript, acc

    # -- verify -------------------------------------------------------------
    def verify(self, pre: JoltPreprocessing, proof: JoltProof, commitments,
               debug_transcript: Transcript | None = None,
               debug_accumulator=None) -> None:
        """Host verification; raises VerificationError on a bad proof."""
        spec = self.spec
        program_io = proof.program_io
        T = next_power_of_two(proof.trace_length)

        transcript = Transcript(b"Jolt transcript")
        if debug_transcript is not None:
            transcript.compare_to(debug_transcript)
        self._preamble(transcript, program_io, proof.trace_length)

        _, _, key = self._constraints(program_io, T)
        transcript.append_scalar(key.vk_digest)
        rw_commitments = commitments["read_write"]
        if_commitments = commitments["init_final"]
        for com in rw_commitments + if_commitments:
            com.append_to_transcript(transcript)

        acc = VerifierOpeningAccumulator(pre.pcs, spec)
        if debug_accumulator is not None:
            acc.compare_to(debug_accumulator)

        bc.BytecodeMemoryChecking(pre.bytecode).verify_memory_checking(
            proof.bytecode, transcript)

        # instruction lookups: route its commitments for opening appends
        lay = self.commit_layout(pre.instruction_lookups.num_memories)
        lay.check_rw(rw_commitments)
        lay.check_if(if_commitments)
        il_commit_map = {
            "E": lay.rw(rw_commitments, "il_E"),
            "flags": lay.rw(rw_commitments, "il_flags"),
            "outputs": lay.rw1(rw_commitments, "il_outputs"),
        }
        il.verify_instruction_lookups(pre.instruction_lookups,
                                      proof.instruction_lookups,
                                      il_commit_map, acc, transcript)

        # registers/RAM + output sumcheck + timestamp validity
        mem = proof.read_write_memory
        rwm.verify_memory_checking(mem.memory_checking_proof, transcript, spec)
        rwm.verify_outputs(mem.output_proof, program_io,
                           lay.if1(if_commitments, "ram_v_final"), acc,
                           transcript, spec)
        ts_commits = [c for name in ("ts_read_cts_read_timestamp",
                                     "ts_read_cts_global_minus_read",
                                     "ts_final_cts_read_timestamp",
                                     "ts_final_cts_global_minus_read",
                                     "ram_t_read")
                      for c in lay.rw(rw_commitments, name)]
        ts.verify_timestamp_validity(mem.timestamp_validity_proof, ts_commits,
                                     acc, transcript, spec)

        # Spartan: witness commitments in flatten order
        r1cs_mod.spartan_verify(proof.r1cs, key,
                                self._flattened_commitments(rw_commitments,
                                                            lay),
                                acc, transcript, spec)

        acc.reduce_and_verify(pre.pcs, proof.opening_proof, transcript)

    def _flattened_commitments(self, rw: list, lay) -> list:
        """Committed polys (JoltStuff order) in r1cs flatten order, by
        layout section name (inputs.rs JoltR1CSInputs flatten order)."""
        out = [lay.rw1(rw, "bc_a_read_write")]
        out += lay.rw(rw, "bc_v_read_write")
        out.append(lay.rw1(rw, "ram_a"))
        out += lay.rw(rw, "ram_v_read")
        out.append(lay.rw1(rw, "ram_v_write_rd"))
        out += lay.rw(rw, "ram_v_write_ram")
        out += lay.rw(rw, "il_dim")                 # chunks_query
        out.append(lay.rw1(rw, "il_outputs"))       # lookup_output
        out += lay.rw(rw, "r1cs_chunks_x")
        out += lay.rw(rw, "r1cs_chunks_y")
        out += lay.rw(rw, "r1cs_circuit_flags")
        out += lay.rw(rw, "il_flags")               # instruction flags
        out += lay.rw(rw, "r1cs_aux")
        assert len(out) == len(self.layout), \
            "flattened commitment count disagrees with the r1cs input layout"
        return out
