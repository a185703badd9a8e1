"""arkworks CanonicalSerialize byte layout of whole Jolt proofs
(jolt_tpu/utils/ark_proof.py).

The reference persists proofs as `JoltHyperKZGProof { proof, commitments }`
through ark-serialize's derived `serialize_compressed`
(jolt-core/src/jolt/vm/rv32i_vm.rs:193-235, common/src/serializable.rs).
This module writes the same bytes from the port's proof objects, which hold
host `FElt`s and `G1Affine`s only (the provers pull their scalars and
points off the device as they append them to the transcript).

Derived CanonicalSerialize rules (ark-serialize 0.4):
  - struct: fields in declaration order, recursively
  - usize / u64: 8 bytes little-endian
  - bool / u8: 1 byte
  - Vec<T>: u64 LE length prefix + elements
  - [T; N]: N elements, no length prefix
  - Option<T>: 1 tag byte (0 = None, 1 = Some) + payload
  - Fr: 32 bytes LE canonical; G1Affine compressed: 32 bytes

Struct declaration orders follow the reference: JoltProof (jolt/vm/
mod.rs:102-118), JoltDevice/MemoryLayout (common/src/rv_trace.rs), the
memory-checking, grand-product, sumcheck, read/write-memory, timestamp,
instruction-lookup, Spartan and reduced-opening proofs, HyperKZGProof
(com, w, v) and JoltStuff (jolt/vm/mod.rs:120-133) for the commitments.
The fork's gutted openings (memory_checking.rs:330-384 commented out)
serialize as their default values: zero Fr scalars, Vec lengths from the
preprocessing (instruction_lookups.rs:88-103), None for every
VerifierComputedOpening.
"""
from __future__ import annotations

import io
import struct

from .ark_serialize import (fr_from_bytes, fr_to_bytes, g1_from_compressed,
                            g1_to_compressed)

MEMORY_OPS_PER_INSTRUCTION = 7   # common/src/constants.rs:8 (3 reg + 4 ram)


# ---------------------------------------------------------------------------
# primitive writers
# ---------------------------------------------------------------------------

def _w_u64(out, v: int) -> None:
    out.write(struct.pack("<Q", v))


def _w_u8(out, v: int) -> None:
    out.write(bytes([v & 0xFF]))


def _w_fr(out, x) -> None:
    out.write(fr_to_bytes(x.v if hasattr(x, "v") else int(x)))


def _w_fr_vec(out, xs) -> None:
    _w_u64(out, len(xs))
    for x in xs:
        _w_fr(out, x)


def _w_g1(out, p) -> None:
    out.write(g1_to_compressed(p))


def _w_g1_vec(out, commitments) -> None:
    _w_u64(out, len(commitments))
    for c in commitments:
        _w_g1(out, c.point)


def _w_none(out) -> None:
    _w_u8(out, 0)


def _w_zeros(out, n: int) -> None:
    """n default (zero) Fr scalars: the fork's gutted openings."""
    out.write(bytes(32 * n))


def _w_sumcheck(out, proof) -> None:
    """SumcheckInstanceProof: Vec<CompressedUniPoly{Vec<F>}>."""
    _w_u64(out, len(proof.compressed_polys))
    for cp in proof.compressed_polys:
        _w_fr_vec(out, cp.coeffs_except_linear_term)


def _w_gp_proof(out, proof) -> None:
    """BatchedGrandProductProof: Vec<layer> + Option<quark> (None: the
    dense and toggled provers emit no quark hybrid).  A quark hybrid is
    refused, as jolt_tpu/utils/ark_proof.py:105-106 refuses it."""
    if proof.quark is not None:
        raise ValueError("the quark hybrid grand product has no arkworks "
                         "encoding here (the VM's provers emit none)")
    _w_u64(out, len(proof.layers))
    for lay in proof.layers:
        _w_sumcheck(out, lay.proof)
        _w_fr_vec(out, lay.left_claims)
        _w_fr_vec(out, lay.right_claims)
    _w_none(out)


def _w_multiset_hashes(out, h) -> None:
    _w_fr_vec(out, h.read_hashes)
    _w_fr_vec(out, h.write_hashes)
    _w_fr_vec(out, h.init_hashes)
    _w_fr_vec(out, h.final_hashes)


def _w_bytecode_openings(out) -> None:
    """BytecodeStuff<F> default: a_read_write, v_read_write[6], t_read,
    t_final (zeros), a_init_final None, v_init_final None."""
    _w_zeros(out, 1 + 6 + 1 + 1)
    _w_none(out)
    _w_none(out)


def _w_rwm_openings(out) -> None:
    """ReadWriteMemoryStuff<F> default: a_ram, v_read[7], v_write_rd,
    v_write_ram[4], v_final, t_read[7], t_write_ram[4], t_final zeros, then
    3 None (a_init_final, v_init, identity)."""
    _w_zeros(out, 1 + MEMORY_OPS_PER_INSTRUCTION + 1 + 4 + 1
             + MEMORY_OPS_PER_INSTRUCTION + 4 + 1)
    for _ in range(3):
        _w_none(out)


def _w_register_address_openings(out) -> None:
    """RegisterAddressOpenings<F>: a_rd, a_rs1, a_rs2 (gutted: zeros)."""
    _w_zeros(out, 3)


def _w_zero_vec(out, n: int) -> None:
    _w_u64(out, n)
    _w_zeros(out, n)


def _w_il_openings(out, C: int, num_memories: int, num_instructions: int
                   ) -> None:
    """InstructionLookupStuff<F> as `initialize` builds it
    (instruction_lookups.rs:88-103): Vec lengths from the preprocessing,
    zero values, None options."""
    _w_zero_vec(out, C)                   # dim
    _w_zero_vec(out, num_memories)        # read_cts
    _w_zero_vec(out, num_memories)        # final_cts
    _w_zero_vec(out, num_memories)        # E_polys
    _w_zero_vec(out, num_instructions)    # instruction_flags
    _w_zeros(out, 1)                      # lookup_outputs
    for _ in range(3):   # instruction_flag_bitvectors, a/v_init_final
        _w_none(out)


def _w_memory_layout(out, ml) -> None:
    for f in ("ram_witness_offset", "max_input_size", "max_output_size",
              "input_start", "input_end", "output_start", "output_end",
              "panic"):
        _w_u64(out, int(getattr(ml, f)))


def _w_jolt_device(out, dev) -> None:
    for data in (bytes(dev.inputs), bytes(dev.outputs)):
        _w_u64(out, len(data))
        out.write(data)
    _w_u8(out, 1 if dev.panic else 0)
    _w_memory_layout(out, dev.memory_layout)


def _w_memory_checking_proof(out, mc, openings_writer, exo_writer) -> None:
    _w_multiset_hashes(out, mc.multiset_hashes)
    _w_gp_proof(out, mc.read_write_grand_product)
    _w_gp_proof(out, mc.init_final_grand_product)
    openings_writer(out)
    exo_writer(out)


def _w_hyperkzg_proof(out, pf) -> None:
    if pf is None:
        raise ValueError("arkworks proof bytes need a HyperKZG opening "
                         "proof (the mock PCS has none)")
    for points in (pf.com, pf.w):
        _w_u64(out, len(points))
        for p in points:
            _w_g1(out, p)
    _w_u64(out, len(pf.v))
    for row in pf.v:
        _w_fr_vec(out, row)


def serialize_jolt_proof(proof, C: int, num_memories: int,
                         num_instructions: int) -> bytes:
    """RV32IJoltProof's ark-compressed bytes (jolt/vm/mod.rs:102-118)."""
    out = io.BytesIO()
    _w_u64(out, proof.trace_length)
    _w_jolt_device(out, proof.program_io)

    # bytecode: MemoryCheckingProof<_, BytecodeOpenings, NoExogenous>
    _w_memory_checking_proof(out, proof.bytecode, _w_bytecode_openings,
                             lambda o: None)

    # read_write_memory: (memory_checking, timestamp, output), in the
    # struct's order, not the prover's
    rwm = proof.read_write_memory
    _w_memory_checking_proof(out, rwm.memory_checking_proof,
                             _w_rwm_openings, _w_register_address_openings)
    ts = rwm.timestamp_validity_proof
    _w_multiset_hashes(out, ts.multiset_hashes)
    for x in ts.openings:            # TimestampRangeCheckStuff: 4 x [F; 7]
        _w_fr(out, x)
    _w_none(out)                     # identity: VerifierComputedOpening
    for x in ts.exogenous_openings:  # ReadTimestampOpenings = [F; 7]
        _w_fr(out, x)
    _w_gp_proof(out, ts.batched_grand_product)
    op = rwm.output_proof
    _w_u64(out, op.num_rounds)
    _w_sumcheck(out, op.sumcheck_proof)
    _w_fr(out, op.opening)

    # instruction_lookups
    il = proof.instruction_lookups
    ps = il.primary_sumcheck
    _w_sumcheck(out, ps.sumcheck_proof)
    _w_u64(out, ps.num_rounds)
    _w_fr_vec(out, ps.openings.E_poly_openings)
    _w_fr_vec(out, ps.openings.flag_openings)
    _w_fr(out, ps.openings.lookup_outputs_opening)
    _w_memory_checking_proof(
        out, il.memory_checking,
        lambda o: _w_il_openings(o, C, num_memories, num_instructions),
        lambda o: None)

    # r1cs: UniformSpartanProof
    sp = proof.r1cs
    _w_sumcheck(out, sp.outer_sumcheck_proof)
    for c in sp.outer_sumcheck_claims:
        _w_fr(out, c)
    _w_sumcheck(out, sp.inner_sumcheck_proof)
    _w_fr_vec(out, sp.claimed_witness_evals)

    # opening_proof: ReducedOpeningProof
    ro = proof.opening_proof
    _w_sumcheck(out, ro.sumcheck_proof)
    _w_fr_vec(out, ro.sumcheck_claims)
    _w_hyperkzg_proof(out, ro.joint_opening_proof)
    return out.getvalue()


# ---------------------------------------------------------------------------
# commitments: JoltStuff<HyperKZGCommitment> (jolt/vm/mod.rs:120-133)
# ---------------------------------------------------------------------------

def serialize_jolt_commitments(rw_commitments: list, if_commitments: list,
                               layout) -> bytes:
    """The read_write / init_final commitment lists (vm/commit_layout.py's
    order) in ark's JoltStuff order, each HyperKZGCommitment one
    compressed G1 point."""
    rw = lambda name: layout.rw(rw_commitments, name)      # noqa: E731
    rw1 = lambda name: layout.rw1(rw_commitments, name)    # noqa: E731
    if1 = lambda name: layout.if1(if_commitments, name)    # noqa: E731
    out = io.BytesIO()

    def g1s(*cs):
        for c in cs:
            _w_g1(out, c.point)

    # BytecodeStuff: a_read_write, v_read_write[6], t_read, t_final, 2 None
    g1s(rw1("bc_a_read_write"), *rw("bc_v_read_write"), rw1("bc_t_read"),
        if1("bc_t_final"))
    _w_none(out)
    _w_none(out)

    # ReadWriteMemoryStuff: a_ram, v_read[7], v_write_rd, v_write_ram[4],
    # v_final, t_read[7], t_write_ram[4], t_final, 3 None
    g1s(rw1("ram_a"), *rw("ram_v_read"), rw1("ram_v_write_rd"),
        *rw("ram_v_write_ram"), if1("ram_v_final"), *rw("ram_t_read"),
        *rw("ram_t_write_ram"), if1("ram_t_final"))
    for _ in range(3):
        _w_none(out)

    # InstructionLookupStuff: dim, read_cts, final_cts, E_polys,
    # instruction_flags (Vecs), lookup_outputs, 3 None
    _w_g1_vec(out, rw("il_dim"))
    _w_g1_vec(out, rw("il_read_cts"))
    _w_g1_vec(out, layout.if_(if_commitments, "il_final_cts"))
    _w_g1_vec(out, rw("il_E"))
    _w_g1_vec(out, rw("il_flags"))
    g1s(rw1("il_outputs"))
    for _ in range(3):
        _w_none(out)

    # TimestampRangeCheckStuff: 4 x [T; 7], identity None
    for name in ("ts_read_cts_read_timestamp",
                 "ts_read_cts_global_minus_read",
                 "ts_final_cts_read_timestamp",
                 "ts_final_cts_global_minus_read"):
        g1s(*rw(name))
    _w_none(out)

    # R1CSStuff: chunks_x (Vec), chunks_y (Vec),
    # circuit_flags [T; NUM_CIRCUIT_FLAGS], aux AuxVariableStuff
    _w_g1_vec(out, rw("r1cs_chunks_x"))
    _w_g1_vec(out, rw("r1cs_chunks_y"))
    g1s(*rw("r1cs_circuit_flags"))
    # AuxVariableStuff: 4 scalars, relevant_y_chunks Vec, 5 scalars
    # (r1cs/inputs.rs:32-44); the layout's aux section is flat in that order
    aux = rw("r1cs_aux")
    n_y_chunks = len(aux) - 9
    g1s(*aux[:4])
    _w_g1_vec(out, aux[4:4 + n_y_chunks])
    g1s(*aux[4 + n_y_chunks:])
    return out.getvalue()


def serialize_jolt_hyperkzg_proof(proof, rw_commitments, if_commitments,
                                  layout, C: int, num_memories: int,
                                  num_instructions: int) -> bytes:
    """JoltHyperKZGProof { proof, commitments } (rv32i_vm.rs:226-233)."""
    return (serialize_jolt_proof(proof, C, num_memories, num_instructions)
            + serialize_jolt_commitments(rw_commitments, if_commitments,
                                         layout))


def jolt_proof_bytes(vm, pre, proof, commitments) -> bytes:
    """`serialize_jolt_hyperkzg_proof` of a proof by `vm` over `pre`."""
    il = pre.instruction_lookups
    return serialize_jolt_hyperkzg_proof(
        proof, commitments["read_write"], commitments["init_final"],
        vm.commit_layout(il.num_memories), il.C, il.num_memories,
        il.num_instructions)


# ---------------------------------------------------------------------------
# SurgeProof (lasso/surge.rs): the bench's compressed proof size
# (bench.rs:100-170 serialize_and_print_size)
# ---------------------------------------------------------------------------

def serialize_surge_proof(proof, num_memories: int) -> bytes:
    """SurgeProof's ark-compressed bytes: commitments (SurgeStuff: dim[C],
    read_cts[C], E[m], final_cts[C] Vecs + 2 None), the primary sumcheck,
    memory checking with default SurgeOpenings (surge.rs:50-68)."""
    out = io.BytesIO()
    C = proof.C
    rw = proof.commitments          # dim(C) || read_cts(C) || E(m)
    fin = proof.final_commitments   # final_cts(C)
    if len(rw) != 2 * C + num_memories or len(fin) != C:
        raise ValueError("Surge commitments do not match C and the memory "
                         "count")
    _w_g1_vec(out, rw[:C])              # dim
    _w_g1_vec(out, rw[C:2 * C])         # read_cts
    _w_g1_vec(out, rw[2 * C:])          # E_polys
    _w_g1_vec(out, fin)                 # final_cts
    _w_none(out)                        # a_init_final
    _w_none(out)                        # v_init_final

    ps = proof.primary_sumcheck
    _w_sumcheck(out, ps.sumcheck_proof)
    _w_u64(out, ps.num_rounds)
    _w_fr(out, ps.claimed_evaluation)
    _w_fr_vec(out, ps.E_poly_openings)

    def surge_openings(o):
        for n in (C, C, C, num_memories):   # dim, read_cts, final_cts, E
            _w_zero_vec(o, n)
        _w_none(o)
        _w_none(o)

    _w_memory_checking_proof(out, proof.memory_checking, surge_openings,
                             lambda o: None)
    return out.getvalue()


# ---------------------------------------------------------------------------
# the structure reader (a Rust verifier would use ark's own)
# ---------------------------------------------------------------------------

class _Reader:
    def __init__(self, data: bytes):
        self.b = io.BytesIO(data)

    def read(self, n: int) -> bytes:
        out = self.b.read(n)
        if len(out) != n:
            raise ValueError("ark proof bytes end early")
        return out

    def u64(self) -> int:
        return struct.unpack("<Q", self.read(8))[0]

    def u8(self) -> int:
        return self.read(1)[0]

    def fr(self) -> int:
        return fr_from_bytes(self.read(32))

    def fr_vec(self) -> list[int]:
        return [self.fr() for _ in range(self.u64())]

    def g1(self):
        return g1_from_compressed(self.read(32))

    def none(self) -> None:
        if self.u8() != 0:
            raise ValueError("expected a None option tag")

    def sumcheck(self) -> list[list[int]]:
        return [self.fr_vec() for _ in range(self.u64())]

    def gp(self) -> list:
        layers = [(self.sumcheck(), self.fr_vec(), self.fr_vec())
                  for _ in range(self.u64())]
        self.none()
        return layers

    def multiset(self):
        return (self.fr_vec(), self.fr_vec(), self.fr_vec(), self.fr_vec())


def deserialize_jolt_proof_structure(data: bytes, C: int, num_memories: int,
                                     num_instructions: int) -> dict:
    """Parse ark bytes back into nested plain Python (ints for Fr,
    G1Affine for points), checking every length and option tag; returns
    the fields needed to cross-check a proof, and `_proof_end`, the offset
    where the commitments begin."""
    r = _Reader(data)
    out = {"trace_length": r.u64()}
    out["inputs"] = r.read(r.u64())
    out["outputs"] = r.read(r.u64())
    out["panic"] = r.u8() == 1
    out["memory_layout"] = [r.u64() for _ in range(8)]

    def mc(openings_reader):
        h = r.multiset()
        rw_gp = r.gp()
        if_gp = r.gp()
        openings_reader()
        return {"hashes": h, "rw_gp": rw_gp, "if_gp": if_gp}

    def bc_open():
        for _ in range(9):
            r.fr()
        r.none()
        r.none()

    def rwm_open():
        for _ in range(1 + 7 + 1 + 4 + 1 + 7 + 4 + 1):
            r.fr()
        for _ in range(3):
            r.none()
        for _ in range(3):   # RegisterAddressOpenings
            r.fr()

    def il_open():
        for _ in range(5):
            r.fr_vec()
        r.fr()
        for _ in range(3):
            r.none()

    out["bytecode"] = mc(bc_open)
    out["rwm"] = mc(rwm_open)
    out["ts"] = {"hashes": r.multiset(),
                 "openings": [r.fr() for _ in range(4 * 7)]}
    r.none()
    out["ts"]["exogenous"] = [r.fr() for _ in range(7)]
    out["ts"]["gp"] = r.gp()
    out["output"] = {"num_rounds": r.u64(), "sumcheck": r.sumcheck(),
                     "opening": r.fr()}
    out["primary"] = {"sumcheck": r.sumcheck(), "num_rounds": r.u64(),
                      "E": r.fr_vec(), "flags": r.fr_vec(), "out": r.fr()}
    out["il_mc"] = mc(il_open)
    out["spartan"] = {"outer": r.sumcheck(),
                      "claims": (r.fr(), r.fr(), r.fr()),
                      "inner": r.sumcheck(), "witness_evals": r.fr_vec()}
    out["reduced"] = {"sumcheck": r.sumcheck(), "claims": r.fr_vec()}
    com = [r.g1() for _ in range(r.u64())]
    w = [r.g1() for _ in range(r.u64())]
    v = [r.fr_vec() for _ in range(r.u64())]
    out["reduced"]["hyperkzg"] = (com, w, v)
    out["_proof_end"] = r.b.tell()
    return out
