"""Canonical proof (de)serialization (jolt_tpu/utils/serialization.py).

The reference persists proofs and preprocessing with ark-compressed
encodings (the `Serializable` trait, common/src/serializable.rs,
rv32i_vm.rs:193-235).  This canonical encoding is jolt_tpu's: u64 LE
lengths, 32-byte LE field elements, affine points as x || y (64 bytes,
infinity = 64 zero bytes).  The port writes the same bytes as jolt_tpu for
the same proof, and reads them back into the port's proof objects, which
its verifier takes.  `ark_proof.py` has the arkworks layout.
"""
from __future__ import annotations

import io
import struct
from dataclasses import fields, is_dataclass

from ..curve.bn254 import G1Affine
from ..field.host import FElt
from ..field.spec import fr_spec


class Writer:
    def __init__(self):
        self.buf = io.BytesIO()

    def u64(self, x: int):
        self.buf.write(struct.pack("<Q", x))

    def felt(self, x: FElt):
        self.buf.write(x.v.to_bytes(32, "little"))

    def felts(self, xs):
        self.u64(len(xs))
        for x in xs:
            self.felt(x)

    def point(self, p: G1Affine):
        if p.is_infinity:
            self.buf.write(b"\x00" * 64)
        else:
            self.buf.write(p.x.to_bytes(32, "little"))
            self.buf.write(p.y.to_bytes(32, "little"))

    def points(self, ps):
        self.u64(len(ps))
        for p in ps:
            self.point(p)

    def getvalue(self) -> bytes:
        return self.buf.getvalue()


class Reader:
    def __init__(self, data: bytes):
        self.buf = io.BytesIO(data)

    def read(self, n: int) -> bytes:
        out = self.buf.read(n)
        if len(out) != n:
            raise ValueError("proof bytes end early")
        return out

    def u64(self) -> int:
        return struct.unpack("<Q", self.read(8))[0]

    def felt(self) -> FElt:
        spec = fr_spec()
        v = int.from_bytes(self.read(32), "little")
        if v >= spec.p:
            raise ValueError("non-canonical field element")
        return FElt(v, spec)

    def felts(self) -> list[FElt]:
        return [self.felt() for _ in range(self.u64())]

    def point(self) -> G1Affine:
        raw = self.read(64)
        if raw == b"\x00" * 64:
            return G1Affine.identity()
        p = G1Affine(int.from_bytes(raw[:32], "little"),
                     int.from_bytes(raw[32:], "little"))
        if not p.is_on_curve():
            raise ValueError("point not on the curve")
        return p

    def points(self) -> list[G1Affine]:
        return [self.point() for _ in range(self.u64())]

    def absent(self, what: str) -> None:
        """An option or presence flag that the port's proofs never set."""
        if self.u64():
            raise ValueError(f"{what}: the port's proofs carry none")

    def end(self, what: str) -> None:
        if self.buf.read():
            raise ValueError(f"trailing bytes after the {what}")


def serialize_sumcheck(w: Writer, proof) -> None:
    w.u64(len(proof.compressed_polys))
    for p in proof.compressed_polys:
        w.felts(p.coeffs_except_linear_term)


def deserialize_sumcheck(r: Reader):
    from ..poly.unipoly import CompressedUniPoly
    from ..subprotocols.sumcheck import SumcheckInstanceProof
    return SumcheckInstanceProof([CompressedUniPoly(r.felts())
                                  for _ in range(r.u64())])


def serialize_grand_product(w: Writer, proof) -> None:
    w.u64(len(proof.layers))
    for layer in proof.layers:
        serialize_sumcheck(w, layer.proof)
        w.felts(layer.left_claims)
        w.felts(layer.right_claims)
    # the quark option (None on the VM's path, grand_product.rs:37-41)
    q = proof.quark
    w.u64(0 if q is None else 1)
    if q is not None:
        serialize_sumcheck(w, q.sumcheck_proof)
        w.points([c.point for c in q.g_commitment])
        w.felts(q.claimed_eval_g_r)
        w.felts(q.claimed_eval_g_r_x[0])
        w.felts(q.claimed_eval_g_r_x[1])
        w.felts(q.helper_values[0])
        w.felts(q.helper_values[1])
        w.u64(q.num_vars)


def deserialize_grand_product(r: Reader):
    from ..subprotocols.grand_product import (BatchedGrandProductLayerProof,
                                              BatchedGrandProductProof)
    layers = []
    for _ in range(r.u64()):
        sp = deserialize_sumcheck(r)
        layers.append(BatchedGrandProductLayerProof(sp, r.felts(),
                                                    r.felts()))
    quark = None
    if r.u64():
        from ..commitment.hyperkzg import HyperKZGCommitment
        from ..subprotocols.grand_product_quarks import QuarkGrandProductProof
        sp = deserialize_sumcheck(r)
        g_com = [HyperKZGCommitment(p) for p in r.points()]
        g_r = r.felts()
        g_r_x = (r.felts(), r.felts())
        helper = (r.felts(), r.felts())
        quark = QuarkGrandProductProof(sp, g_com, g_r, g_r_x, helper, r.u64())
    return BatchedGrandProductProof(layers, quark)


def proof_size_bytes(obj) -> int:
    """The canonical size of any proof object tree (bench reporting):
    field elements 32 bytes, points 64, ints 8, walking dataclass fields
    in order, as jolt_tpu counts them."""
    w = Writer()
    _serialize_any(w, obj)
    return len(w.getvalue())


def _serialize_any(w: Writer, obj) -> None:
    if obj is None:
        return
    if isinstance(obj, FElt):
        w.felt(obj)
    elif isinstance(obj, G1Affine):
        w.point(obj)
    elif isinstance(obj, int):
        w.u64(obj & 0xFFFFFFFFFFFFFFFF)
    elif isinstance(obj, (list, tuple)):
        for x in obj:
            _serialize_any(w, x)
    elif is_dataclass(obj):
        for f in fields(obj):
            _serialize_any(w, getattr(obj, f.name))
    elif hasattr(obj, "__dict__"):
        for v in vars(obj).values():
            _serialize_any(w, v)


# ---------------------------------------------------------------------------
# the whole JoltProof: the `JoltHyperKZGProof` Serializable analogue
# (rv32i_vm.rs:193-235), one explicit schema per struct in write order
# ---------------------------------------------------------------------------

def serialize_multiset_hashes(w: Writer, mh) -> None:
    w.felts(mh.read_hashes)
    w.felts(mh.write_hashes)
    w.felts(mh.init_hashes)
    w.felts(mh.final_hashes)


def deserialize_multiset_hashes(r: Reader):
    from ..lasso.memory_checking import MultisetHashes
    return MultisetHashes(r.felts(), r.felts(), r.felts(), r.felts())


def serialize_memory_checking(w: Writer, proof) -> None:
    serialize_multiset_hashes(w, proof.multiset_hashes)
    serialize_grand_product(w, proof.read_write_grand_product)
    serialize_grand_product(w, proof.init_final_grand_product)
    # openings/exogenous_openings keep their defaults in the fork
    # (memory_checking.rs:46-64 and the gutted compute_openings): flag 0
    w.u64(0)


def deserialize_memory_checking(r: Reader):
    from ..lasso.memory_checking import MemoryCheckingProof
    mh = deserialize_multiset_hashes(r)
    rw = deserialize_grand_product(r)
    inf = deserialize_grand_product(r)
    r.absent("memory-checking openings")
    return MemoryCheckingProof(mh, rw, inf)


def serialize_hyperkzg_proof(w: Writer, proof) -> None:
    if proof is None:
        raise ValueError("proof bytes need a HyperKZG opening proof (the "
                         "mock PCS has none)")
    w.points(proof.com)
    w.points(proof.w)
    w.u64(len(proof.v))
    for row in proof.v:
        w.felts(row)


def deserialize_hyperkzg_proof(r: Reader):
    from ..commitment.hyperkzg import HyperKZGProof
    com = r.points()
    wit = r.points()
    return HyperKZGProof(com, wit, [r.felts() for _ in range(r.u64())])


def serialize_reduced_opening(w: Writer, proof) -> None:
    serialize_sumcheck(w, proof.sumcheck_proof)
    w.felts(proof.sumcheck_claims)
    serialize_hyperkzg_proof(w, proof.joint_opening_proof)


def deserialize_reduced_opening(r: Reader):
    from ..poly.opening_proof import ReducedOpeningProof
    sp = deserialize_sumcheck(r)
    claims = r.felts()
    return ReducedOpeningProof(sp, claims, deserialize_hyperkzg_proof(r))


def serialize_jolt_proof(w: Writer, proof) -> None:
    """JoltProof {trace_length, program_io, bytecode, read_write_memory,
    instruction_lookups, r1cs, opening_proof} (vm/mod.rs:101-117)."""
    w.u64(proof.trace_length)
    pio = proof.program_io
    w.u64(pio.memory_layout.max_input_size)
    w.u64(pio.memory_layout.max_output_size)
    w.u64(len(pio.inputs))
    w.buf.write(bytes(pio.inputs))
    w.u64(len(pio.outputs))
    w.buf.write(bytes(pio.outputs))
    w.u64(int(pio.panic))

    serialize_memory_checking(w, proof.bytecode)

    rwm = proof.read_write_memory
    serialize_memory_checking(w, rwm.memory_checking_proof)
    w.u64(rwm.output_proof.num_rounds)
    serialize_sumcheck(w, rwm.output_proof.sumcheck_proof)
    w.felt(rwm.output_proof.opening)
    ts = rwm.timestamp_validity_proof
    serialize_multiset_hashes(w, ts.multiset_hashes)
    w.felts(ts.openings)
    w.felts(ts.exogenous_openings)
    serialize_grand_product(w, ts.batched_grand_product)
    w.u64(0)   # the identity opening: verifier-computed, never sent

    il = proof.instruction_lookups
    ps = il.primary_sumcheck
    serialize_sumcheck(w, ps.sumcheck_proof)
    w.u64(ps.num_rounds)
    w.felts(ps.openings.E_poly_openings)
    w.felts(ps.openings.flag_openings)
    w.felt(ps.openings.lookup_outputs_opening)
    serialize_memory_checking(w, il.memory_checking)

    sp = proof.r1cs
    serialize_sumcheck(w, sp.outer_sumcheck_proof)
    w.felts(list(sp.outer_sumcheck_claims))
    serialize_sumcheck(w, sp.inner_sumcheck_proof)
    w.felts(sp.claimed_witness_evals)

    serialize_reduced_opening(w, proof.opening_proof)


def deserialize_jolt_proof(r: Reader):
    from ..vm.instruction_lookups import (InstructionLookupsProof,
                                          PrimarySumcheck,
                                          PrimarySumcheckOpenings)
    from ..vm.jolt import JoltProof
    from ..vm.r1cs import UniformSpartanProof
    from ..vm.read_write_memory import (OutputSumcheckProof,
                                        ReadWriteMemoryProof)
    from ..vm.rv_trace import JoltDevice
    from ..vm.timestamp_range_check import TimestampValidityProof

    trace_length = r.u64()
    max_in, max_out = r.u64(), r.u64()
    pio = JoltDevice.new(max_in, max_out)
    pio.inputs.extend(r.read(r.u64()))
    pio.outputs.extend(r.read(r.u64()))
    pio.panic = bool(r.u64())

    bytecode = deserialize_memory_checking(r)

    mc = deserialize_memory_checking(r)
    out_rounds = r.u64()
    out_sc = deserialize_sumcheck(r)
    out_proof = OutputSumcheckProof(out_rounds, out_sc, r.felt())
    mh = deserialize_multiset_hashes(r)
    openings = r.felts()
    exo = r.felts()
    gp = deserialize_grand_product(r)
    r.absent("timestamp identity opening")
    rwm = ReadWriteMemoryProof(
        mc, out_proof, TimestampValidityProof(mh, openings, exo, gp))

    ps_sc = deserialize_sumcheck(r)
    ps_rounds = r.u64()
    openings = PrimarySumcheckOpenings(r.felts(), r.felts(), r.felt())
    il = InstructionLookupsProof(PrimarySumcheck(ps_sc, ps_rounds, openings),
                                 deserialize_memory_checking(r))

    outer = deserialize_sumcheck(r)
    claims = r.felts()
    if len(claims) != 3:
        raise ValueError("Spartan carries three outer sumcheck claims")
    inner = deserialize_sumcheck(r)
    sp = UniformSpartanProof(outer, tuple(claims), inner, r.felts())

    return JoltProof(trace_length, pio, bytecode, rwm, il, sp,
                     deserialize_reduced_opening(r))


def serialize_jolt_proof_with_commitments(proof, commitments) -> bytes:
    """Proof and HyperKZG commitments -> bytes (rv32i_vm.rs:193-235)."""
    w = Writer()
    serialize_jolt_proof(w, proof)
    w.points([c.point for c in commitments["read_write"]])
    w.points([c.point for c in commitments["init_final"]])
    return w.getvalue()


def deserialize_jolt_proof_with_commitments(data: bytes):
    """-> (proof, {"read_write": [...], "init_final": [...]})."""
    from ..commitment.hyperkzg import HyperKZGCommitment
    r = Reader(data)
    proof = deserialize_jolt_proof(r)
    rw = [HyperKZGCommitment(p) for p in r.points()]
    inf = [HyperKZGCommitment(p) for p in r.points()]
    r.end("proof")
    return proof, {"read_write": rw, "init_final": inf}


# -- preprocessing persistence (rv32i_vm.rs:193-235 analogue) ----------------
#
# The reference serializes the whole JoltPreprocessing.  Here the
# preprocessing is derived deterministically from small seed data (bytecode
# rows, memory image, VM parameters), so persistence keeps the seed and
# `JoltVM.preprocess` rebuilds the rest; the SRS persists on its own in
# ark's bytes (ark_serialize.save_srs).

def serialize_preprocessing_seed(bytecode_rows, memory_init: bytes,
                                 min_bytecode_address: int,
                                 max_input_size: int,
                                 max_output_size: int) -> bytes:
    w = Writer()
    w.u64(min_bytecode_address)
    w.u64(max_input_size)
    w.u64(max_output_size)
    w.u64(len(memory_init))
    w.buf.write(memory_init)
    w.u64(len(bytecode_rows))
    for row in bytecode_rows:
        w.u64(row.address)
        w.u64(row.bitflags)
        w.u64(row.rd)
        w.u64(row.rs1)
        w.u64(row.rs2)
        w.u64(row.imm & 0xFFFFFFFFFFFFFFFF)
        vsr = row.virtual_sequence_remaining
        w.u64(0 if vsr is None else 1 + vsr)
    return w.getvalue()


def deserialize_preprocessing_seed(data: bytes):
    """-> (bytecode_rows, memory_init, min_bytecode_address,
           max_input_size, max_output_size)"""
    from ..vm.bytecode import BytecodeRow
    r = Reader(data)
    min_addr, max_in, max_out = r.u64(), r.u64(), r.u64()
    memory_init = r.read(r.u64())
    rows = []
    for _ in range(r.u64()):
        address, bitflags = r.u64(), r.u64()
        rd, rs1, rs2 = r.u64(), r.u64(), r.u64()
        imm = r.u64()
        if imm >= 1 << 63:
            imm -= 1 << 64
        vsr = r.u64()
        rows.append(BytecodeRow(address, bitflags, rd, rs1, rs2, imm,
                                vsr - 1 if vsr else None))
    r.end("preprocessing seed")
    return rows, memory_init, min_addr, max_in, max_out
