"""Uniform Spartan R1CS: the fetch/PC-update glue circuit.

Reference: jolt-core/src/r1cs/{ops,builder,inputs,constraints,key,spartan}.rs
(jolt_tpu/vm/r1cs.py).

Layout conventions (must match the verifier's closed-form MLE math):
  * rows (x): constraint-major -- row = constraint_index * T + step; the two
    non-uniform (offset-eq) constraints follow the uniform ones.
  * cols (y): var-major -- col = var_index * T + step; the constant column
    sits at num_vars_padded * T (the start of the second half).

Az/Bz/Cz are dense stacked tensors on the device (the reference's sparse
representation is a CPU choice; the values, and so the transcript, are the
same).  The inner sumcheck's RLC vector is assembled on the device from
per-variable host coefficients; the verifier key math runs on host ints.
"""
from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass

import torch

from ..field import device as fd
from ..field.host import FElt
from ..field.spec import FieldSpec
from ..parallel.sharding import shard_sumcheck_polys
from ..poly import mle
from ..subprotocols.sumcheck import (SumcheckInstanceProof, VerificationError,
                                     prove_arbitrary, prove_arbitrary_bot)
from ..transcript import Transcript
from ..utils.keccak import keccak256
from ..utils.math import log2_strict, next_power_of_two
from .rv_trace import NUM_CIRCUIT_FLAGS, CircuitFlags, RAM_OPS_PER_INSTRUCTION

PC_START_ADDRESS = 0x80000000
PC_NOOP_SHIFT = 4
LOG_M = 16
OPERAND_SIZE = LOG_M // 2


# ---------------------------------------------------------------------------
# linear combinations over flattened input indices (r1cs/ops.rs)
# ---------------------------------------------------------------------------

class LC:
    """Sum of (var_index, i64-coeff) terms plus an integer constant."""

    __slots__ = ("terms", "const")

    def __init__(self, terms=(), const: int = 0):
        acc: dict[int, int] = {}
        for v, c in terms:
            acc[v] = acc.get(v, 0) + c
        self.terms = [(v, c) for v, c in acc.items() if c != 0]
        self.const = const

    @staticmethod
    def of(x) -> "LC":
        if isinstance(x, LC):
            return x
        if isinstance(x, int):
            return LC((), x)
        if isinstance(x, Var):
            return LC([(x.index, 1)])
        raise TypeError(type(x))

    def __add__(self, other):
        o = LC.of(other)
        return LC(self.terms + o.terms, self.const + o.const)

    __radd__ = __add__

    def __sub__(self, other):
        o = LC.of(other)
        return LC(self.terms + [(v, -c) for v, c in o.terms],
                  self.const - o.const)

    def __rsub__(self, other):
        return LC.of(other) - self

    def __neg__(self):
        return LC([(v, -c) for v, c in self.terms], -self.const)

    def __mul__(self, k: int):
        assert isinstance(k, int)
        return LC([(v, c * k) for v, c in self.terms], self.const * k)

    __rmul__ = __mul__


@dataclass(frozen=True)
class Var:
    index: int

    def __add__(self, other):
        return LC.of(self) + other

    __radd__ = __add__

    def __sub__(self, other):
        return LC.of(self) - other

    def __rsub__(self, other):
        return LC.of(other) - LC.of(self)

    def __mul__(self, k: int):
        return LC.of(self) * k

    __rmul__ = __mul__


# ---------------------------------------------------------------------------
# input layout (r1cs/inputs.rs:280-348)
# ---------------------------------------------------------------------------

def build_input_layout(C: int, num_instructions: int) -> list[str]:
    names = ["bytecode_a", "bytecode_elf_address", "bytecode_bitflags",
             "bytecode_rs1", "bytecode_rs2", "bytecode_rd", "bytecode_imm",
             "ram_a", "rs1_read", "rs2_read", "rd_read"]
    names += [f"ram_read_{i}" for i in range(RAM_OPS_PER_INSTRUCTION)]
    names += ["rd_write"]
    names += [f"ram_write_{i}" for i in range(RAM_OPS_PER_INSTRUCTION)]
    names += [f"chunks_query_{i}" for i in range(C)]
    names += ["lookup_output"]
    names += [f"chunks_x_{i}" for i in range(C)]
    names += [f"chunks_y_{i}" for i in range(C)]
    names += [f"op_flag_{k}" for k in range(NUM_CIRCUIT_FLAGS)]
    names += [f"instr_flag_{k}" for k in range(num_instructions)]
    names += ["aux_left_lookup_operand", "aux_right_lookup_operand",
              "aux_imm_signed", "aux_product"]
    names += [f"aux_relevant_y_chunk_{i}" for i in range(C)]
    names += ["aux_write_lookup_output_to_rd", "aux_write_pc_to_rd",
              "aux_next_pc_jump", "aux_should_branch", "aux_next_pc"]
    return names


# ---------------------------------------------------------------------------
# builder (r1cs/builder.rs)
# ---------------------------------------------------------------------------

@dataclass
class AuxComputation:
    kind: str                # "if_else" | "prod"
    inputs: list[LC]


@dataclass
class OffsetEqConstraint:
    cond: tuple[LC, bool]
    a: tuple[LC, bool]
    b: tuple[LC, bool]


class R1CSBuilder:
    def __init__(self, layout: list[str]):
        self.layout = layout
        self.index = {n: i for i, n in enumerate(layout)}
        self.constraints: list[tuple[LC, LC, LC]] = []
        self.aux_computations: dict[int, AuxComputation] = {}

    def var(self, name: str) -> Var:
        return Var(self.index[name])

    def constrain_eq(self, left, right):
        self.constraints.append((LC.of(left) - LC.of(right), LC.of(1), LC()))

    def constrain_eq_conditional(self, condition, left, right):
        self.constraints.append((LC.of(condition),
                                 LC.of(left) - LC.of(right), LC()))

    def constrain_binary(self, value):
        v = LC.of(value)
        self.constraints.append((v, LC.of(1) - v, LC()))

    def constrain_if_else(self, condition, result_true, result_false, result):
        self.constraints.append((LC.of(condition),
                                 LC.of(result_true) - LC.of(result_false),
                                 LC.of(result) - LC.of(result_false)))

    def allocate_if_else(self, aux_name, condition, result_true, result_false):
        aux = self.var(aux_name)
        self.aux_computations[aux.index] = AuxComputation(
            "if_else", [LC.of(condition), LC.of(result_true),
                        LC.of(result_false)])
        self.constrain_if_else(condition, result_true, result_false, aux)
        return aux

    def constrain_prod(self, x, y, z):
        self.constraints.append((LC.of(x), LC.of(y), LC.of(z)))

    def allocate_prod(self, aux_name, x, y):
        aux = self.var(aux_name)
        self.aux_computations[aux.index] = AuxComputation(
            "prod", [LC.of(x), LC.of(y)])
        self.constrain_prod(x, y, aux)
        return aux

    @staticmethod
    def pack_le(vars_: list[Var], operand_bits: int) -> LC:
        return LC([(v.index, 1 << (i * operand_bits))
                   for i, v in enumerate(vars_)])

    @staticmethod
    def pack_be(vars_: list[Var], operand_bits: int) -> LC:
        return LC([(v.index, 1 << (i * operand_bits))
                   for i, v in enumerate(reversed(vars_))])

    def constrain_pack_be(self, vars_: list[Var], result, operand_bits: int):
        self.constrain_eq(self.pack_be(vars_, operand_bits), result)


# ---------------------------------------------------------------------------
# the RV32IM uniform circuit (r1cs/constraints.rs:61-276)
# ---------------------------------------------------------------------------

def build_jolt_constraints(layout: list[str], C: int, memory_start: int,
                           instr_flag_map: dict[str, int],
                           log_M: int = LOG_M
                           ) -> tuple[R1CSBuilder, list[OffsetEqConstraint]]:
    """instr_flag_map: instruction name -> index into the instruction set
    (e.g. {"add": 0, "sub": 1, ...}); constraints referencing instructions
    absent from the set are skipped (only relevant for reduced test VMs).

    log_M parameterizes the chunk widths (constraints.rs is written for the
    RV32I instantiation's LOG_M = 16; reduced test VMs use smaller tables,
    and the chunking constraints must match the witness generator's
    log_M-derived chunk sizes or honest witnesses fail — this bit round 1's
    mini-VM CLI path)."""
    cs = R1CSBuilder(layout)
    operand_size = log_M // 2
    num_instr = len([n for n in layout if n.startswith("instr_flag_")])

    def iflag(name):
        idx = instr_flag_map.get(name)
        return None if idx is None else cs.var(f"instr_flag_{idx}")

    def oflag(f: CircuitFlags):
        return cs.var(f"op_flag_{int(f)}")

    for k in range(num_instr):
        cs.constrain_binary(cs.var(f"instr_flag_{k}"))
    for k in range(NUM_CIRCUIT_FLAGS):
        cs.constrain_binary(cs.var(f"op_flag_{k}"))

    flags = ([cs.var(f"op_flag_{k}") for k in range(NUM_CIRCUIT_FLAGS)]
             + [cs.var(f"instr_flag_{k}") for k in range(num_instr)])
    cs.constrain_pack_be(flags, cs.var("bytecode_bitflags"), 1)

    real_pc = 4 * cs.var("bytecode_elf_address") + (PC_START_ADDRESS
                                                    - PC_NOOP_SHIFT)
    x = cs.allocate_if_else("aux_left_lookup_operand",
                            oflag(CircuitFlags.LeftOperandIsPC), real_pc,
                            cs.var("rs1_read"))
    y = cs.allocate_if_else("aux_right_lookup_operand",
                            oflag(CircuitFlags.RightOperandIsImm),
                            cs.var("bytecode_imm"), cs.var("rs2_read"))

    signed_output = cs.var("bytecode_imm") - (0xFFFFFFFF + 1)
    imm_signed = cs.allocate_if_else("aux_imm_signed",
                                     oflag(CircuitFlags.ImmSignBit),
                                     signed_output, cs.var("bytecode_imm"))

    is_load_or_store = oflag(CircuitFlags.Load) + oflag(CircuitFlags.Store)
    cs.constrain_eq_conditional(is_load_or_store,
                                cs.var("rs1_read") + imm_signed,
                                cs.var("ram_a") + memory_start)

    for i in range(RAM_OPS_PER_INSTRUCTION):
        cs.constrain_eq_conditional(oflag(CircuitFlags.Load),
                                    cs.var(f"ram_read_{i}"),
                                    cs.var(f"ram_write_{i}"))

    ram_writes = [cs.var(f"ram_write_{i}")
                  for i in range(RAM_OPS_PER_INSTRUCTION)]
    packed_load_store = R1CSBuilder.pack_le(ram_writes, 8)
    cs.constrain_eq_conditional(oflag(CircuitFlags.Store), packed_load_store,
                                cs.var("lookup_output"))

    query_chunks = [cs.var(f"chunks_query_{i}") for i in range(C)]
    packed_query = R1CSBuilder.pack_be(query_chunks, log_M)

    if iflag("add") is not None:
        cs.constrain_eq_conditional(iflag("add"), packed_query, x + y)
    if iflag("sub") is not None:
        cs.constrain_eq_conditional(iflag("sub"), packed_query,
                                    x - y + (0xFFFFFFFF + 1))
    mul_flags = [iflag(n) for n in ("mul", "mulu", "mulhu")
                 if iflag(n) is not None]
    product = cs.allocate_prod("aux_product", x, y)
    if mul_flags:
        is_mul = LC.of(mul_flags[0])
        for f in mul_flags[1:]:
            is_mul = is_mul + f
        cs.constrain_eq_conditional(is_mul, packed_query, product)
    move_flags = [iflag(n) for n in ("virtual_movsign", "virtual_move")
                  if iflag(n) is not None]
    if move_flags:
        is_move = LC.of(move_flags[0])
        for f in move_flags[1:]:
            is_move = is_move + f
        cs.constrain_eq_conditional(is_move, packed_query, x)
    cs.constrain_eq_conditional(oflag(CircuitFlags.Load), packed_query,
                                packed_load_store)
    cs.constrain_eq_conditional(oflag(CircuitFlags.Store), packed_query,
                                cs.var("rs2_read"))
    cs.constrain_eq_conditional(oflag(CircuitFlags.Assert),
                                cs.var("lookup_output"), 1)

    x_chunks = [cs.var(f"chunks_x_{i}") for i in range(C)]
    y_chunks = [cs.var(f"chunks_y_{i}") for i in range(C)]
    x_concat = R1CSBuilder.pack_be(x_chunks, operand_size)
    y_concat = R1CSBuilder.pack_be(y_chunks, operand_size)
    cs.constrain_eq_conditional(oflag(CircuitFlags.ConcatLookupQueryChunks),
                                x_concat, x)
    cs.constrain_eq_conditional(oflag(CircuitFlags.ConcatLookupQueryChunks),
                                y_concat, y)

    shift_flags = [iflag(n) for n in ("sll", "srl", "sra")
                   if iflag(n) is not None]
    is_shift = LC()
    for f in shift_flags:
        is_shift = is_shift + f
    for i in range(C):
        relevant = cs.allocate_if_else(f"aux_relevant_y_chunk_{i}", is_shift,
                                       y_chunks[C - 1], y_chunks[i])
        cs.constrain_eq_conditional(
            oflag(CircuitFlags.ConcatLookupQueryChunks), query_chunks[i],
            x_chunks[i] * (1 << operand_size) + relevant)

    rd_lookup = cs.allocate_prod("aux_write_lookup_output_to_rd",
                                 cs.var("bytecode_rd"),
                                 oflag(CircuitFlags.WriteLookupOutputToRD))
    cs.constrain_eq_conditional(rd_lookup, cs.var("rd_write"),
                                cs.var("lookup_output"))
    rd_jmp = cs.allocate_prod("aux_write_pc_to_rd", cs.var("bytecode_rd"),
                              oflag(CircuitFlags.Jump))
    cs.constrain_eq_conditional(
        rd_jmp, 4 * cs.var("bytecode_elf_address") + PC_START_ADDRESS,
        cs.var("rd_write"))

    next_pc_jump = cs.allocate_if_else(
        "aux_next_pc_jump", oflag(CircuitFlags.Jump),
        cs.var("lookup_output") + 4,
        4 * cs.var("bytecode_elf_address") + PC_START_ADDRESS + 4
        - 4 * oflag(CircuitFlags.DoNotUpdatePC))
    should_branch = cs.allocate_prod("aux_should_branch",
                                     oflag(CircuitFlags.Branch),
                                     cs.var("lookup_output"))
    cs.allocate_if_else(
        "aux_next_pc", should_branch,
        4 * cs.var("bytecode_elf_address") + PC_START_ADDRESS + imm_signed,
        next_pc_jump)

    non_uniform = [
        OffsetEqConstraint(
            cond=(LC.of(cs.var("bytecode_elf_address")), True),
            a=(LC.of(cs.var("aux_next_pc")), False),
            b=(4 * cs.var("bytecode_elf_address") + PC_START_ADDRESS, True)),
        OffsetEqConstraint(
            cond=(LC.of(oflag(CircuitFlags.Virtual)), False),
            a=(LC.of(cs.var("bytecode_a")), True),
            b=(cs.var("bytecode_a") + 1, False)),
    ]
    return cs, non_uniform


# ---------------------------------------------------------------------------
# device LC evaluation + aux computation
# ---------------------------------------------------------------------------

class _CoeffTable:
    """One upload of every distinct LC coefficient/constant of a
    constraint system, as Montgomery limb columns."""

    def __init__(self, spec: FieldSpec, values, device):
        self.spec = spec
        uniq = sorted({v % spec.p for v in values})
        self.index = {v: i for i, v in enumerate(uniq)}
        self.dev = fd.ints_to_device(spec, uniq, device) if uniq \
            else fd.zeros(spec, (1,), device)

    def col(self, value: int) -> torch.Tensor:
        return fd.col(self.dev, self.index[value % self.spec.p])


def _coeff_table_for(spec: FieldSpec, builder, device,
                     non_uniform=()) -> _CoeffTable:
    vals = []
    for cons in builder.constraints:
        for lc in cons:
            vals += [c for _, c in lc.terms] + [lc.const]
    for comp in builder.aux_computations.values():
        for lc in comp.inputs:
            vals += [c for _, c in lc.terms] + [lc.const]
    for oc in non_uniform:
        for lc, _off in (oc.cond, oc.a, oc.b):
            vals += [c for _, c in lc.terms] + [lc.const]
    return _CoeffTable(spec, vals, device)


def _lc_eval_dev(spec: FieldSpec, lc: LC, polys: list[torch.Tensor],
                 T: int, ctab: _CoeffTable) -> torch.Tensor:
    """sum_v c_v * polys[v] + const over [16, T]; unit coefficients are an
    add or a subtract instead of a multiply."""
    acc = None
    neg = []
    for v, c in lc.terms:
        cm = c % spec.p
        if cm == 1:
            term = polys[v]
        elif cm == spec.p - 1:
            neg.append(polys[v])
            continue
        else:
            term = fd.fmul(spec, polys[v], ctab.col(c)[:, None])
        acc = term if acc is None else fd.fadd(spec, acc, term)
    for t in neg:
        acc = fd.fneg(spec, t) if acc is None else fd.fsub(spec, acc, t)
    if lc.const % spec.p != 0 or acc is None:
        cst = ctab.col(lc.const)[:, None]
        acc = cst.expand(fd.L, T).contiguous() if acc is None \
            else fd.fadd(spec, acc, cst)
    return acc


def compute_aux(builder: R1CSBuilder, polys: list[torch.Tensor | None],
                T: int, spec: FieldSpec) -> None:
    """Fill the aux polynomials in index order (builder.rs:544-550)."""
    dev = next(p for p in polys if p is not None).device
    one_mont = fd.ones(spec, (1,), dev)
    ctab = _coeff_table_for(spec, builder, dev)
    for aux_index in sorted(builder.aux_computations.keys()):
        comp = builder.aux_computations[aux_index]
        vals = [_lc_eval_dev(spec, lc, polys, T, ctab) for lc in comp.inputs]
        if comp.kind == "prod":
            polys[aux_index] = fd.fmul(spec, vals[0], vals[1])
        else:  # if_else: condition == 1 ? true : false
            cond_is_one = torch.all(vals[0] == one_mont, dim=0)
            polys[aux_index] = fd.fselect(cond_is_one, vals[1], vals[2])


# ---------------------------------------------------------------------------
# sparse key (host) — verifier math (r1cs/key.rs)
# ---------------------------------------------------------------------------

@dataclass
class UniformSpartanKey:
    layout: list[str]
    constraints: list[tuple[LC, LC, LC]]
    non_uniform: list[OffsetEqConstraint]
    num_steps: int
    spec: FieldSpec

    def __post_init__(self):
        self.num_vars = len(self.layout)
        self.num_rows = len(self.constraints)
        self.num_cons_total = next_power_of_two(
            self.num_steps * (self.num_rows + len(self.non_uniform)))
        self.vk_digest = self._digest()

    def num_vars_total(self):
        return self.num_steps * next_power_of_two(self.num_vars)

    def num_cols_total(self):
        return 2 * self.num_vars_total()

    def num_rows_total(self):
        return self.num_cons_total

    def _digest(self) -> FElt:
        """Key digest (key.rs:397-430).  Deterministic commitment to the
        constraint system.  Default: Keccak over a canonical serialization
        of the sparse triples.  JOLT_REFERENCE_PARITY=1 switches to the
        reference's exact byte recipe — ark CanonicalSerialize-compressed
        UniformR1CS ‖ NonUniformR1CS ‖ num_steps u64 BE, hashed with
        SHA3-256 and mapped to the field via the low 250 bits LE
        (key.rs:397-428)."""
        if os.environ.get("JOLT_REFERENCE_PARITY", "") not in ("", "0"):
            return self._digest_ark_parity()
        h = b""
        for a, b, c in self.constraints:
            for lc in (a, b, c):
                for v, co in sorted(lc.terms):
                    h += v.to_bytes(4, "little") + (co % self.spec.p).to_bytes(32, "little")
                h += (lc.const % self.spec.p).to_bytes(32, "little")
        h += self.num_steps.to_bytes(8, "big")
        digest = keccak256(h)
        return FElt(int.from_bytes(digest, "little") & ((1 << 250) - 1),
                    self.spec)

    def _digest_ark_parity(self) -> FElt:
        """Reference-exact digest bytes (key.rs:397-428 + builder.rs
        materialize/materialize_offset_eq, ark-serialize compressed):

          UniformR1CS { a, b, c: SparseConstraints { vars: Vec<(u64, u64,
          Fr)>, consts: Vec<(u64, Fr)> }, num_vars: u64, num_rows: u64 }
          ‖ NonUniformR1CS { constraints: Vec<{ eq, condition:
          SparseEqualityItem { offset_vars: Vec<(u64, bool, Fr)>,
          constant: Fr } }> } ‖ num_steps u64 BE

        ark compressed: Vec = u64 LE length + elements, usize = u64 LE,
        bool = 1 byte, Fr = 32-byte LE canonical.  digest = SHA3-256;
        field value = sum_i bit_i 2^i over the low 250 bits (= LE int
        & (2^250 - 1)).  Term order within each LC follows the builder's
        construction order, mirroring constraints.rs."""
        p = self.spec.p
        fr = lambda v: (v % p).to_bytes(32, "little")
        u64 = lambda v: int(v).to_bytes(8, "little")

        def sparse(matrix_idx: int) -> bytes:
            var_rows = []
            const_rows = []
            for row, cons in enumerate(self.constraints):
                lc = cons[matrix_idx]
                for v, co in lc.terms:
                    var_rows.append(u64(row) + u64(v) + fr(co))
                if lc.const:
                    const_rows.append(u64(row) + fr(lc.const))
            return (u64(len(var_rows)) + b"".join(var_rows)
                    + u64(len(const_rows)) + b"".join(const_rows))

        out = sparse(0) + sparse(1) + sparse(2)
        out += u64(self.num_vars) + u64(self.num_rows)

        def eq_item(offset_vars, constant) -> bytes:
            body = b"".join(u64(v) + bytes([int(off)]) + fr(co)
                            for v, off, co in offset_vars)
            return u64(len(offset_vars)) + body + fr(constant)

        nu = u64(len(self.non_uniform))
        for oc in self.non_uniform:
            # eq: a's terms (flag a_offset) then (-b)'s terms (flag
            # b_offset); constant from -b (builder.rs:576-637)
            a_lc, a_off = oc.a
            b_lc, b_off = oc.b
            cond_lc, cond_off = oc.cond
            ov = [(v, a_off, co) for v, co in a_lc.terms] + \
                 [(v, b_off, -co) for v, co in b_lc.terms]
            nu += eq_item(ov, -b_lc.const)
            nu += eq_item([(v, cond_off, co) for v, co in cond_lc.terms],
                          cond_lc.const)
        out += nu
        out += self.num_steps.to_bytes(8, "big")
        digest = hashlib.sha3_256(out).digest()
        return FElt(int.from_bytes(digest, "little") & ((1 << 250) - 1),
                    self.spec)

    # -- prover: inner-sumcheck RLC vector (key.rs:176-283) ------------------
    def evaluate_r1cs_mle_rlc(self, r_constr: list[FElt], r_step: list[FElt],
                              r_rlc: FElt, device) -> torch.Tensor:
        """The RLC of the A, B, C rows at r_constr || r_step over all
        columns, [16, num_cols_total] on `device`.

        Column var * T + step holds eq(r_step, step) * A[var] +
        eq(r_step, step - 1) * B[var]: A[var] is the uniform rows'
        coefficient plus the non-uniform non-offset terms, B[var] the
        offset terms (they read step + 1).  The constant column holds the
        constants.  jolt_tpu builds the same vector entry by entry on the
        host."""
        spec = self.spec
        zero = FElt(0, spec)
        one = FElt(1, spec)
        eq_rx_constr = mle.eq_evals_host(r_constr)
        const_col = self.num_vars

        def compute_repeated(matrix_idx, non_uni_constants):
            evals = [zero] * (self.num_vars + 1)
            for row, (a, b, c) in enumerate(self.constraints):
                lc = (a, b, c)[matrix_idx]
                for v, co in lc.terms:
                    evals[v] = evals[v] + FElt(co, spec) * eq_rx_constr[row]
                if lc.const:
                    evals[const_col] = (evals[const_col]
                                        + FElt(lc.const, spec) * eq_rx_constr[row])
            if non_uni_constants is not None:
                for i, nc in enumerate(non_uni_constants):
                    evals[const_col] = (evals[const_col]
                                        + eq_rx_constr[self.num_rows + i] * nc)
            return evals

        eq_constants = [FElt(-oc.b[0].const % spec.p, spec)
                        for oc in self.non_uniform]
        cond_constants = [FElt(oc.cond[0].const, spec)
                          for oc in self.non_uniform]
        sm_a = compute_repeated(0, eq_constants)
        sm_b = compute_repeated(1, cond_constants)
        sm_c = compute_repeated(2, None)
        rlc2 = r_rlc * r_rlc
        sm_rlc = [a + r_rlc * b + rlc2 * c
                  for a, b, c in zip(sm_a, sm_b, sm_c)]

        at_step = list(sm_rlc[:self.num_vars])          # eq(r_step, step)
        at_prev = [zero] * self.num_vars                # eq(r_step, step - 1)
        for i, oc in enumerate(self.non_uniform):
            row_eq = eq_rx_constr[self.num_rows + i]
            neg_b = [(v, -c) for v, c in oc.b[0].terms]
            for terms, is_offset, r in ((oc.a[0].terms, oc.a[1], one),
                                        (neg_b, oc.b[1], one),
                                        (oc.cond[0].terms, oc.cond[1], r_rlc)):
                dst = at_prev if is_offset else at_step
                for v, co in terms:
                    dst[v] = dst[v] + r * FElt(co, spec) * row_eq

        T = self.num_steps
        eq = mle.eq_evals_device(spec, r_step, device)           # [16, T]
        eq_prev = torch.cat([fd.zeros(spec, (1,), device), eq[:, :-1]], dim=1)
        a = fd.ints_to_device(spec, [x.v for x in at_step], device)
        b = fd.ints_to_device(spec, [x.v for x in at_prev], device)
        block = fd.fadd(spec, fd.fmul(spec, a[:, :, None], eq[:, None, :]),
                        fd.fmul(spec, b[:, :, None], eq_prev[:, None, :]))
        half = self.num_vars_total()
        return torch.cat([
            block.reshape(fd.L, -1),
            fd.zeros(spec, (half - self.num_vars * T,), device),
            fd.ints_to_device(spec, [sm_rlc[const_col].v], device),
            fd.zeros(spec, (half - 1,), device)], dim=1)


    # -- verifier: Z and matrix MLEs (key.rs:284-395) -------------------------
    def evaluate_z_mle(self, segment_evals: list[FElt], r: list[FElt]) -> FElt:
        spec = self.spec
        one = FElt(1, spec)
        r_const = r[0]
        r_rest = r[1:]
        var_bits = log2_strict(next_power_of_two(self.num_vars))
        r_var = r_rest[:var_bits]
        r_var_eq = mle.eq_evals_host(r_var)
        eval_vars = FElt(0, spec)
        for i, ev in enumerate(segment_evals):
            eval_vars = eval_vars + r_var_eq[i] * ev
        # constant polynomial: 1 at index 0 of the second half
        eval_const = one
        for rv in r_rest:
            eval_const = eval_const * (one - rv)
        return (one - r_const) * eval_vars + r_const * eval_const

    def evaluate_r1cs_matrix_mles(self, r: list[FElt]
                                  ) -> tuple[FElt, FElt, FElt]:
        spec = self.spec
        one = FElt(1, spec)
        zero = FElt(0, spec)
        total_rows_bits = log2_strict(self.num_rows_total())
        total_cols_bits = log2_strict(self.num_cols_total())
        steps_bits = log2_strict(self.num_steps)
        constr_bits = log2_strict(next_power_of_two(self.num_rows + 1))
        ucb = log2_strict(next_power_of_two(self.num_vars))
        r_row, r_col = r[:total_rows_bits], r[total_rows_bits:]
        r_row_constr, r_row_step = r_row[:constr_bits], r_row[constr_bits:]
        r_col_var, r_col_step = r_col[:ucb + 1], r_col[ucb + 1:]

        eq_rx_ry_step = mle.eq_evaluate_host(r_row_step, r_col_step)
        eq_rx_constr = mle.eq_evals_host(r_row_constr)
        eq_ry_var = mle.eq_evals_host(r_col_var)

        # constant column bit vector
        const_idx = self.num_cols_total() // 2
        const_bits = [FElt((const_idx >> (total_cols_bits - 1 - i)) & 1, spec)
                      for i in range(total_cols_bits)]
        col_eq_constant = mle.eq_evaluate_host(r_col, const_bits)

        def compute_uniform(matrix_idx):
            total = zero
            const_total = zero
            for row, (a, b, c) in enumerate(self.constraints):
                lc = (a, b, c)[matrix_idx]
                for v, co in lc.terms:
                    total = total + FElt(co, spec) * eq_rx_constr[row] \
                        * eq_ry_var[v]
                if lc.const:
                    const_total = const_total + FElt(lc.const, spec) \
                        * eq_rx_constr[row]
            return total * eq_rx_ry_step + const_total * col_eq_constant

        a_mle = compute_uniform(0)
        b_mle = compute_uniform(1)
        c_mle = compute_uniform(2)

        eq_step_plus_one = _eq_plus_one(r_row_step, r_col_step, steps_bits,
                                        spec)

        def compute_non_uniform(terms: list[tuple[int, bool, int]],
                                constant: int) -> FElt:
            total = zero
            for v, is_offset, co in terms:
                e = eq_step_plus_one if is_offset else eq_rx_ry_step
                total = total + FElt(co, spec) * eq_ry_var[v] * e
            return total + FElt(constant, spec) * col_eq_constant

        for i, oc in enumerate(self.non_uniform):
            eq_terms = ([(v, oc.a[1], co) for v, co in oc.a[0].terms]
                        + [(v, oc.b[1], -co) for v, co in oc.b[0].terms])
            eq_const = -oc.b[0].const
            cond_terms = [(v, oc.cond[1], co) for v, co in oc.cond[0].terms]
            cond_const = oc.cond[0].const
            row_eq = eq_rx_constr[self.num_rows + i]
            a_mle = a_mle + compute_non_uniform(eq_terms, eq_const) * row_eq
            b_mle = b_mle + compute_non_uniform(cond_terms, cond_const) * row_eq
        return a_mle, b_mle, c_mle


def _eq_plus_one(x: list[FElt], y: list[FElt], l: int, spec) -> FElt:
    """eq(x, y+1) closed form (special_polys.rs:404-426)."""
    one = FElt(1, spec)
    total = FElt(0, spec)
    for k in range(l):
        lower = one
        for i in range(k):
            lower = lower * x[l - 1 - i] * (one - y[l - 1 - i])
        kth = (one - x[l - 1 - k]) * y[l - 1 - k]
        higher = one
        for i in range(k + 1, l):
            higher = higher * (x[l - 1 - i] * y[l - 1 - i]
                               + (one - x[l - 1 - i]) * (one - y[l - 1 - i]))
        total = total + lower * kth * higher
    return total



# ---------------------------------------------------------------------------
# Az/Bz/Cz materialization (device) + Spartan prove/verify
# ---------------------------------------------------------------------------

def compute_spartan_matrices(builder: R1CSBuilder,
                             non_uniform: list[OffsetEqConstraint],
                             polys: list[torch.Tensor], T: int,
                             spec: FieldSpec):
    """Dense Az/Bz/Cz tensors [16, R] (builder.rs:639-757); row-major
    (constraint-major) layout, offset-eq rows after the uniform rows."""
    dev = polys[0].device
    nc = len(builder.constraints)
    R = next_power_of_two(T * (nc + len(non_uniform)))
    ctab = _coeff_table_for(spec, builder, dev, non_uniform)
    zero_block = fd.zeros(spec, (T,), dev)
    az_blocks, bz_blocks, cz_blocks = [], [], []
    for a, b, c in builder.constraints:
        for lc, blocks in ((a, az_blocks), (b, bz_blocks), (c, cz_blocks)):
            if not lc.terms and lc.const == 0:
                blocks.append(zero_block)
            else:
                blocks.append(_lc_eval_dev(spec, lc, polys, T, ctab))

    def eval_offset(lc: LC, is_offset: bool) -> torch.Tensor:
        vals = _lc_eval_dev(spec, lc, polys, T, ctab)
        if is_offset:
            # value at step+1; the final step sees only the constant term
            vals = torch.cat([vals[:, 1:], ctab.col(lc.const)[:, None]], dim=1)
        return vals

    for oc in non_uniform:
        a_vals = eval_offset(oc.a[0], oc.a[1])
        b_vals = eval_offset(oc.b[0], oc.b[1])
        az_blocks.append(fd.fsub(spec, a_vals, b_vals))
        bz_blocks.append(eval_offset(oc.cond[0], oc.cond[1]))
        cz_blocks.append(zero_block)
    tail = [zero_block] * ((R - T * (nc + len(non_uniform))) // T)
    return tuple(torch.cat(blocks + tail, dim=1)
                 for blocks in (az_blocks, bz_blocks, cz_blocks))


def _outer_comb(spec, params):
    eq, az, bz, cz = params
    return fd.fmul(spec, eq, fd.fsub(spec, fd.fmul(spec, az, bz), cz))


def _inner_comb(spec, params):
    return fd.fmul(spec, params[0], params[1])


@dataclass
class UniformSpartanProof:
    outer_sumcheck_proof: SumcheckInstanceProof
    outer_sumcheck_claims: tuple[FElt, FElt, FElt]
    inner_sumcheck_proof: SumcheckInstanceProof
    claimed_witness_evals: list[FElt]


def spartan_prove(builder: R1CSBuilder,
                  non_uniform: list[OffsetEqConstraint],
                  key: UniformSpartanKey, polys: list[torch.Tensor], T: int,
                  opening_accumulator, transcript: Transcript,
                  spec: FieldSpec, mesh=None) -> UniformSpartanProof:
    """With `mesh`, the outer sumcheck's tensors split on the row axis
    (block layout: the outer sumcheck binds the bottom variable) and the
    inner sumcheck's on the column axis (cyclic: it binds the top one),
    as jolt_tpu's vm/r1cs.py:792-832 shards them."""
    dev = polys[0].device
    num_rounds_x = log2_strict(key.num_rows_total())
    num_rounds_y = log2_strict(key.num_cols_total())

    tau = transcript.challenge_vector(num_rounds_x)
    eq_tau = mle.eq_evals_device(spec, tau, dev)
    az, bz, cz = compute_spartan_matrices(builder, non_uniform, polys, T,
                                          spec)
    outer_polys = (eq_tau, az, bz, cz)
    if mesh is not None:
        outer_polys = shard_sumcheck_polys(mesh, outer_polys, order="bot")
    outer_proof, r_outer, outer_evals = prove_arbitrary_bot(
        num_rounds_x, outer_polys, _outer_comb, 3, transcript, spec,
        claim=FElt(0, spec))
    del outer_polys
    del eq_tau, az, bz, cz
    r_outer = list(reversed(r_outer))
    claim_az, claim_bz, claim_cz = outer_evals[1], outer_evals[2], outer_evals[3]
    transcript.append_scalars([claim_az, claim_bz, claim_cz])

    r_rlc = transcript.challenge_scalar()

    steps_bits = log2_strict(T)
    rx_con, rx_ts = r_outer[:-steps_bits], r_outer[-steps_bits:]
    poly_abc = key.evaluate_r1cs_mle_rlc(rx_con, rx_ts, r_rlc, dev)

    # Z: [vars (var-major) || pad || 1 || 0...]
    half = key.num_cols_total() // 2
    z = torch.cat(list(polys) + [
        fd.zeros(spec, (half - len(polys) * T,), dev),
        fd.ones(spec, (1,), dev),
        fd.zeros(spec, (half - 1,), dev)], dim=1)

    inner_polys = (poly_abc, z)
    if mesh is not None:
        inner_polys = shard_sumcheck_polys(mesh, inner_polys)
    inner_proof, r_inner, _ = prove_arbitrary(
        num_rounds_y, inner_polys, _inner_comb, 2, transcript, spec)
    del poly_abc, z, inner_polys

    n_prefix = log2_strict(next_power_of_two(key.num_vars)) + 1
    r_col_step = r_inner[n_prefix:]
    chi = mle.eq_evals_device(spec, r_col_step, dev)
    witness_evals = mle.evaluate_many_host(spec, polys, chi)
    opening_accumulator.append(polys, chi, r_col_step, witness_evals,
                               transcript)
    return UniformSpartanProof(outer_proof, (claim_az, claim_bz, claim_cz),
                               inner_proof, witness_evals)


def spartan_verify(proof: UniformSpartanProof, key: UniformSpartanKey,
                   commitments, opening_accumulator, transcript: Transcript,
                   spec: FieldSpec) -> None:
    num_rounds_x = log2_strict(key.num_rows_total())
    num_rounds_y = log2_strict(key.num_cols_total())

    tau = transcript.challenge_vector(num_rounds_x)
    claim_outer, r_x = proof.outer_sumcheck_proof.verify(
        FElt(0, spec), num_rounds_x, 3, transcript)
    r_x = list(reversed(r_x))
    claim_az, claim_bz, claim_cz = proof.outer_sumcheck_claims
    taus_bound_rx = mle.eq_evaluate_host(tau, r_x)
    if claim_outer != taus_bound_rx * (claim_az * claim_bz - claim_cz):
        raise VerificationError("Spartan outer sumcheck claim invalid")
    transcript.append_scalars([claim_az, claim_bz, claim_cz])

    r_rlc = transcript.challenge_scalar()
    claim_inner = claim_az + r_rlc * claim_bz + r_rlc * r_rlc * claim_cz
    claim_inner_final, r_inner = proof.inner_sumcheck_proof.verify(
        claim_inner, num_rounds_y, 2, transcript)

    n_prefix = log2_strict(next_power_of_two(key.num_vars)) + 1
    eval_z = key.evaluate_z_mle(proof.claimed_witness_evals, r_inner)
    eval_a, eval_b, eval_c = key.evaluate_r1cs_matrix_mles(r_x + list(r_inner))
    left = eval_a + r_rlc * eval_b + r_rlc * r_rlc * eval_c
    if claim_inner_final != left * eval_z:
        raise VerificationError("Spartan inner sumcheck claim invalid")

    # commitments None: Spartan checked alone (the EVM fixture), as
    # jolt_tpu/vm/r1cs.py:875 allows
    if commitments is not None:
        opening_accumulator.append(commitments, r_inner[n_prefix:],
                                   proof.claimed_witness_evals, transcript)
