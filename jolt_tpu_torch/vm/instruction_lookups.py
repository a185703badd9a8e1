"""Instruction lookups: Lasso for the zkVM "execute" stage.

Reference: jolt-core/src/jolt/vm/instruction_lookups.rs
(jolt_tpu/vm/instruction_lookups.py).

  * Preprocessing derives the memory layout from the union of each
    instruction's per-chunk subtable usage (instruction_lookups.rs:493-547).
  * Witness generation is vectorized numpy per instruction class: operand
    chunking, lookup outputs, per-memory access counters and subtable
    gathers; the polynomials then live on the device.
  * Primary sumcheck: sum_x eq(r,x) * [sum_i flag_i(x) * g_i(E(x)) - out(x)],
    degree = max g degree + 2 (instruction_lookups.rs:843-1065), with
    shrinking rounds and host Fiat-Shamir (jolt_tpu's CPU path).
  * Memory checking: the toggled grand product for read/write (flags gate
    the fingerprints), the dense one for init/final with the I F..F
    interleaving per subtable (instruction_lookups.rs:155-365).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import _native as nat
from ..field import arith
from ..field import device as fd
from ..field import kernels as fk
from ..field.host import FElt
from ..field.spec import FieldSpec, fr_spec
from ..lasso.memory_checking import MemoryCheckingProof, MultisetHashes
from ..lasso.surge import cumcount
from ..parallel import sharding as sh
from ..poly import mle
from ..poly.unipoly import CompressedUniPoly, UniPoly
from ..subprotocols import fs_device as fsd
from ..subprotocols.grand_product import (BatchedDenseGrandProduct,
                                          ToggledBatchedGrandProduct,
                                          _use_device_fs,
                                          toggled_verify_sumcheck_claim,
                                          verify_grand_product)
from ..subprotocols.sumcheck import SumcheckInstanceProof, VerificationError
from ..transcript import Transcript
from ..utils.math import log2_strict
from . import collation

PRIMARY_PROTOCOL = b"Jolt instruction lookups"
MEMCHECK_PROTOCOL = b"Instruction lookups check"


def memory_layout(instruction_classes, subtables, C: int, M: int):
    """The memories of a lookup set (instruction_lookups.rs:493-547): one
    per (subtable, chunk index) that some instruction reads, numbered
    subtable by subtable in the canonical subtable order.  Returns
    (subtable_to_memory_indices, memory_to_subtable_index,
    memory_to_dimension_index, instruction_to_memory_indices)."""
    sub_enum = {s.key(): i for i, s in enumerate(subtables)}
    # union of chunk indices per subtable
    subtable_chunks = [set() for _ in subtables]
    for cls in instruction_classes:
        for sub, indices in cls().subtables(C, M):
            subtable_chunks[sub_enum[sub.key()]].update(indices)
    sub_to_mems, mem_to_sub, mem_to_dim = [], [], []
    mem = 0
    for s_idx, chunks in enumerate(subtable_chunks):
        dims = sorted(chunks)
        sub_to_mems.append(list(range(mem, mem + len(dims))))
        mem_to_sub.extend([s_idx] * len(dims))
        mem_to_dim.extend(dims)
        mem += len(dims)
    instr_to_mems = []
    for cls in instruction_classes:
        mems = []
        for sub, indices in cls().subtables(C, M):
            for m_idx in sub_to_mems[sub_enum[sub.key()]]:
                if mem_to_dim[m_idx] in indices:
                    mems.append(m_idx)
        instr_to_mems.append(mems)
    return sub_to_mems, mem_to_sub, mem_to_dim, instr_to_mems


class InstructionLookupsPreprocessing:
    """Memory layout + materialized subtables (instruction_lookups.rs:482-561),
    the subtables on `device`."""

    def __init__(self, instruction_classes, subtable_order, C: int, M: int,
                 device, spec: FieldSpec | None = None):
        self.spec = spec or fr_spec()
        self.device = device
        self.instruction_classes = list(instruction_classes)
        self.C, self.M = C, M
        self.num_instructions = len(self.instruction_classes)

        self.subtables = list(subtable_order)
        self.num_subtables = len(self.subtables)
        (self.subtable_to_memory_indices, self.memory_to_subtable_index,
         self.memory_to_dimension_index, self.instruction_to_memory_indices
         ) = memory_layout(self.instruction_classes, self.subtables, C, M)
        self.num_memories = len(self.memory_to_subtable_index)

        self.subtable_entries = np.stack(
            [s.materialize_entries(M) for s in self.subtables])  # [S, M]
        self.subtable_dev = fd.u64_to_mont_device(
            self.spec, self.subtable_entries, device)            # [16, S, M]

        self.max_g_degree = max(cls().g_poly_degree(C)
                                for cls in self.instruction_classes)
        self.sumcheck_degree = self.max_g_degree + 2


@dataclass
class InstructionLookupPolynomials:
    dim: torch.Tensor                # [16, C, T]
    read_cts: torch.Tensor           # [16, m, T]
    final_cts: torch.Tensor          # [16, m, M]
    E_polys: torch.Tensor            # [16, m, T]
    instruction_flags: torch.Tensor  # [16, NI, T]
    lookup_outputs: torch.Tensor     # [16, T]
    instruction_flag_bits: np.ndarray  # [NI, T] u8 (host)
    memory_flags: torch.Tensor         # [m, T] bool (device)

    def read_write_values(self) -> list[torch.Tensor]:
        """Canonical ordering: dim || read_cts || E || flags || outputs."""
        out = [fd.col(self.dim, i) for i in range(self.dim.shape[1])]
        out += [fd.col(self.read_cts, i) for i in range(self.read_cts.shape[1])]
        out += [fd.col(self.E_polys, i) for i in range(self.E_polys.shape[1])]
        out += [fd.col(self.instruction_flags, i)
                for i in range(self.instruction_flags.shape[1])]
        out.append(self.lookup_outputs)
        return out

    def init_final_values(self) -> list[torch.Tensor]:
        return [fd.col(self.final_cts, i) for i in range(self.final_cts.shape[1])]


def generate_witness(pre: InstructionLookupsPreprocessing,
                     instr_idx: np.ndarray, x: np.ndarray, y: np.ndarray
                     ) -> InstructionLookupPolynomials:
    """Vectorized witness generation (instruction_lookups.rs:728-825).

    instr_idx[j]: index into pre.instruction_classes, or -1 for steps with
    no instruction lookup (padding no-ops).  Arrays are already padded to a
    power-of-two length."""
    C, M = pre.C, pre.M
    log_M = log2_strict(M)
    T = len(instr_idx)
    NI = pre.num_instructions
    m = pre.num_memories

    dim_all = np.zeros((C, T), dtype=np.uint64)
    outputs = np.zeros(T, dtype=np.uint64)
    flag_bits = np.zeros((NI, T), dtype=np.uint8)
    for k, cls in enumerate(pre.instruction_classes):
        mask = instr_idx == k
        if not mask.any():
            continue
        flag_bits[k][mask] = 1
        dim_all[:, mask] = cls.to_indices_vec(x[mask], y[mask], C, log_M)
        outputs[mask] = cls.lookup_entry_vec(x[mask], y[mask])

    mem_flag_bits = np.zeros((m, T), dtype=np.uint8)
    for k in range(NI):
        for mi in pre.instruction_to_memory_indices[k]:
            mem_flag_bits[mi] |= flag_bits[k]

    read_cts = np.zeros((m, T), dtype=np.uint64)
    final_cts = np.zeros((m, M), dtype=np.uint64)
    E_host = np.zeros((m, T), dtype=np.uint64)
    for mi in range(m):
        active = mem_flag_bits[mi] == 1
        d = pre.memory_to_dimension_index[mi]
        s = pre.memory_to_subtable_index[mi]
        addrs = dim_all[d][active].astype(np.int64)
        if addrs.size:
            rc, fc = cumcount(addrs, M)
            read_cts[mi][active] = rc
            final_cts[mi] = fc
            E_host[mi][active] = pre.subtable_entries[s][addrs]

    spec, dev = pre.spec, pre.device
    to_dev = lambda arr: fd.u64_to_mont_device(spec, arr, dev)  # noqa: E731
    return InstructionLookupPolynomials(
        dim=to_dev(dim_all),
        read_cts=to_dev(read_cts),
        final_cts=to_dev(final_cts),
        E_polys=to_dev(E_host),
        instruction_flags=to_dev(flag_bits.astype(np.uint64)),
        lookup_outputs=to_dev(outputs),
        instruction_flag_bits=flag_bits,
        memory_flags=torch.from_numpy(mem_flag_bits.astype(bool)).to(dev),
    )


# ---------------------------------------------------------------------------
# primary sumcheck
# ---------------------------------------------------------------------------

# The round kernel (csrc/collate.cu `primary_round_kernel`): a round's
# evaluations in one launch, in place of jolt_tpu's split, extrapolation,
# per-instruction g-term and finisher programs
PRIMARY_ROUND = nat.CudaKernel(
    "primary_round", "collate", "jt_primary_round",
    [nat.vptr] * 4 + [nat.i64] * 15 + [nat.vptr] * 3 + [nat.i64] * 4
    + [nat.vptr] * 3 + [nat.u32p, nat.vptr],
    "jolt_tpu/vm/instruction_lookups.py:279-309 "
    "_primary_round_evals_decomposed (jax.jit: _primary_split_jit :235, "
    "_primary_ext_jit :249, _g_term_jit :258, _point_finish_jit :268)",
    "primary_round_kernel", 256)


def primary_finish_plain(spec: FieldSpec, eq: torch.Tensor, out: torch.Tensor,
                         inner: torch.Tensor) -> torch.Tensor:
    """sum_i eq[i] * (inner[i] - out[i]) mod p over [16, h] -> [16]: fsum
    (fmul(eq, fsub(inner, out))) in plain limb arithmetic (jolt_tpu's
    `_point_finish_jit` with the mask's h the whole half)."""
    return arith.sum_limbs(spec, arith.mont_mul(spec, eq, arith.sub(
        spec, inner, out)), -1)


def primary_round_plain(pre: InstructionLookupsPreprocessing, eq, out, fl, e
                        ) -> torch.Tensor:
    """Round evaluations at t = 0..degree -> [16, degree + 1] (jolt_tpu's
    `_primary_round_evals_decomposed`, shrinking arrays) in plain limb
    arithmetic: the top variable split into lo/hi halves (views), points
    t >= 2 extrapolated by adding hi - lo, and at each point the
    collations through the group plan (collation.collate_grouped_plain)
    and the finisher sum_i eq_t * (inner - out_t)."""
    spec = pre.spec
    h = eq.shape[-1] // 2
    lo = [t[..., :h] for t in (eq, out, fl, e)]
    hi = [t[..., h:] for t in (eq, out, fl, e)]
    diff = [arith.sub(spec, b, a) for a, b in zip(lo, hi)]
    evals = []
    cur = lo
    for t in range(pre.sumcheck_degree + 1):
        if t == 1:
            cur = hi
        elif t >= 2:
            cur = [arith.add(spec, c, d) for c, d in zip(cur, diff)]
        eq_t, out_t, f_t, e_t = cur
        evals.append(primary_finish_plain(
            spec, eq_t, out_t, collation.collate_grouped_plain(pre, e_t,
                                                               f_t)))
    return torch.stack(evals, dim=1)


STAGE_COST = 0.25     # a round block's staging, in points' work (the
#   round plan's cost model: a point of rv32i_vm()'s rows is some 10 us of
#   an SM at h = 2^15, its stage some 2-3 us)


def round_plan(pre, n: int) -> tuple[int, int, int, int]:
    """The round kernel's grid for a hypercube of n = 2h entries: (points,
    split, tiles of 32 elements, blocks = tiles x split).  Each tile is
    shared by `split` blocks, block b of them taking the points b, b +
    split, ...; split is the one whose waves of one block an SM, each as
    long as its block's points and stage, end first (the smaller on a
    tie): at h = 2^15 one block a tile walks every point, at the last
    rounds the points run side by side."""
    points = pre.sumcheck_degree + 1
    tiles = -(-(n // 2) // 32)

    def cost(split):
        return -(-tiles * split // fk.H100_SMS) * (-(-points // split)
                                                   + STAGE_COST)

    split = min(range(1, points + 1), key=lambda s: (cost(s), s))
    return points, split, tiles, tiles * split


def _strides3(t: torch.Tensor) -> tuple[int, int, int]:
    """(limb, column, element) strides of [16, n] or [16, c, n]."""
    if t.dim() == 2:
        return t.stride(0), 0, t.stride(1)
    return t.stride(0), t.stride(1), t.stride(2)


def primary_round(pre: InstructionLookupsPreprocessing, eq, out, fl, e
                  ) -> torch.Tensor:
    """primary_round_plain's function: on CUDA tensors one launch of the
    round kernel, which extrapolates, collates, finishes and sums every
    point (eq, out [16, 2h], flags [16, NI, 2h], E [16, m, 2h], views with
    any strides, a mesh shard's included); the plain version on CPU
    tensors.  Returns [16, degree + 1], reduced."""
    if all(t.device.type == "cpu" for t in (eq, out, fl, e)):
        return primary_round_plain(pre, eq, out, fl, e)
    nat.require_cuda("primary_round", eq, out, fl, e)
    prog = collation.program(pre)
    collation.check_operands("primary_round", prog, e, fl)
    n = eq.shape[-1]
    if eq.dim() != 2 or eq.shape[0] != fd.L or out.shape != eq.shape or \
            e.shape[2] != n or n < 2 or n % 2:
        raise ValueError(f"primary_round: expected eq, out [16, n], n even, "
                         f"and flags, E [16, *, n], got "
                         f"{[tuple(t.shape) for t in (eq, out, fl, e)]}")
    plan = prog.plan
    points, split, tiles, _ = round_plan(pre, n)
    res = torch.empty((fd.L, points), dtype=torch.int32, device=eq.device)
    rows, meta, consts = plan.tables(pre.spec, eq.device)
    # a partial per (point, tile) and one ticket: one row of points * tiles
    # chunks (points >= 3, so sum_scratch allocates both)
    partials, counter = fk.sum_scratch(eq, 1, points * tiles)
    PRIMARY_ROUND.launch(
        nat.ptr(eq), nat.ptr(out), nat.ptr(fl), nat.ptr(e),
        *_strides3(eq), *_strides3(out), *_strides3(fl), *_strides3(e),
        n // 2, points, split, nat.ptr(rows), nat.ptr(meta), nat.ptr(consts),
        plan.n_groups, len(plan.stage), consts.shape[1], plan.n_slots,
        partials, counter, nat.ptr(res), fk.field_words(pre.spec),
        nat.stream(res), device=res.device)
    return res


# ---------------------------------------------------------------------------
# leaves (memory checking)
# ---------------------------------------------------------------------------

def _scalar(x: torch.Tensor, ndim: int) -> torch.Tensor:
    return x.reshape((fd.L,) + (1,) * ndim)


def _il_rw_leaves(spec: FieldSpec, mem_to_dim, dim, read_cts, E, gamma, tau):
    """Interleaved read/write fingerprints [16, 2m, T]
    (instruction_lookups.rs:183-218); read_cts indexed per MEMORY."""
    g2 = _scalar(fd.fmul(spec, gamma, gamma), 2)
    g, t = _scalar(gamma, 2), _scalar(tau, 2)
    dim_g = dim.index_select(1, torch.tensor(mem_to_dim, device=dim.device))
    read_fp = fd.fadd(spec,
                      fd.fadd(spec, fd.fmul(spec, read_cts, g2),
                              fd.fmul(spec, E, g)),
                      fd.fsub(spec, dim_g, t))
    write_fp = fd.fadd(spec, read_fp, g2)
    return torch.stack([read_fp, write_fp], dim=2).reshape(
        fd.L, 2 * read_fp.shape[1], read_fp.shape[2])


def _il_if_leaves(spec: FieldSpec, sub_to_mems, subtables, final_cts,
                  identity, gamma, tau):
    """Init/final leaves ordered I F..F per subtable -> [16, S+m, M]
    (instruction_lookups.rs:220-260)."""
    g2 = _scalar(fd.fmul(spec, gamma, gamma), 2)
    g, t = _scalar(gamma, 2), _scalar(tau, 2)
    init = fd.fadd(spec, fd.fmul(spec, subtables, g),
                   fd.fsub(spec, identity[:, None, :], t))      # [16, S, M]
    sel = torch.tensor([s for s, mems in enumerate(sub_to_mems) for _ in mems],
                       device=subtables.device)
    finals = fd.fadd(spec, init.index_select(1, sel),
                     fd.fmul(spec, final_cts, g2))              # [16, m, M]
    layers, pos = [], 0
    for s, mems in enumerate(sub_to_mems):
        layers.append(init[:, s:s + 1])
        layers.append(finals[:, pos:pos + len(mems)])
        pos += len(mems)
    return torch.cat(layers, dim=1)


# ---------------------------------------------------------------------------
# proof structures + prover / verifier
# ---------------------------------------------------------------------------

@dataclass
class PrimarySumcheckOpenings:
    E_poly_openings: list[FElt]
    flag_openings: list[FElt]
    lookup_outputs_opening: FElt


@dataclass
class PrimarySumcheck:
    sumcheck_proof: SumcheckInstanceProof
    num_rounds: int
    openings: PrimarySumcheckOpenings


@dataclass
class InstructionLookupsProof:
    primary_sumcheck: PrimarySumcheck
    memory_checking: MemoryCheckingProof


def _combine_lookups_host(pre: InstructionLookupsPreprocessing,
                          vals: list[FElt], flags: list[FElt]) -> FElt:
    """sum_i flag_i * g_i(E[mems_i]) (instruction_lookups.rs:1081-1104)."""
    total = FElt(0, pre.spec)
    for k, cls in enumerate(pre.instruction_classes):
        operands = [vals[mi] for mi in pre.instruction_to_memory_indices[k]]
        total = total + flags[k] * cls().combine_lookups(operands, pre.C, pre.M)
    return total


def _felts(spec: FieldSpec, a: torch.Tensor) -> list[FElt]:
    return [FElt(int(v), spec) for v in fd.device_to_ints(spec, a).tolist()]


def prove_instruction_lookups(pre: InstructionLookupsPreprocessing,
                              polys: InstructionLookupPolynomials,
                              opening_accumulator, transcript: Transcript,
                              mesh=None) -> InstructionLookupsProof:
    """With `mesh`, the primary sumcheck's tensors are split on the
    hypercube (T) axis and the memory checking's grand products on their
    batch axis (jolt_tpu's instruction_lookups.py:400-431, 534-554)."""
    spec, dev = pre.spec, pre.device
    transcript.append_protocol_name(PRIMARY_PROTOCOL)

    T = polys.dim.shape[-1]
    num_rounds = log2_strict(T)
    r_eq = transcript.challenge_vector(num_rounds)
    eq = mle.eq_evals_device(spec, r_eq, dev)
    out, fl, e = polys.lookup_outputs, polys.instruction_flags, polys.E_polys
    if mesh is not None:
        eq, out, fl, e = (sh.maybe_shard_hypercube(mesh, t)
                          for t in (eq, out, fl, e))

    def round_evals(eq, out, fl, e):
        return sh.round_evals(
            spec, lambda *ts: primary_round(pre, *ts), (eq, out, fl, e))

    def bind(ts, r):
        return sh.bind_hypercube(spec, ts, r, mle.bind_top)

    r_primary: list[FElt] = []
    compressed: list[CompressedUniPoly] = []
    if num_rounds > 0 and _use_device_fs(dev):
        # device Fiat-Shamir (jolt_tpu's instruction_lookups.py:443-468):
        # the rounds chain through the device, one pull and a host replay
        state = fsd.state_to_device(transcript, dev)
        prev = fd.zeros(spec, (), dev)
        comps = []
        for _ in range(num_rounds):
            evals = round_evals(eq, out, fl, e)
            comp, rj, prev, state = fsd.fs_round(
                spec, evals, prev, state, pre.sumcheck_degree, False)
            eq, out, fl, e = bind((eq, out, fl, e), rj)
            comps.append(comp)
        compressed, r_primary = fsd.replay_and_check(
            spec, fd.device_to_ints(spec, torch.stack(comps, dim=1)).tolist(),
            transcript, state, CompressedUniPoly,
            "InstructionLookups::primary_sumcheck")
    for _ in range(num_rounds - len(compressed)):
        evals = _felts(spec, round_evals(eq, out, fl, e))
        round_poly = UniPoly.from_evals(evals)
        cpoly = round_poly.compress()
        cpoly.append_to_transcript(transcript)
        r_j = transcript.challenge_scalar()
        r_primary.append(r_j)
        rv = fd.scalar_to_device(spec, r_j.v, dev)
        eq, out, fl, e = bind((eq, out, fl, e), rv)
        compressed.append(cpoly)

    e, fl, out = (sh.unshard(t) for t in (e, fl, out))
    finals = _felts(spec, torch.cat([e[..., 0], fl[..., 0], out[..., :1]],
                                    dim=1))
    m = pre.num_memories
    E_evals, flag_evals, outputs_eval = finals[:m], finals[m:-1], finals[-1]
    openings = PrimarySumcheckOpenings(E_evals, flag_evals, outputs_eval)
    # opening accumulation for E || flags || outputs (active in the fork)
    primary_polys = ([fd.col(polys.E_polys, i) for i in range(m)]
                     + [fd.col(polys.instruction_flags, i)
                        for i in range(pre.num_instructions)]
                     + [polys.lookup_outputs])
    opening_accumulator.append(primary_polys,
                               mle.eq_evals_device(spec, r_primary, dev),
                               r_primary, finals, transcript)

    primary = PrimarySumcheck(SumcheckInstanceProof(compressed), num_rounds,
                              openings)
    mc_proof = _prove_memory_checking(pre, polys, transcript, mesh)
    return InstructionLookupsProof(primary, mc_proof)


def _prove_memory_checking(pre, polys, transcript: Transcript, mesh=None
                           ) -> MemoryCheckingProof:
    spec, dev = pre.spec, pre.device
    gamma = transcript.challenge_scalar()
    tau = transcript.challenge_scalar()
    transcript.append_protocol_name(MEMCHECK_PROTOCOL)

    g = fd.scalar_to_device(spec, gamma.v, dev)
    t = fd.scalar_to_device(spec, tau.v, dev)
    rw_leaves = _il_rw_leaves(spec, pre.memory_to_dimension_index, polys.dim,
                              polys.read_cts, polys.E_polys, g, t)
    identity = fd.u64_to_mont_device(spec, np.arange(pre.M, dtype=np.uint64),
                                     dev)
    if_leaves = _il_if_leaves(spec, pre.subtable_to_memory_indices,
                              pre.subtable_dev, polys.final_cts, identity, g, t)

    rw_circuit = ToggledBatchedGrandProduct(polys.memory_flags, rw_leaves, spec,
                                            mesh=mesh)
    if_circuit = BatchedDenseGrandProduct.construct(if_leaves, spec,
                                                    mesh=mesh)
    del rw_leaves, if_leaves   # the pair trees hold their own copies
    hashes = _uninterleave_hashes(pre, rw_circuit.claims(), if_circuit.claims())
    _check_multiset_equality(pre, hashes)
    hashes.append_to_transcript(transcript)

    rw_proof, _ = rw_circuit.prove(transcript)
    if_proof, _ = if_circuit.prove(transcript)
    return MemoryCheckingProof(hashes, rw_proof, if_proof)


def _uninterleave_hashes(pre, rw: list[FElt], inf: list[FElt]) -> MultisetHashes:
    init_hashes, final_hashes = [], []
    it = iter(inf)
    for s in range(pre.num_subtables):
        init_hashes.append(next(it))
        for _ in pre.subtable_to_memory_indices[s]:
            final_hashes.append(next(it))
    return MultisetHashes(rw[0::2], rw[1::2], init_hashes, final_hashes)


def _interleave_hashes(pre, h: MultisetHashes):
    rw = [x for pair in zip(h.read_hashes, h.write_hashes) for x in pair]
    inf = []
    for s in range(pre.num_subtables):
        inf.append(h.init_hashes[s])
        for mi in pre.subtable_to_memory_indices[s]:
            inf.append(h.final_hashes[mi])
    return rw, inf


def _check_multiset_equality(pre, h: MultisetHashes):
    for i in range(pre.num_memories):
        init = h.init_hashes[pre.memory_to_subtable_index[i]]
        if init * h.write_hashes[i] != h.final_hashes[i] * h.read_hashes[i]:
            raise VerificationError(f"multiset hashes don't match (memory {i})")


def verify_instruction_lookups(pre: InstructionLookupsPreprocessing,
                               proof: InstructionLookupsProof,
                               commitments, opening_accumulator,
                               transcript: Transcript) -> None:
    spec = pre.spec
    transcript.append_protocol_name(PRIMARY_PROTOCOL)
    num_rounds = proof.primary_sumcheck.num_rounds
    r_eq = transcript.challenge_vector(num_rounds)

    claim_last, r_primary = proof.primary_sumcheck.sumcheck_proof.verify(
        FElt(0, spec), num_rounds, pre.sumcheck_degree, transcript)

    eq_eval = mle.eq_evaluate_host(r_eq, r_primary)
    op = proof.primary_sumcheck.openings
    combined = _combine_lookups_host(pre, op.E_poly_openings, op.flag_openings)
    if eq_eval * (combined - op.lookup_outputs_opening) != claim_last:
        raise VerificationError("instruction lookups primary sumcheck failed")

    cs = (list(commitments["E"]) + list(commitments["flags"])
          + [commitments["outputs"]])
    opening_accumulator.append(
        cs, r_primary,
        op.E_poly_openings + op.flag_openings + [op.lookup_outputs_opening],
        transcript)

    # memory checking
    transcript.challenge_scalar()   # gamma
    transcript.challenge_scalar()   # tau
    transcript.append_protocol_name(MEMCHECK_PROTOCOL)
    h = proof.memory_checking.multiset_hashes
    _check_multiset_equality(pre, h)
    h.append_to_transcript(transcript)
    rw_hashes, if_hashes = _interleave_hashes(pre, h)

    verify_grand_product(proof.memory_checking.read_write_grand_product,
                         rw_hashes, transcript,
                         verify_sumcheck_claim=toggled_verify_sumcheck_claim)
    verify_grand_product(proof.memory_checking.init_final_grand_product,
                         if_hashes, transcript)
    # Fork parity: opening appends + fingerprint checks disabled
    # (memory_checking.rs:546-586).
