"""Surge: standalone Lasso lookup argument for a single instruction type.

Reference: lasso/surge.rs.  Proves that N lookups into a decomposable table
(C chunks x M-entry subtables) were performed correctly:
  1. commit dim / read_cts / final_cts / E polynomials
  2. primary sumcheck:  claim = sum_x eq(r, x) * g(E_0(x), ..., E_{m-1}(x))
  3. offline memory checking of the E reads against the subtables

Witness generation is vectorized numpy (counters by argsort cumcount,
subtable gathers by indexing); the polynomials, the fingerprint leaves
and every round of both protocols live on the device.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .._device import resolve_device
from ..commitment.base import BatchType
from ..field import device as fd
from ..field.generic import DevF
from ..field.host import FElt
from ..field.spec import FieldSpec, fr_spec
from ..parallel.sharding import shard_sumcheck_polys
from ..poly import mle
from ..subprotocols.sumcheck import (SumcheckInstanceProof, VerificationError,
                                     prove_arbitrary)
from ..transcript import Transcript
from ..utils.math import log2_strict, next_power_of_two
from .memory_checking import MemoryCheckingProof, MemoryCheckingProver


def cumcount(addresses: np.ndarray, M: int) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized per-address access counters.

    Returns (read_cts [N], final_cts [M]): read_cts[i] = #previous accesses
    to addresses[i]; final_cts[a] = total accesses to a (surge.rs:556-582).
    """
    a = np.asarray(addresses, dtype=np.int64)
    order = np.argsort(a, kind="stable")
    sorted_a = a[order]
    idx = np.arange(len(a), dtype=np.int64)
    is_start = np.ones(len(a), dtype=bool)
    is_start[1:] = sorted_a[1:] != sorted_a[:-1]
    group_start = np.maximum.accumulate(np.where(is_start, idx, 0))
    read_cts = np.empty(len(a), dtype=np.uint64)
    read_cts[order] = (idx - group_start).astype(np.uint64)
    final_cts = np.bincount(a, minlength=M).astype(np.uint64)
    return read_cts, final_cts


class SurgePreprocessing:
    """Materialized subtables (surge.rs:528-547), on `device` (default:
    the CUDA card; pass device="cpu" for a CPU run)."""

    def __init__(self, instruction_cls, C: int, M: int,
                 spec: FieldSpec | None = None, device=None):
        self.device = resolve_device(device)
        self.spec = spec or fr_spec()
        self.instruction_cls = instruction_cls
        self.C = C
        self.M = M
        instr = instruction_cls()
        self.subtable_list = [s for s, _ in instr.subtables(C, M)]
        self.num_subtables = len(self.subtable_list)
        self.num_memories = C * self.num_subtables
        self.subtable_entries = np.stack(
            [s.materialize_entries(M) for s in self.subtable_list])  # [S, M]
        self.subtable_dev = fd.u64_to_mont_device(
            self.spec, self.subtable_entries, self.device)           # [16, S, M]

    def memory_to_subtable_index(self, i: int) -> int:
        return i // self.C

    def memory_to_dimension_index(self, i: int) -> int:
        return i % self.C


@dataclass
class SurgePolynomials:
    dim: torch.Tensor        # [16, C, n]
    read_cts: torch.Tensor   # [16, C, n]
    final_cts: torch.Tensor  # [16, C, M]
    E_polys: torch.Tensor    # [16, m, n]

    def read_write_values(self) -> list[torch.Tensor]:
        """Canonical ordering: dim || read_cts || E (surge.rs:73-80)."""
        return ([fd.col(self.dim, i) for i in range(self.dim.shape[1])]
                + [fd.col(self.read_cts, i) for i in range(self.read_cts.shape[1])]
                + [fd.col(self.E_polys, i) for i in range(self.E_polys.shape[1])])

    def init_final_values(self) -> list[torch.Tensor]:
        return [fd.col(self.final_cts, i) for i in range(self.final_cts.shape[1])]


@dataclass
class SurgePrimarySumcheck:
    sumcheck_proof: SumcheckInstanceProof
    num_rounds: int
    claimed_evaluation: FElt
    E_poly_openings: list[FElt]


@dataclass
class SurgeProof:
    commitments: list
    final_commitments: list
    primary_sumcheck: SurgePrimarySumcheck
    memory_checking: MemoryCheckingProof
    C: int
    M: int


# ---------------------------------------------------------------------------
# device leaves and combine
# ---------------------------------------------------------------------------

def _scalar(x: torch.Tensor, ndim: int) -> torch.Tensor:
    """A limb vector [16] as [16, 1, ...] for broadcasting over ndim dims."""
    return x.reshape((fd.L,) + (1,) * ndim)


def _surge_rw_leaves(spec: FieldSpec, mem_to_dim, dim, read_cts, E, gamma,
                     tau) -> torch.Tensor:
    """Interleaved read/write fingerprint leaves [16, 2m, n] (surge.rs:125-144)."""
    g2 = _scalar(fd.fmul(spec, gamma, gamma), 2)
    g, t = _scalar(gamma, 2), _scalar(tau, 2)
    sel = torch.tensor(mem_to_dim, device=dim.device)
    dim_g = dim.index_select(1, sel)                       # [16, m, n]
    cts_g = read_cts.index_select(1, sel)
    read_fp = fd.fadd(spec,
                      fd.fadd(spec, fd.fmul(spec, cts_g, g2),
                              fd.fmul(spec, E, g)),
                      fd.fsub(spec, dim_g, t))
    write_fp = fd.fadd(spec, read_fp, g2)
    return torch.stack([read_fp, write_fp], dim=2).reshape(
        fd.L, 2 * read_fp.shape[1], read_fp.shape[2])


def _surge_if_leaves(spec: FieldSpec, mem_to_dim, mem_to_sub, subtables,
                     final_cts, identity, gamma, tau) -> torch.Tensor:
    """Interleaved init/final fingerprint leaves [16, 2m, M] (surge.rs:146-176)."""
    g2 = _scalar(fd.fmul(spec, gamma, gamma), 2)
    g, t = _scalar(gamma, 2), _scalar(tau, 2)
    dev = subtables.device
    tbl = subtables.index_select(1, torch.tensor(mem_to_sub, device=dev))
    cts = final_cts.index_select(1, torch.tensor(mem_to_dim, device=dev))
    init_fp = fd.fadd(spec, fd.fmul(spec, tbl, g),
                      fd.fsub(spec, identity[:, None, :], t))
    final_fp = fd.fadd(spec, init_fp, fd.fmul(spec, cts, g2))
    return torch.stack([init_fp, final_fp], dim=2).reshape(
        fd.L, 2 * init_fp.shape[1], init_fp.shape[2])


def combine_with_eq(instruction_cls, C: int, M: int):
    """Sumcheck combine function: g(E_0, ..., E_{m-1}) * eq."""
    instr = instruction_cls()

    def comb(spec, params):
        evals = [DevF(p, spec) for p in params[:-1]]
        g = instr.combine_lookups(evals, C, M)
        return fd.fmul(spec, g.limbs, params[-1])

    return comb


# ---------------------------------------------------------------------------
# memory checking instance
# ---------------------------------------------------------------------------

class SurgeMemoryChecking(MemoryCheckingProver):
    def __init__(self, preprocessing: SurgePreprocessing):
        self.pre = preprocessing
        self.spec = preprocessing.spec

    def protocol_name(self) -> bytes:
        return b"SurgeMemCheck"

    def compute_leaves(self, polynomials: SurgePolynomials, gamma: FElt,
                       tau: FElt):
        pre, spec, dev = self.pre, self.spec, self.pre.device
        mem_to_dim = [pre.memory_to_dimension_index(i)
                      for i in range(pre.num_memories)]
        mem_to_sub = [pre.memory_to_subtable_index(i)
                      for i in range(pre.num_memories)]
        g = fd.scalar_to_device(spec, gamma.v, dev)
        t = fd.scalar_to_device(spec, tau.v, dev)
        identity = fd.u64_to_mont_device(spec, np.arange(pre.M, dtype=np.uint64),
                                         dev)
        rw = _surge_rw_leaves(spec, mem_to_dim, polynomials.dim,
                              polynomials.read_cts, polynomials.E_polys, g, t)
        inf = _surge_if_leaves(spec, mem_to_dim, mem_to_sub, pre.subtable_dev,
                               polynomials.final_cts, identity, g, t)
        return rw, inf


# ---------------------------------------------------------------------------
# prover / verifier
# ---------------------------------------------------------------------------

def generate_witness(pre: SurgePreprocessing, x: np.ndarray, y: np.ndarray
                     ) -> tuple[SurgePolynomials, np.ndarray]:
    """Vectorized witness generation (surge.rs:543-624)."""
    C, M = pre.C, pre.M
    num_ops = len(x)
    n = next_power_of_two(num_ops)

    indices = pre.instruction_cls.to_indices_vec(x, y, C, log2_strict(M))
    # pad with address-0 fake ops (they still bump counters, surge.rs:569-581)
    if n > num_ops:
        pad = np.zeros((C, n - num_ops), dtype=np.uint64)
        indices = np.concatenate([indices, pad], axis=1)

    read_cts = np.zeros((C, n), dtype=np.uint64)
    final_cts = np.zeros((C, M), dtype=np.uint64)
    for c in range(C):
        read_cts[c], final_cts[c] = cumcount(indices[c], M)

    E_host = np.zeros((pre.num_memories, n), dtype=np.uint64)
    for mem in range(pre.num_memories):
        d = pre.memory_to_dimension_index(mem)
        s = pre.memory_to_subtable_index(mem)
        E_host[mem] = pre.subtable_entries[s][indices[d].astype(np.int64)]

    spec, dev = pre.spec, pre.device
    polys = SurgePolynomials(
        dim=fd.u64_to_mont_device(spec, indices, dev),
        read_cts=fd.u64_to_mont_device(spec, read_cts, dev),
        final_cts=fd.u64_to_mont_device(spec, final_cts, dev),
        E_polys=fd.u64_to_mont_device(spec, E_host, dev),
    )
    return polys, indices


def surge_prove(pre: SurgePreprocessing, pcs, x: np.ndarray, y: np.ndarray,
                mesh=None) -> tuple[SurgeProof, Transcript, None]:
    """Prove N lookups (surge.rs:378-480).  Returns (proof, transcript,
    None): the transcript is the debug oracle for `surge_verify`; the
    opening accumulator stays unused under fork parity (surge.rs:440-447,
    memory_checking.rs:330-384), so None takes its place until the opening
    proof is ported.

    With `mesh` (parallel/sharding.py), the primary sumcheck's E and eq
    MLEs are split on the hypercube axis, as jolt_tpu's are, and the
    memory checking's grand products on their batch axis; the transcript
    is the unsharded prover's."""
    spec = pre.spec
    C, M = pre.C, pre.M
    transcript = Transcript(b"Surge transcript")
    transcript.append_protocol_name(b"Surge")

    polys, _ = generate_witness(pre, x, y)
    n = polys.dim.shape[-1]
    num_rounds = log2_strict(n)

    commitments = pcs.batch_commit(polys.read_write_values(),
                                   BatchType.SURGE_READ_WRITE)
    final_commitments = pcs.batch_commit(polys.init_final_values(),
                                         BatchType.SURGE_INIT_FINAL)

    # primary sumcheck
    r_primary = transcript.challenge_vector(num_rounds)
    eq = mle.eq_evals_device(spec, r_primary, pre.device)
    instr = pre.instruction_cls()
    comb = combine_with_eq(pre.instruction_cls, C, M)
    sc_polys = tuple(polys.E_polys[:, i] for i in range(pre.num_memories)) \
        + (eq,)
    claim_dev = fd.fsum(spec, comb(spec, sc_polys), axis=-1)
    sumcheck_claim = FElt(fd.to_int(spec, claim_dev), spec)
    transcript.append_scalar(sumcheck_claim)

    degree = instr.g_poly_degree(C) + 1
    if mesh is not None:
        sc_polys = shard_sumcheck_polys(mesh, sc_polys)
    proof_primary, _r_z, final_evals = prove_arbitrary(
        num_rounds, sc_polys, comb, degree, transcript, spec)
    # Fork parity: E-poly opening accumulation disabled (surge.rs:440-447).
    primary = SurgePrimarySumcheck(proof_primary, num_rounds, sumcheck_claim,
                                   final_evals[:-1])

    mc = SurgeMemoryChecking(pre)
    mc.mesh = mesh
    mc_proof = mc.prove_memory_checking(polys, transcript)
    proof = SurgeProof(commitments, final_commitments, primary, mc_proof, C, M)
    return proof, transcript, None


def surge_verify(pre: SurgePreprocessing, proof: SurgeProof,
                 debug_transcript: Transcript | None = None) -> None:
    """Verify (surge.rs:485-541) on the host; raises VerificationError on
    a bad proof."""
    transcript = Transcript(b"Surge transcript")
    if debug_transcript is not None:
        transcript.compare_to(debug_transcript)
    transcript.append_protocol_name(b"Surge")
    instr = pre.instruction_cls()

    ps = proof.primary_sumcheck
    r_primary = transcript.challenge_vector(ps.num_rounds)
    transcript.append_scalar(ps.claimed_evaluation)
    degree = instr.g_poly_degree(pre.C) + 1
    claim_last, r_z = ps.sumcheck_proof.verify(
        ps.claimed_evaluation, ps.num_rounds, degree, transcript)

    eq_eval = mle.eq_evaluate_host(r_primary, r_z)
    combined = instr.combine_lookups(ps.E_poly_openings, pre.C, pre.M)
    if eq_eval * combined != claim_last:
        raise VerificationError("Surge primary sumcheck failed")

    SurgeMemoryChecking(pre).verify_memory_checking(proof.memory_checking,
                                                    transcript)
