"""Timestamp range check (Haböck-style; reference: timestamp_range_check.rs,
jolt_tpu/vm/timestamp_range_check.py).

Proves every read timestamp t_read[i][j] <= j (the global step counter) by
range-checking both t_read and (j - t_read) against [0, T): two derived
counter families per channel, all 6 * 7 + 1 = 43 same-length layers
batched into ONE dense grand product.

Its openings and fingerprint claim checks are ACTIVE (unlike the memory
checking of the other components): the verifier recomputes every leaf
fingerprint from the openings and matches them against the grand product
claims.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..field import device as fd
from ..field.host import FElt
from ..field.spec import FieldSpec
from ..lasso.memory_checking import MultisetHashes
from ..lasso.surge import cumcount
from ..poly import mle
from ..subprotocols.grand_product import (BatchedDenseGrandProduct,
                                          BatchedGrandProductProof,
                                          verify_grand_product)
from ..subprotocols.sumcheck import VerificationError
from ..transcript import Transcript
from .rv_trace import MEMORY_OPS_PER_INSTRUCTION

PROTOCOL_NAME = b"Timestamp Validity Proof"
NUM_CH = MEMORY_OPS_PER_INSTRUCTION  # 7


@dataclass
class TimestampRangeCheckPolynomials:
    read_cts_read_timestamp: torch.Tensor       # [16, 7, T]
    read_cts_global_minus_read: torch.Tensor    # [16, 7, T]
    final_cts_read_timestamp: torch.Tensor      # [16, 7, T]
    final_cts_global_minus_read: torch.Tensor   # [16, 7, T]

    def read_write_values(self):
        return [fd.col(t, i) for t in (self.read_cts_read_timestamp,
                                       self.read_cts_global_minus_read,
                                       self.final_cts_read_timestamp,
                                       self.final_cts_global_minus_read)
                for i in range(NUM_CH)]


def generate_witness(read_timestamps: np.ndarray, spec: FieldSpec, device
                     ) -> TimestampRangeCheckPolynomials:
    """Counter scans per channel and per family
    (timestamp_range_check.rs:115-231).  read_timestamps: [7, T] u64 with
    t_read[i][j] <= j."""
    T = read_timestamps.shape[1]
    rc_rt = np.zeros((NUM_CH, T), dtype=np.uint64)
    rc_gmr = np.zeros((NUM_CH, T), dtype=np.uint64)
    fc_rt = np.zeros((NUM_CH, T), dtype=np.uint64)
    fc_gmr = np.zeros((NUM_CH, T), dtype=np.uint64)
    steps = np.arange(T, dtype=np.uint64)
    for i in range(NUM_CH):
        rt = read_timestamps[i]
        rc_rt[i], fc_rt[i] = cumcount(rt.astype(np.int64), T)
        rc_gmr[i], fc_gmr[i] = cumcount((steps - rt).astype(np.int64), T)

    to_dev = lambda arr: fd.u64_to_mont_device(spec, arr, device)  # noqa: E731
    return TimestampRangeCheckPolynomials(
        read_cts_read_timestamp=to_dev(rc_rt),
        read_cts_global_minus_read=to_dev(rc_gmr),
        final_cts_read_timestamp=to_dev(fc_rt),
        final_cts_global_minus_read=to_dev(fc_gmr))


def _ts_leaves(spec: FieldSpec, polys: TimestampRangeCheckPolynomials,
               t_read, identity, gamma, tau) -> torch.Tensor:
    """All 43 leaf layers [16, 43, T] (timestamp_range_check.rs:260-365).

    Order: per channel i: [read0, write0, read1, write1]; then per channel:
    [final0, final1]; then init."""
    g = gamma.reshape(fd.L, 1)
    g2 = fd.fmul(spec, g, g)
    t = tau.reshape(fd.L, 1)

    def fp(av, cts):                 # cts * gamma^2 + av * gamma + av - tau
        return fd.fadd(spec, fd.fadd(spec, fd.fmul(spec, cts, g2),
                                     fd.fmul(spec, av, g)),
                       fd.fsub(spec, av, t))

    layers = []
    for i in range(NUM_CH):
        rt = t_read[:, i]
        gmr = fd.fsub(spec, identity, rt)
        r0 = fp(rt, polys.read_cts_read_timestamp[:, i])
        r1 = fp(gmr, polys.read_cts_global_minus_read[:, i])
        layers += [r0, fd.fadd(spec, r0, g2), r1, fd.fadd(spec, r1, g2)]

    init = fd.fadd(spec, fd.fmul(spec, identity, g),
                   fd.fsub(spec, identity, t))
    for i in range(NUM_CH):
        for cts in (polys.final_cts_read_timestamp,
                    polys.final_cts_global_minus_read):
            layers.append(fd.fadd(spec, fd.fmul(spec, cts[:, i], g2), init))
    layers.append(init)
    return torch.stack(layers, dim=1)


@dataclass
class TimestampValidityProof:
    multiset_hashes: MultisetHashes
    openings: list[FElt]            # 28 read_write_values openings
    exogenous_openings: list[FElt]  # 7 t_read openings
    batched_grand_product: BatchedGrandProductProof


def _check_multiset(h: MultisetHashes):
    for i in range(2 * NUM_CH):
        if h.init_hashes[0] * h.write_hashes[i] != \
                h.final_hashes[i] * h.read_hashes[i]:
            raise VerificationError(
                f"timestamp multiset hashes don't match ({i})")


def prove_timestamp_validity(ts_polys: TimestampRangeCheckPolynomials,
                             rwm_polys, opening_accumulator,
                             transcript: Transcript, spec: FieldSpec,
                             mesh=None) -> TimestampValidityProof:
    """With `mesh`, the grand product splits its batch axis over it."""
    gamma = transcript.challenge_scalar()
    tau = transcript.challenge_scalar()
    transcript.append_protocol_name(PROTOCOL_NAME)

    dev = rwm_polys.t_read.device
    T = ts_polys.read_cts_read_timestamp.shape[-1]
    identity = fd.u64_to_mont_device(spec, np.arange(T, dtype=np.uint64), dev)
    leaves = _ts_leaves(spec, ts_polys, rwm_polys.t_read, identity,
                        fd.scalar_to_device(spec, gamma.v, dev),
                        fd.scalar_to_device(spec, tau.v, dev))
    circuit = BatchedDenseGrandProduct.construct(leaves, spec, mesh=mesh)
    del leaves                 # the pair tree holds its own copies
    hashes_flat = circuit.claims()
    rw = hashes_flat[: 4 * NUM_CH]
    inf = hashes_flat[4 * NUM_CH:]
    multiset_hashes = MultisetHashes(rw[0::2], rw[1::2], [inf[-1]], inf[:-1])
    _check_multiset(multiset_hashes)
    multiset_hashes.append_to_transcript(transcript)

    gp_proof, r_grand_product = circuit.prove(transcript)

    # openings at r_grand_product (ACTIVE, timestamp_range_check.rs:595-660)
    eq_r = mle.eq_evals_device(spec, r_grand_product, dev)
    all_polys = (ts_polys.read_write_values()
                 + [fd.col(rwm_polys.t_read, i) for i in range(NUM_CH)])
    openings = mle.evaluate_many_host(spec, all_polys, eq_r)
    opening_accumulator.append(all_polys, eq_r, r_grand_product, openings,
                               transcript)
    return TimestampValidityProof(multiset_hashes, openings[:4 * NUM_CH],
                                  openings[4 * NUM_CH:], gp_proof)


def verify_timestamp_validity(proof: TimestampValidityProof, commitments,
                              opening_accumulator, transcript: Transcript,
                              spec: FieldSpec) -> None:
    gamma = transcript.challenge_scalar()
    tau = transcript.challenge_scalar()
    transcript.append_protocol_name(PROTOCOL_NAME)

    h = proof.multiset_hashes
    _check_multiset(h)
    h.append_to_transcript(transcript)
    rw_hashes = [x for pair in zip(h.read_hashes, h.write_hashes)
                 for x in pair]
    claims, r_grand_product = verify_grand_product(
        proof.batched_grand_product,
        rw_hashes + list(h.final_hashes) + list(h.init_hashes), transcript)

    opening_accumulator.append(
        commitments, r_grand_product,
        proof.openings + proof.exogenous_openings, transcript)

    # identity MLE at r (verifier-computed) + full fingerprint claim checks
    identity_eval = FElt(0, spec)
    n = len(r_grand_product)
    for i, rv in enumerate(r_grand_product):
        identity_eval = identity_eval + rv * (1 << (n - 1 - i))

    one = FElt(1, spec)
    rc_rt = proof.openings[0:NUM_CH]
    rc_gmr = proof.openings[NUM_CH:2 * NUM_CH]
    fc_rt = proof.openings[2 * NUM_CH:3 * NUM_CH]
    fc_gmr = proof.openings[3 * NUM_CH:4 * NUM_CH]
    t_read = proof.exogenous_openings

    def fp(a, v, t):
        return t * gamma * gamma + v * gamma + a - tau

    exp_rw, exp_final = [], []
    for i in range(NUM_CH):
        gmr = identity_eval - t_read[i]
        exp_rw += [fp(t_read[i], t_read[i], rc_rt[i]),
                   fp(t_read[i], t_read[i], rc_rt[i] + one),
                   fp(gmr, gmr, rc_gmr[i]), fp(gmr, gmr, rc_gmr[i] + one)]
        exp_final += [fp(identity_eval, identity_eval, fc_rt[i]),
                      fp(identity_eval, identity_eval, fc_gmr[i])]
    init_hash = fp(identity_eval, identity_eval, FElt(0, spec))
    if claims[: 4 * NUM_CH] != exp_rw:
        raise VerificationError("timestamp read/write fingerprint mismatch")
    if claims[4 * NUM_CH:] != exp_final + [init_hash]:
        raise VerificationError("timestamp init/final fingerprint mismatch")
