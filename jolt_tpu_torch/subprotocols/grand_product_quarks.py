"""Quarks (section 5) / GKR hybrid grand products
(jolt_tpu/subprotocols/grand_product_quarks.py).

Reference: jolt-core/src/subprotocols/grand_product_quarks.rs.  The prover
commits the top of the product tree as a polynomial f with
f(1, x) = f(x, 0) * f(x, 1), proven by one degree-3 sumcheck in place of
log-many GKR layers, then hands a random evaluation claim down to 4 dense
GKR base layers (QUARK_HYBRID_LAYER_DEPTH, grand_product_quarks.rs:34).
The Jolt VM does not use it (quark_proof is None, grand_product.rs:37-41).

The product tree is built by K1 (`_tree_level`); f(1, .), f(., 0) and
f(., 1) are stride slices of the concatenated [v || tree] tensor; the
sumcheck's random combination is folded into the polynomials up front
(A = sum r_i g_i, u_i = r_i * f0_i), so one comb serves any batch size
with the reference's round values, hence its transcript bytes.  The base
layers run the dense prover's K2 and K3 rounds; the g commitments take
the commitment scheme's GRAND_PRODUCT batch (HyperKZG: g_products on K6
and the residual MSM on K5).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from ..commitment.base import BatchType
from ..field import device as fd
from ..field.host import FElt
from ..field.spec import FieldSpec, fr_spec
from ..poly.mle import eq_evals_device, evaluate_device
from ..poly.opening_proof import rlc_polys
from ..transcript import Transcript
from .grand_product import (BatchedGrandProductProof, _felts,
                            _interleaved_to_pair, _prove_dense_layers,
                            _tree_level, verify_grand_product)
from .sumcheck import (SumcheckInstanceProof, VerificationError,
                       prove_arbitrary)

QUARK_HYBRID_LAYER_DEPTH = 4


@dataclass
class QuarkGrandProductProof:
    sumcheck_proof: SumcheckInstanceProof
    g_commitment: list
    claimed_eval_g_r: list[FElt]
    claimed_eval_g_r_x: tuple[list[FElt], list[FElt]]
    helper_values: tuple[list[FElt], list[FElt]]
    num_vars: int


def _v_into_f(spec: FieldSpec, v: torch.Tensor):
    """v [16, B, n] -> (g = f(1, .), f(., 0), f(., 1), root products)
    (grand_product_quarks.rs:447-492, v_into_f).

    f = v || the flattened product tree || 0; g is its second half."""
    levels = [v]
    while levels[-1].shape[-1] > 1:
        levels.append(_tree_level(spec, levels[-1]))
    zero_col = fd.zeros(spec, v.shape[1:-1] + (1,), v.device)
    g = torch.cat(levels[1:] + [zero_col], dim=-1)
    f = torch.cat([v, g], dim=-1)
    products = _felts(spec, levels[-1][..., 0])
    return g, f[..., 0::2], f[..., 1::2], products


@functools.cache
def _quark_comb(B: int):
    """comb = (A - sum_i u_i * f1_i) * eq_tau + (sum_i u_i) * eq_ones, with
    A = sum r_i g_i and u_i = r_i * f0_i folded in (the field values of
    grand_product_quarks.rs:258-272's output_check_fn).  Its 2B + 3
    parameters: A, (u_i, f1_i) for each circuit, eq_tau, eq_ones."""
    def comb(spec, params):
        A = params[0]
        eq_tau, eq_ones = params[-2], params[-1]
        s1, s2 = A, None
        for i in range(B):
            u, f1 = params[1 + 2 * i], params[2 + 2 * i]
            s1 = fd.fsub(spec, s1, fd.fmul(spec, u, f1))
            s2 = u if s2 is None else fd.fadd(spec, s2, u)
        return fd.fadd(spec, fd.fmul(spec, s1, eq_tau),
                       fd.fmul(spec, s2, eq_ones))
    return comb


def _scale(spec: FieldSpec, poly: torch.Tensor, c: FElt) -> torch.Tensor:
    cd = fd.scalar_to_device(spec, c.v, poly.device).reshape(
        (fd.L,) + (1,) * (poly.dim() - 1))
    return fd.fmul(spec, cd, poly)


def _evals_at(spec: FieldSpec, polys: torch.Tensor, point: list[FElt]
              ) -> list[FElt]:
    """Evaluate each batch slice of [16, B, n] at `point` (big-endian)."""
    eq = eq_evals_device(spec, point, polys.device)
    return _felts(spec, torch.stack([evaluate_device(spec, polys[:, i], eq)
                                     for i in range(polys.shape[1])], dim=1))


def _line_reduce(spec: FieldSpec, r_prime: list[FElt], polys: torch.Tensor,
                 transcript: Transcript):
    """grand_product_quarks.rs:522-569: the openings at (r', 0) and (r', 1)
    seed a challenge t; the claims reduce to the one point (r', t)."""
    zero, one = FElt(0, spec), FElt(1, spec)
    openings_0 = _evals_at(spec, polys, r_prime + [zero])
    openings_1 = _evals_at(spec, polys, r_prime + [one])
    transcript.append_scalars(openings_0)
    transcript.append_scalars(openings_1)
    rand = transcript.challenge_scalar()
    r_star = r_prime + [rand]
    openings_star = [e0 + rand * (e1 - e0)
                     for e0, e1 in zip(openings_0, openings_1)]
    return (r_star, openings_star), (openings_0, openings_1)


def _line_reduce_verify(spec: FieldSpec, data, r_prime: list[FElt],
                        transcript: Transcript):
    transcript.append_scalars(data[0])
    transcript.append_scalars(data[1])
    rand = transcript.challenge_scalar()
    r_star = r_prime + [rand]
    claimed = [e0 + rand * (e1 - e0) for e0, e1 in zip(data[0], data[1])]
    return r_star, claimed


def quark_prove(leaves: torch.Tensor, pcs, opening_accumulator,
                transcript: Transcript, spec: FieldSpec | None = None):
    """The section-5 Quarks proof over leaves [16, B, n]
    (grand_product_quarks.rs:200-334).  Returns (proof, r_t, h_r_t)."""
    spec = spec or fr_spec()
    dev = leaves.device
    B, n = leaves.shape[1], leaves.shape[2]
    v_variables = n.bit_length() - 1

    g, f0, f1, products = _v_into_f(spec, leaves)
    g_polys = [g[:, i] for i in range(B)]

    transcript.append_scalars(products)
    g_commitment = pcs.batch_commit(g_polys, BatchType.GRAND_PRODUCT)
    for c in g_commitment:
        c.append_to_transcript(transcript)

    tau = transcript.challenge_vector(v_variables)
    eq_tau = eq_evals_device(spec, tau, dev)
    eq_ones = eq_evals_device(spec, [FElt(1, spec)] * v_variables, dev)
    r_combination = transcript.challenge_vector(B)

    A = rlc_polys(spec, g_polys, r_combination)
    polys = [A]
    for i in range(B):
        polys.append(_scale(spec, f0[:, i], r_combination[i]))
        polys.append(f1[:, i])
    polys += [eq_tau, eq_ones]
    del f0, f1

    sumcheck_proof, x, _ = prove_arbitrary(v_variables, polys,
                                           _quark_comb(B), 3, transcript,
                                           spec=spec)
    del polys, A

    chis_r = eq_evals_device(spec, x, dev)
    openings_r = _felts(spec, torch.stack(
        [evaluate_device(spec, g[:, i], chis_r) for i in range(B)], dim=1))
    opening_accumulator.append(g_polys, chis_r, x, openings_r, transcript)

    r_prime = x[1:]
    # openings of g at (r', 0) and (r', 1), line-reduced and proven
    (r_star, openings_star), claimed_eval_g_r_x = _line_reduce(
        spec, r_prime, g, transcript)
    opening_accumulator.append(g_polys, eq_evals_device(spec, r_star, dev),
                               r_star, openings_star, transcript)
    # h = f(0, .) = v itself: the line-reduced claim goes to the GKR layers
    (r_t, h_r_t), helper_values = _line_reduce(spec, r_prime, leaves,
                                               transcript)

    proof = QuarkGrandProductProof(sumcheck_proof, list(g_commitment),
                                   openings_r, claimed_eval_g_r_x,
                                   helper_values, v_variables)
    return proof, r_t, h_r_t


def quark_verify(qproof: QuarkGrandProductProof, claims: list[FElt],
                 opening_accumulator, transcript: Transcript,
                 spec: FieldSpec | None = None):
    """grand_product_quarks.rs:336-445.  Returns (claims, point) for the
    base layers' verification; raises VerificationError."""
    spec = spec or fr_spec()
    n_rounds = qproof.num_vars
    one = FElt(1, spec)

    transcript.append_scalars(claims)
    for c in qproof.g_commitment:
        c.append_to_transcript(transcript)

    tau = transcript.challenge_vector(n_rounds)
    r_combination = transcript.challenge_vector(len(qproof.g_commitment))
    claim_rlc = FElt(0, spec)
    for c, rc in zip(claims, r_combination):
        claim_rlc = claim_rlc + c * rc

    expected, r = qproof.sumcheck_proof.verify(claim_rlc, n_rounds, 3,
                                               transcript)
    r_1 = r[0]
    r_prime = r[1:]

    opening_accumulator.append(qproof.g_commitment, r,
                               qproof.claimed_eval_g_r, transcript)
    r_star, claimed = _line_reduce_verify(spec, qproof.claimed_eval_g_r_x,
                                          r_prime, transcript)
    opening_accumulator.append(qproof.g_commitment, r_star, claimed,
                               transcript)
    r_t, h_r_t = _line_reduce_verify(spec, qproof.helper_values, r_prime,
                                     transcript)

    eq_eval = one
    for r_gp, r_sc in zip(r, tau):
        eq_eval = eq_eval * (r_gp * r_sc + (one - r_gp) * (one - r_sc))
    eq_1_eval = one
    for r_gp in r:
        eq_1_eval = eq_1_eval * r_gp

    g0, g1 = qproof.claimed_eval_g_r_x
    h0, h1 = qproof.helper_values
    f_r0 = [h + r_1 * (g - h) for g, h in zip(g0, h0)]
    f_r1 = [h + r_1 * (g - h) for g, h in zip(g1, h1)]

    result = FElt(0, spec)
    for i in range(len(f_r0)):
        result = result + r_combination[i] * (
            eq_eval * (qproof.claimed_eval_g_r[i] - f_r0[i] * f_r1[i])
            + eq_1_eval * f_r0[i])
    if result != expected:
        raise VerificationError("quark binding check failed")
    return h_r_t, r_t


class QuarkGrandProduct:
    """The hybrid prover: Quarks for the top of the tree, dense GKR for
    the bottom 4 layers (grand_product_quarks.rs:42-150)."""

    def __init__(self, quark_polys: torch.Tensor,
                 base_layers: list[torch.Tensor], spec: FieldSpec):
        self.quark_polys = quark_polys
        self.base_layers = base_layers
        self.spec = spec

    @staticmethod
    def construct(leaves: torch.Tensor, spec: FieldSpec | None = None
                  ) -> "QuarkGrandProduct":
        """Interleaved leaves [16, B, n] -> base layers (leaves first) and
        the quark top."""
        spec = spec or fr_spec()
        leave_depth = leaves.shape[-1].bit_length() - 1
        num_layers = (leave_depth - 1 if leave_depth <= QUARK_HYBRID_LAYER_DEPTH
                      else QUARK_HYBRID_LAYER_DEPTH)
        layers = [leaves]
        for _ in range(num_layers):
            layers.append(_tree_level(spec, layers[-1]))
        quark_polys = layers.pop()
        return QuarkGrandProduct(quark_polys, layers, spec)

    def claims(self) -> list[FElt]:
        top = self.quark_polys
        while top.shape[-1] > 1:
            top = _tree_level(self.spec, top)
        return _felts(self.spec, top[..., 0])

    def prove_grand_product(self, opening_accumulator, transcript: Transcript,
                            pcs) -> tuple[BatchedGrandProductProof, list[FElt]]:
        spec = self.spec
        quark, random, claims = quark_prove(self.quark_polys, pcs,
                                            opening_accumulator, transcript,
                                            spec)
        pair_layers = [_interleaved_to_pair(spec, lay)
                       for lay in self.base_layers]
        layer_proofs, random, _ = _prove_dense_layers(
            spec, pair_layers, claims, random, transcript)
        return BatchedGrandProductProof(layer_proofs, quark), random

    @staticmethod
    def verify_grand_product(proof: BatchedGrandProductProof,
                             claims: list[FElt], opening_accumulator,
                             transcript: Transcript,
                             spec: FieldSpec | None = None):
        spec = spec or fr_spec()
        if proof.quark is not None:
            v_points, rand = quark_verify(proof.quark, claims,
                                          opening_accumulator, transcript,
                                          spec)
        else:
            v_points, rand = list(claims), []
        return verify_grand_product(proof, v_points, transcript,
                                    r_start=rand)
