"""Batched opening reduction (reference: poly/opening_proof.rs:1-665,
jolt_tpu/poly/opening_proof.py).

Openings (polynomial, point, claim) accumulate over the course of a proof;
one batching sumcheck reduces them to a single PCS opening:

  prover append:    rho-powers RLC of same-point polynomials (device)
  reduce_and_prove: quadratic sumcheck over sum_i coeff_i * P_i(x) * eq_i(x)
                    (smaller polynomials enter late, scaled by 2^remaining),
                    then the gamma-powers joint polynomial opened once
  verifier mirror:  homomorphic commitment combination + claim checks

With host Fiat-Shamir each round pulls the active pairs' two evaluations
and binds on the device; with device Fiat-Shamir (the default for CUDA
tensors, grand_product._use_device_fs) the whole reduction runs on the
device and the host replays it once (`_prove_reduction_device_fs`).
On a mesh (`reduce_and_prove(..., mesh=)`), each opening's polynomial and
eq are split on the hypercube axis for the reduction (cyclic: the rounds
bind the top variable), as jolt_tpu's are; the joint polynomial is formed
from the unsplit polynomials.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch

from ..field import device as fd
from ..field.host import FElt
from ..field.spec import FieldSpec, fr_spec
from ..parallel import sharding as sh
from ..poly.mle import bind_top, eq_evaluate_host
from ..poly.unipoly import CompressedUniPoly, UniPoly
from ..subprotocols import fs_device as fsd
from ..subprotocols.grand_product import _use_device_fs
from ..subprotocols.sumcheck import SumcheckInstanceProof, VerificationError
from ..transcript import Transcript


def rlc_polys(spec: FieldSpec, polys: Sequence[torch.Tensor],
              coeffs: Sequence[FElt], pad_to: int | None = None
              ) -> torch.Tensor:
    """sum_i coeffs[i] * polys[i] over [16, n], zero-padding shorter
    polynomials at the tail."""
    n = pad_to or max(p.shape[-1] for p in polys)
    dev = polys[0].device
    coeffs_dev = fd.ints_to_device(spec, [c.v for c in coeffs], dev)
    out = None
    for i, p in enumerate(polys):
        term = fd.fmul(spec, coeffs_dev[:, i:i + 1], p)
        if term.shape[-1] < n:
            term = torch.cat([term, fd.zeros(spec, (n - term.shape[-1],), dev)],
                             dim=1)
        out = term if out is None else fd.fadd(spec, out, term)
    return out


def _quadratic_evals(spec: FieldSpec, poly: torch.Tensor, eq: torch.Tensor
                     ) -> torch.Tensor:
    """(eval_0, eval_2) of sum_x P(t,x) * eq(t,x) -> [16, 2]."""
    n = poly.shape[-1]
    p_lo, p_hi = poly[..., : n // 2], poly[..., n // 2:]
    e_lo, e_hi = eq[..., : n // 2], eq[..., n // 2:]
    ev0 = fd.fsum(spec, fd.fmul(spec, p_lo, e_lo), axis=-1)
    p2 = fd.fadd(spec, p_hi, fd.fsub(spec, p_hi, p_lo))
    e2 = fd.fadd(spec, e_hi, fd.fsub(spec, e_hi, e_lo))
    ev2 = fd.fsum(spec, fd.fmul(spec, p2, e2), axis=-1)
    return torch.stack([ev0, ev2], dim=1)


def _pair_evals(spec: FieldSpec, poly, eq) -> torch.Tensor:
    """_quadratic_evals, per shard and folded when the pair is sharded."""
    return sh.round_evals(spec, lambda p, e: _quadratic_evals(spec, p, e),
                          (poly, eq))


def _bind_pair(spec: FieldSpec, poly, eq, r: torch.Tensor) -> tuple:
    return sh.bind_hypercube(spec, (poly, eq), r, bind_top)


def _final_claims(spec: FieldSpec, bound) -> list[FElt]:
    return [FElt(int(v), spec) for v in fd.device_to_ints(
        spec, torch.stack([sh.unshard(b)[..., 0] for b in bound],
                          dim=1)).tolist()]


@dataclass
class ProverOpening:
    polynomial: torch.Tensor     # [16, n] RLC polynomial
    eq_poly: torch.Tensor        # [16, n] eq(x, opening_point)
    opening_point: list[FElt]
    claim: FElt


@dataclass
class ReducedOpeningProof:
    sumcheck_proof: SumcheckInstanceProof
    sumcheck_claims: list[FElt]
    joint_opening_proof: object


class ProverOpeningAccumulator:
    def __init__(self, spec: FieldSpec | None = None):
        self.spec = spec or fr_spec()
        self.openings: list[ProverOpening] = []

    def __len__(self):
        return len(self.openings)

    def append(self, polynomials: Sequence[torch.Tensor],
               eq_poly: torch.Tensor, opening_point: Sequence[FElt],
               claims: Sequence[FElt], transcript: Transcript) -> None:
        """RLC-batch same-point openings with rho powers
        (opening_proof.rs:142-213)."""
        assert len(polynomials) == len(claims)
        rho_powers = transcript.challenge_scalar_powers(len(polynomials))
        batched_claim = FElt(0, self.spec)
        for rp, c in zip(rho_powers, claims):
            batched_claim = batched_claim + rp * c
        self.openings.append(ProverOpening(
            rlc_polys(self.spec, polynomials, rho_powers), eq_poly,
            list(opening_point), batched_claim))

    def prove_batch_opening_reduction(self, coeffs: list[FElt],
                                      transcript: Transcript, mesh=None):
        """The reduction sumcheck; with `mesh`, every polynomial and eq
        split on its hypercube axis (those too small stay whole)."""
        spec = self.spec
        max_num_vars = max(len(o.opening_point) for o in self.openings)
        zero = FElt(0, spec)

        e = zero
        for co, o in zip(coeffs, self.openings):
            diff = max_num_vars - len(o.opening_point)
            e = e + FElt(1 << diff, spec) * o.claim * co
        bound = [sh.maybe_shard_hypercube(mesh, o.polynomial)
                 for o in self.openings]
        bound_eq = [sh.maybe_shard_hypercube(mesh, o.eq_poly)
                    for o in self.openings]
        if _use_device_fs(self.openings[0].polynomial.device):
            return self._prove_reduction_device_fs(coeffs, e, max_num_vars,
                                                   transcript, bound,
                                                   bound_eq)

        r: list[FElt] = []
        compressed: list[CompressedUniPoly] = []
        for rnd in range(max_num_vars):
            remaining = max_num_vars - rnd
            active = [i for i, o in enumerate(self.openings)
                      if remaining <= len(o.opening_point)]
            pairs = fd.device_to_ints(spec, torch.stack(
                [_pair_evals(spec, bound[i], bound_eq[i])
                 for i in active], dim=1)).tolist()            # [P][2]
            ev0 = ev2 = zero
            for i, (e0, e2) in zip(active, pairs):
                ev0 = ev0 + coeffs[i] * FElt(int(e0), spec)
                ev2 = ev2 + coeffs[i] * FElt(int(e2), spec)
            for i, o in enumerate(self.openings):
                if i not in active:
                    rem_vars = remaining - len(o.opening_point) - 1
                    scaled = FElt(1 << rem_vars, spec) * o.claim * coeffs[i]
                    ev0 = ev0 + scaled
                    ev2 = ev2 + scaled
            round_poly = UniPoly.from_evals([ev0, e - ev0, ev2])
            cpoly = round_poly.compress()
            cpoly.append_to_transcript(transcript)
            r_j = transcript.challenge_scalar()
            r.append(r_j)
            r_dev = fd.scalar_to_device(spec, r_j.v, bound[0].device)
            for i in active:
                bound[i], bound_eq[i] = _bind_pair(spec, bound[i],
                                                   bound_eq[i], r_dev)
            e = round_poly.evaluate(r_j)
            compressed.append(cpoly)
        return SumcheckInstanceProof(compressed), r, _final_claims(spec,
                                                                   bound)

    def _prove_reduction_device_fs(self, coeffs: list[FElt], e: FElt,
                                   max_num_vars: int, transcript: Transcript,
                                   bound: list, bound_eq: list):
        """The reduction sumcheck with the Fiat-Shamir chain on the device
        (jolt_tpu's opening_proof.py:254-380, shrinking instead of masked):
        each round's quadratic evaluations, batched with the coefficients
        and the not-yet-active claims' contribution (a host constant per
        round, folded in as a device scalar), go to K9 with no host sync;
        one pull and one host replay at the end."""
        spec = self.spec
        dev = self.openings[0].polynomial.device
        coeffs_dev = fd.ints_to_device(spec, [c.v for c in coeffs], dev)
        inacts = []
        for rnd in range(max_num_vars):
            remaining = max_num_vars - rnd
            inact = FElt(0, spec)
            for co, o in zip(coeffs, self.openings):
                if remaining > len(o.opening_point):
                    rem_vars = remaining - len(o.opening_point) - 1
                    inact = inact + FElt(1 << rem_vars, spec) * o.claim * co
            inacts.append(inact.v)
        inacts_dev = fd.ints_to_device(spec, inacts, dev)       # [16, R]
        state = fsd.state_to_device(transcript, dev)
        prev = fd.scalar_to_device(spec, e.v, dev)
        comps = []
        for rnd in range(max_num_vars):
            remaining = max_num_vars - rnd
            active = [i for i, o in enumerate(self.openings)
                      if remaining <= len(o.opening_point)]
            pairs = torch.stack([_pair_evals(spec, bound[i], bound_eq[i])
                                 for i in active], dim=1)      # [16, A, 2]
            ca = torch.cat([coeffs_dev[:, i:i + 1] for i in active], dim=1)
            evals = fd.fadd(spec, fd.fsum(spec, fd.fmul(
                spec, ca[:, :, None], pairs), axis=0),
                inacts_dev[:, rnd:rnd + 1])                     # [16, 2]
            comp, rj, prev, state = fsd.fs_round(spec, evals, prev, state,
                                                 2, True)
            for i in active:
                bound[i], bound_eq[i] = _bind_pair(spec, bound[i],
                                                   bound_eq[i], rj)
            comps.append(comp)
        compressed, r = fsd.replay_and_check(
            spec, fd.device_to_ints(spec, torch.stack(comps, dim=1)).tolist(),
            transcript, state, CompressedUniPoly, "reduce_and_prove")
        return SumcheckInstanceProof(compressed), r, _final_claims(spec,
                                                                   bound)

    def reduce_and_prove(self, pcs, transcript: Transcript, mesh=None
                         ) -> ReducedOpeningProof:
        """The reduction sumcheck (split over `mesh`, if one is given),
        then one opening of the joint polynomial."""
        rho_powers = transcript.challenge_scalar_powers(len(self.openings))
        sumcheck_proof, r_sumcheck, sumcheck_claims = \
            self.prove_batch_opening_reduction(rho_powers, transcript, mesh)
        transcript.append_scalars(sumcheck_claims)

        gamma_powers = transcript.challenge_scalar_powers(len(self.openings))
        max_len = max(o.polynomial.shape[-1] for o in self.openings)
        joint_poly = rlc_polys(self.spec,
                               [o.polynomial for o in self.openings],
                               gamma_powers, pad_to=max_len)
        joint_opening_proof = pcs.prove(joint_poly, r_sumcheck, transcript)
        return ReducedOpeningProof(sumcheck_proof, sumcheck_claims,
                                   joint_opening_proof)


@dataclass
class VerifierOpening:
    commitment: object
    opening_point: list[FElt]
    claim: FElt


class VerifierOpeningAccumulator:
    def __init__(self, pcs, spec: FieldSpec | None = None):
        self.spec = spec or fr_spec()
        self.pcs = pcs
        self.openings: list[VerifierOpening] = []
        self.prover_openings: list[ProverOpening] | None = None

    def __len__(self):
        return len(self.openings)

    def compare_to(self, prover_acc: ProverOpeningAccumulator):
        """Oracle: cross-check appended points/claims against the prover's
        accumulator (opening_proof.rs:458-470, test-only in the reference)."""
        self.prover_openings = prover_acc.openings

    def append(self, commitments: Sequence, opening_point: Sequence[FElt],
               claims: Sequence[FElt], transcript: Transcript) -> None:
        assert len(commitments) == len(claims)
        rho_powers = transcript.challenge_scalar_powers(len(commitments))
        batched_claim = FElt(0, self.spec)
        for rp, c in zip(rho_powers, claims):
            batched_claim = batched_claim + rp * c
        joint_commitment = self.pcs.combine_commitments(commitments, rho_powers)
        if self.prover_openings is not None:
            po = self.prover_openings[len(self.openings)]
            assert [x.v for x in po.opening_point] == \
                [x.v for x in opening_point], "opening point mismatch"
            assert po.claim == batched_claim, "batched claim mismatch"
        self.openings.append(VerifierOpening(joint_commitment,
                                             list(opening_point), batched_claim))

    def reduce_and_verify(self, pcs, reduced_proof: ReducedOpeningProof,
                          transcript: Transcript) -> None:
        spec = self.spec
        one = FElt(1, spec)
        num_rounds = max(len(o.opening_point) for o in self.openings)
        rho_powers = transcript.challenge_scalar_powers(len(self.openings))
        combined = FElt(0, spec)
        for co, o in zip(rho_powers, self.openings):
            diff = num_rounds - len(o.opening_point)
            combined = combined + FElt(1 << diff, spec) * o.claim * co
        sumcheck_claim, r_sumcheck = reduced_proof.sumcheck_proof.verify(
            combined, num_rounds, 2, transcript)

        expected = FElt(0, spec)
        for o, co, claim in zip(self.openings, rho_powers,
                                reduced_proof.sumcheck_claims):
            r_hi = r_sumcheck[num_rounds - len(o.opening_point):]
            expected = expected + eq_evaluate_host(r_hi, o.opening_point) \
                * claim * co
        if sumcheck_claim != expected:
            raise VerificationError("batch opening reduction claim mismatch")

        transcript.append_scalars(reduced_proof.sumcheck_claims)
        gamma_powers = transcript.challenge_scalar_powers(len(self.openings))

        joint_commitment = pcs.combine_commitments(
            [o.commitment for o in self.openings], gamma_powers)
        joint_claim = FElt(0, spec)
        for o, co, claim in zip(self.openings, gamma_powers,
                                reduced_proof.sumcheck_claims):
            lagrange = one
            for rv in r_sumcheck[: num_rounds - len(o.opening_point)]:
                lagrange = lagrange * (one - rv)
            joint_claim = joint_claim + co * claim * lagrange

        pcs.verify(reduced_proof.joint_opening_proof, transcript,
                   r_sumcheck, joint_claim, joint_commitment)
