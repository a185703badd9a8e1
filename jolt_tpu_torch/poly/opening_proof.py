"""Batched opening reduction (reference: poly/opening_proof.rs:1-665,
jolt_tpu/poly/opening_proof.py).

Openings (polynomial, point, claim) accumulate over the course of a proof;
one batching sumcheck reduces them to a single PCS opening:

  prover append:    rho-powers RLC of same-point polynomials (device)
  reduce_and_prove: quadratic sumcheck over sum_i coeff_i * P_i(x) * eq_i(x)
                    (smaller polynomials enter late, scaled by 2^remaining),
                    then the gamma-powers joint polynomial opened once
  verifier mirror:  homomorphic commitment combination + claim checks

Each round's batched evaluations are one K16 launch and its binds one
K15 launch (field/kernels.py), and every RLC one K17 launch.  With host
Fiat-Shamir each round pulls the two batched evaluations and binds on the
device; with device Fiat-Shamir (the default for CUDA
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
from ..field import kernels as fk
from ..field.host import FElt
from ..field.spec import FieldSpec, fr_spec
from ..parallel import sharding as sh
from ..poly.mle import eq_evaluate_host
from ..poly.unipoly import CompressedUniPoly, UniPoly
from ..subprotocols import fs_device as fsd
from ..subprotocols.grand_product import _bind_one, _use_device_fs
from ..subprotocols.sumcheck import SumcheckInstanceProof, VerificationError
from ..transcript import Transcript


def rlc_polys(spec: FieldSpec, polys: Sequence[torch.Tensor],
              coeffs: Sequence[FElt], pad_to: int | None = None
              ) -> torch.Tensor:
    """sum_i coeffs[i] * polys[i] over [16, n], shorter polynomials read
    as zero at the tail (K17, field/kernels.py `rlc`: columns of wider
    tensors read in place, the coefficients by value)."""
    n = pad_to or max(p.shape[-1] for p in polys)
    return fk.rlc(spec, polys, fk.host_limbs(spec, [c.v for c in coeffs]), n)


def _round_evals(spec: FieldSpec, polys: list, eqs: list,
                 coeffs: torch.Tensor, k: torch.Tensor, k_dev: torch.Tensor
                 ) -> torch.Tensor:
    """One reduction round's batched evaluations (eval_0, eval_2) ->
    [16, 2] over the active pairs, all of one length: k + sum_a c_a *
    (_quadratic_evals of pair a), one K16 launch (coeffs [16, A] and k
    [16] as host limbs, by value).  On a mesh the pairs are split alike:
    K16 a shard with no constant, the shards' sums folded, then k_dev
    (k on the first device) added once."""
    if not sh.is_sharded(polys[0]):
        return fk.reduction_evals(spec, polys, eqs, coeffs, k)
    A, zero = len(polys), torch.zeros_like(k)
    folded = sh.round_evals(
        spec, lambda *ts: fk.reduction_evals(spec, ts[:A], ts[A:], coeffs,
                                             zero), (*polys, *eqs))
    return fd.fadd(spec, folded, k_dev[:, None])


def _bind_active(spec: FieldSpec, bound: list, bound_eq: list, active,
                 r: torch.Tensor) -> None:
    """Bind the active pairs' top variable to r, in place in the lists:
    all 2A tensors in one K15 launch (into new tensors: the accumulated
    polynomials stay intact for the joint polynomial), or shard by shard
    on a mesh."""
    ts = [bound[i] for i in active] + [bound_eq[i] for i in active]
    if sh.is_sharded(ts[0]):
        out = sh.bind_hypercube(spec, ts, r, _bind_one)
    else:
        out = fk.bind_halves(spec, ts, r)
    A = len(active)
    for i, p, q in zip(active, out[:A], out[A:]):
        bound[i], bound_eq[i] = p, q


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
        # each round's constant: the claims not yet active, scaled
        inacts = []
        for rnd in range(max_num_vars):
            remaining = max_num_vars - rnd
            inact = zero
            for co, o in zip(coeffs, self.openings):
                if remaining > len(o.opening_point):
                    rem_vars = remaining - len(o.opening_point) - 1
                    inact = inact + FElt(1 << rem_vars, spec) * o.claim * co
            inacts.append(inact.v)
        dev = self.openings[0].polynomial.device
        coeffs_h = fk.host_limbs(spec, [c.v for c in coeffs])
        inacts_h = fk.host_limbs(spec, inacts)              # [16, R]
        inacts_dev = inacts_h.to(dev) if mesh is not None else inacts_h

        def round_evals(rnd: int) -> torch.Tensor:
            active = self._active(max_num_vars - rnd)
            return _round_evals(spec, [bound[i] for i in active],
                                [bound_eq[i] for i in active],
                                coeffs_h[:, active], inacts_h[:, rnd],
                                inacts_dev[:, rnd])

        if _use_device_fs(dev):
            return self._prove_reduction_device_fs(
                e, max_num_vars, transcript, bound, bound_eq, round_evals)

        r: list[FElt] = []
        compressed: list[CompressedUniPoly] = []
        for rnd in range(max_num_vars):
            ev0, ev2 = (FElt(int(v), spec) for v in fd.device_to_ints(
                spec, round_evals(rnd)).tolist())
            round_poly = UniPoly.from_evals([ev0, e - ev0, ev2])
            cpoly = round_poly.compress()
            cpoly.append_to_transcript(transcript)
            r_j = transcript.challenge_scalar()
            r.append(r_j)
            r_dev = fd.scalar_to_device(spec, r_j.v, bound[0].device)
            _bind_active(spec, bound, bound_eq,
                         self._active(max_num_vars - rnd), r_dev)
            e = round_poly.evaluate(r_j)
            compressed.append(cpoly)
        return SumcheckInstanceProof(compressed), r, _final_claims(spec,
                                                                   bound)

    def _active(self, remaining: int) -> list[int]:
        """The openings whose polynomials are in play with `remaining`
        variables left."""
        return [i for i, o in enumerate(self.openings)
                if remaining <= len(o.opening_point)]

    def _prove_reduction_device_fs(self, e: FElt, max_num_vars: int,
                                   transcript: Transcript, bound: list,
                                   bound_eq: list, round_evals):
        """The reduction sumcheck with the Fiat-Shamir chain on the device
        (jolt_tpu's opening_proof.py:254-380, shrinking instead of masked):
        each round's evaluations, batched with the coefficients and the
        not-yet-active claims' contribution (round_evals: one K16 launch),
        go to K9 and the active pairs bind to its challenge (one K15
        launch), with no host sync; one pull and one host replay at the
        end."""
        spec = self.spec
        dev = self.openings[0].polynomial.device
        state = fsd.state_to_device(transcript, dev)
        prev = fd.scalar_to_device(spec, e.v, dev)
        comps = []
        for rnd in range(max_num_vars):
            comp, rj, prev, state = fsd.fs_round(spec, round_evals(rnd), prev,
                                                 state, 2, True)
            _bind_active(spec, bound, bound_eq,
                         self._active(max_num_vars - rnd), rj)
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
