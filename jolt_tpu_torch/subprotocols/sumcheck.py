"""The sumcheck protocol: device prover + host verifier.

The prover mirrors the reference's `SumcheckInstanceProof::prove_arbitrary`
(jolt-core/src/subprotocols/sumcheck.rs:81-177) as jolt_tpu runs it on the
CPU (jolt_tpu/subprotocols/sumcheck.py:132-155): each round evaluates the
combined polynomial at t = 0..degree over the half-hypercube (top-variable
split, extrapolation by repeated addition of hi - lo), interpolates the
round polynomial on the host, appends its compressed form to the
transcript, and binds every polynomial to the challenge.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

import torch

from ..field import device as fd
from ..field.host import FElt
from ..field.spec import FieldSpec, fr_spec
from ..poly.mle import bind_top
from ..poly.unipoly import CompressedUniPoly, UniPoly
from ..transcript import Transcript


class VerificationError(Exception):
    """A proof was rejected."""


class SumcheckError(VerificationError):
    pass


@dataclass
class SumcheckInstanceProof:
    compressed_polys: list[CompressedUniPoly]

    def verify(self, claim: FElt, num_rounds: int, degree_bound: int,
               transcript: Transcript) -> tuple[FElt, list[FElt]]:
        """Host verification (sumcheck.rs:495-552). Returns (final claim, r)."""
        if len(self.compressed_polys) != num_rounds:
            raise SumcheckError(
                f"expected {num_rounds} round polys, got {len(self.compressed_polys)}")
        e = claim
        r: list[FElt] = []
        for poly in self.compressed_polys:
            if poly.degree() != degree_bound:
                raise SumcheckError(
                    f"round poly degree {poly.degree()} != bound {degree_bound}")
            poly.append_to_transcript(transcript)
            r_i = transcript.challenge_scalar()
            r.append(r_i)
            e = poly.eval_from_hint(e, r_i)
        return e, r


def _round_evals(spec: FieldSpec, comb_func, degree: int,
                 polys: Sequence[torch.Tensor]) -> torch.Tensor:
    """Evaluations of sum_x comb(polys(t, x)) at t = 0..degree -> [16, degree+1]."""
    half = polys[0].shape[-1] // 2
    lows = tuple(p[..., :half] for p in polys)
    highs = tuple(p[..., half:] for p in polys)

    def total(params):
        return fd.fsum(spec, comb_func(spec, params), axis=-1)

    evals = [total(lows), total(highs)]
    cur = highs
    for _ in range(2, degree + 1):
        cur = tuple(fd.fadd(spec, c, fd.fsub(spec, h, l))
                    for c, h, l in zip(cur, highs, lows))
        evals.append(total(cur))
    return torch.stack(evals, dim=1)


def _felts(spec: FieldSpec, a: torch.Tensor) -> list[FElt]:
    return [FElt(int(v), spec) for v in fd.device_to_ints(spec, a).tolist()]


def prove_arbitrary(num_rounds: int,
                    polys: Sequence[torch.Tensor],
                    comb_func: Callable,
                    degree: int,
                    transcript: Transcript,
                    spec: FieldSpec | None = None,
                    ) -> tuple[SumcheckInstanceProof, list[FElt], list[FElt]]:
    """Generic sumcheck prover over device MLE limb tensors [16, n].

    comb_func(spec, params) -> limb tensor, where params is a tuple of
    [16, half] limb tensors (one per polynomial).
    Returns (proof, challenge point r, final per-poly evaluations)."""
    spec = spec or fr_spec()
    polys = tuple(polys)
    r: list[FElt] = []
    compressed: list[CompressedUniPoly] = []
    for _ in range(num_rounds):
        evals = _felts(spec, _round_evals(spec, comb_func, degree, polys))
        round_poly = UniPoly.from_evals(evals)
        cpoly = round_poly.compress()
        cpoly.append_to_transcript(transcript)
        r_j = transcript.challenge_scalar()
        r.append(r_j)
        rv = fd.scalar_to_device(spec, r_j.v, polys[0].device)
        polys = tuple(bind_top(spec, p, rv) for p in polys)
        compressed.append(cpoly)
    final_evals = _felts(spec, torch.stack([p[..., 0] for p in polys], dim=1))
    return SumcheckInstanceProof(compressed), r, final_evals
