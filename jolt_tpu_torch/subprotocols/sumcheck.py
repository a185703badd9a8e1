"""The sumcheck protocol: device prover + host verifier.

The prover mirrors the reference's `SumcheckInstanceProof::prove_arbitrary`
(jolt-core/src/subprotocols/sumcheck.rs:81-177) as jolt_tpu runs it on the
CPU (jolt_tpu/subprotocols/sumcheck.py:132-155): each round evaluates the
combined polynomial at t = 0..degree over the half-hypercube (top-variable
split, extrapolation by repeated addition of hi - lo), interpolates the
round polynomial on the host, appends its compressed form to the
transcript, and binds every polynomial to the challenge.  With device
Fiat-Shamir (grand_product._use_device_fs: by default for CUDA tensors)
the interpolation, the transcript and the challenge stay on the device
(`_prove_rounds_device`, jolt_tpu's sumcheck.py:400-461 without its host
tail), and the host replays the round polynomials once at the end.

The polynomials may be split over a mesh on their hypercube axis
(parallel/sharding.py `shard_sumcheck_polys`: cyclic for top binding,
block for bottom binding): each round's evaluations are then per shard
plus one modular fold on the mesh's first device, and the binds stay on
the shards.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

import torch

from ..field import device as fd
from ..field.host import FElt
from ..field.spec import FieldSpec, fr_spec
from ..parallel import sharding as sh
from ..poly.mle import bind_bot, bind_top
from ..poly.unipoly import CompressedUniPoly, UniPoly
from ..transcript import Transcript
from ..utils.profiling import span


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
                 polys: Sequence[torch.Tensor], bot: bool = False
                 ) -> torch.Tensor:
    """Evaluations of sum_x comb(polys(t, x)) at t = 0..degree -> [16, degree+1].

    The round's variable is the top one (pairs (i, i + n/2)), or with `bot`
    the bottom one (pairs (2i, 2i+1), sumcheck.rs:185-317)."""
    if bot:
        lows = tuple(p[..., 0::2] for p in polys)
        highs = tuple(p[..., 1::2] for p in polys)
    else:
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


def _evals(spec: FieldSpec, comb_func, degree: int, polys, bot: bool
           ) -> torch.Tensor:
    """_round_evals over polys that may be sharded: per shard, folded."""
    return sh.round_evals(
        spec, lambda *ps: _round_evals(spec, comb_func, degree, ps, bot),
        polys)


def _bind(spec: FieldSpec, polys, r: torch.Tensor, bot: bool) -> tuple:
    return sh.bind_hypercube(spec, polys, r, bind_bot if bot else bind_top,
                             "bot" if bot else "top")


def _final_evals(spec: FieldSpec, polys) -> list:
    return _felts(spec, torch.stack([sh.unshard(p)[..., 0] for p in polys],
                                    dim=1))


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
    [16, half] limb tensors (one per polynomial).  The polys may be
    sharded on a mesh (cyclic layout).
    Returns (proof, challenge point r, final per-poly evaluations)."""
    spec = spec or fr_spec()
    polys = tuple(polys)
    # roofline accounting (approximate: comb_func's cost taken as the
    # (npolys-1)-mul product form): per round at half-size h, (degree+1)
    # comb evaluations of h*(npolys-1) muls plus the npolys*h bind muls
    n_polys = len(polys)
    n = polys[0].length if sh.is_sharded(polys[0]) else polys[0].shape[-1]
    ops = sum((n >> (j + 1)) * ((degree + 1) * (n_polys - 1) + n_polys)
              for j in range(num_rounds))
    r: list[FElt] = []
    compressed: list[CompressedUniPoly] = []
    with span("Sumcheck::prove_arbitrary", ops=ops):
        if num_rounds > 0 and _use_device_fs(polys[0].device):
            compressed, r, polys = _prove_rounds_device(
                num_rounds, polys, comb_func, degree, transcript, spec,
                bot=False, claim=None)
        for _ in range(num_rounds - len(compressed)):
            evals = _felts(spec, _evals(spec, comb_func, degree, polys,
                                        False))
            round_poly = UniPoly.from_evals(evals)
            cpoly = round_poly.compress()
            cpoly.append_to_transcript(transcript)
            r_j = transcript.challenge_scalar()
            r.append(r_j)
            rv = fd.scalar_to_device(spec, r_j.v, polys[0].device)
            polys = _bind(spec, polys, rv, False)
            compressed.append(cpoly)
        final_evals = _final_evals(spec, polys)
    return SumcheckInstanceProof(compressed), r, final_evals


def prove_arbitrary_bot(num_rounds: int, polys: Sequence[torch.Tensor],
                        comb_func: Callable, degree: int,
                        transcript: Transcript, spec: FieldSpec | None = None,
                        claim: FElt | None = None,
                        ) -> tuple[SumcheckInstanceProof, list[FElt], list[FElt]]:
    """Bottom-binding sumcheck (Spartan's outer sumcheck; the caller
    REVERSES the final point, spartan.rs:146).

    With a `claim`, each round's evaluation at t = 1 is derived as
    claim - e0 (the reference's hint trick); values are identical for
    honest provers.  The polys may be sharded on a mesh (block layout)."""
    spec = spec or fr_spec()
    polys = tuple(polys)
    r: list[FElt] = []
    compressed: list[CompressedUniPoly] = []
    previous_claim = claim
    if num_rounds > 0 and _use_device_fs(polys[0].device):
        compressed, r, polys = _prove_rounds_device(
            num_rounds, polys, comb_func, degree, transcript, spec, bot=True,
            claim=claim)
    for _ in range(num_rounds - len(compressed)):
        evals = _felts(spec, _evals(spec, comb_func, degree, polys, True))
        if previous_claim is not None:
            evals[1] = previous_claim - evals[0]
        round_poly = UniPoly.from_evals(evals)
        cpoly = round_poly.compress()
        cpoly.append_to_transcript(transcript)
        r_j = transcript.challenge_scalar()
        r.append(r_j)
        rv = fd.scalar_to_device(spec, r_j.v, polys[0].device)
        polys = _bind(spec, polys, rv, True)
        if previous_claim is not None:
            previous_claim = round_poly.evaluate(r_j)
        compressed.append(cpoly)
    final_evals = _final_evals(spec, polys)
    return SumcheckInstanceProof(compressed), r, final_evals


def _use_device_fs(device) -> bool:
    from .grand_product import _use_device_fs as use
    return use(device)


def _prove_rounds_device(num_rounds, polys, comb_func, degree, transcript,
                         spec, bot: bool, claim):
    """The rounds with device Fiat-Shamir: evals -> K9 -> bind with no
    host sync, then one pull of the compressed polys and one host replay.
    With a `claim`, each round's t = 1 evaluation is the previous claim
    minus e_0 (the hint).  Returns (compressed, r, bound polys)."""
    from . import fs_device as fsd
    dev = polys[0].device
    use_hint = claim is not None
    state = fsd.state_to_device(transcript, dev)
    prev = fd.scalar_to_device(spec, claim.v, dev) if use_hint \
        else fd.zeros(spec, (), dev)
    comps = []
    for _ in range(num_rounds):
        evals = _evals(spec, comb_func, degree, polys, bot)
        comp, rj, prev, state = fsd.fs_round(spec, evals, prev, state,
                                             degree, use_hint)
        polys = _bind(spec, polys, rj, bot)
        comps.append(comp)
    compressed, r = fsd.replay_and_check(
        spec, fd.device_to_ints(spec, torch.stack(comps, dim=1)).tolist(),
        transcript, state, CompressedUniPoly,
        "Sumcheck::prove_arbitrary" + ("_bot" if bot else ""))
    return compressed, r, polys


def comb_product(spec: FieldSpec, params) -> torch.Tensor:
    """The product of every polynomial of the round."""
    out = params[0]
    for p in params[1:]:
        out = fd.fmul(spec, out, p)
    return out
