"""HyperKZG multilinear PCS (reference: poly/commitment/hyperkzg.rs,
jolt_tpu/commitment/hyperkzg.py).

Gemini-style multilinear-to-univariate transformation over the EVALUATION
vector (no FFTs): ell - 1 bottom-variable foldings produce halving
polynomials P_i, each committed with univariate KZG; all are batch-opened
at {r, -r, r^2} with a q-powers RLC and a single multi-pairing check.

The foldings, evaluations, quotients and commitments run on the device;
verification is host-side (one small MSM and one pairing product in pure
Python, seconds).  jolt_tpu zero-pads small folds to a fixed bucket size
to reuse compiled TPU programs; zeros change no commitment and no
evaluation, so the port folds at the true sizes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch

from .._device import resolve_device
from ..curve.bn254 import G1Affine, g1_msm_host
from ..curve.pairing import pairing_product_is_one
from ..field import device as fd
from ..field.host import FElt
from ..field.spec import FieldSpec, fr_spec
from ..poly.mle import bind_bot
from ..poly.opening_proof import rlc_polys
from ..subprotocols.sumcheck import VerificationError
from ..transcript import Transcript
from .base import BatchType
from .kzg import (SRS_SEED, KZGProverKey, KZGVerifierKey, _powers_device,
                  kzg_commit, kzg_commit_batch, kzg_commit_grand_product,
                  kzg_quotient, srs_setup, verifier_key)


@dataclass
class HyperKZGCommitment:
    point: G1Affine

    def append_to_transcript(self, transcript: Transcript) -> None:
        transcript.append_point(None if self.point.is_infinity else self.point)

    def __eq__(self, other):
        return self.point == other.point


@dataclass
class HyperKZGProof:
    com: list[G1Affine]          # commitments to P_1 .. P_{ell-1}
    w: list[G1Affine]            # KZG witnesses at r, -r, r^2
    v: list[list[FElt]]          # v[j][i] = P_i(u_j), 3 x ell


class HyperKZG:
    def __init__(self, pk: KZGProverKey, vk: KZGVerifierKey,
                 spec: FieldSpec | None = None):
        self.pk = pk
        self.vk = vk
        self.spec = spec or fr_spec()

    @staticmethod
    def protocol_name() -> bytes:
        return b"HyperKZG"

    @classmethod
    def setup(cls, max_len: int, seed: int = SRS_SEED, device=None
              ) -> "HyperKZG":
        """An SRS of max_len points on `device` (default: the CUDA card)."""
        return cls(srs_setup(max_len, resolve_device(device), seed),
                   verifier_key(seed))

    def commit(self, poly: torch.Tensor) -> HyperKZGCommitment:
        return HyperKZGCommitment(kzg_commit(self.pk, poly))

    def batch_commit(self, polys: Sequence[torch.Tensor],
                     batch_type: BatchType = BatchType.BIG, mesh=None
                     ) -> list[HyperKZGCommitment]:
        """Commitments to Montgomery Fr vectors [16, n].  GrandProduct
        batches take the mostly-ones shortcut (hyperkzg.rs:554-566 ->
        kzg.rs:223-256; jolt_tpu/commitment/hyperkzg.py:106-108): the sum
        of the SRS prefix plus the MSM of coeffs - 1, each polynomial
        apart; every other batch type shares one bitplane fold.  Both
        give the same points.  With `mesh`, the bitplane fold's point
        axis is split over it (commitment/kzg.py kzg_commit_batch)."""
        if batch_type == BatchType.GRAND_PRODUCT:
            return [HyperKZGCommitment(kzg_commit_grand_product(self.pk, p))
                    for p in polys]
        return [HyperKZGCommitment(p)
                for p in kzg_commit_batch(self.pk, list(polys), mesh=mesh)]

    def combine_commitments(self, commitments: Sequence[HyperKZGCommitment],
                            coeffs: Sequence[FElt]) -> HyperKZGCommitment:
        return HyperKZGCommitment(g1_msm_host([c.point for c in commitments],
                                              [c.v for c in coeffs]))

    # -- opening ------------------------------------------------------------
    def prove(self, poly: torch.Tensor, opening_point: Sequence[FElt],
              transcript: Transcript) -> HyperKZGProof:
        """Open (hyperkzg.rs:311-362)."""
        spec = self.spec
        point = list(opening_point)
        ell = len(point)
        assert poly.shape[-1] == 1 << ell
        polys = [poly]
        if ell > 1:
            r_folds = fd.ints_to_device(
                spec, [point[ell - i - 1].v for i in range(ell - 1)],
                poly.device)
            for i in range(ell - 1):
                polys.append(bind_bot(spec, polys[-1], r_folds[:, i]))

        com = kzg_commit_batch(self.pk, polys[1:])
        transcript.append_points(com)
        r = transcript.challenge_scalar()
        u = [r, FElt(-r.v, spec), r * r]

        w, v = self._kzg_open_batch(polys, u, transcript)
        return HyperKZGProof(com, w, v)

    def _kzg_open_batch(self, polys, u, transcript: Transcript):
        """(hyperkzg.rs:158-199): every P_i at every u_j (prefixes of one
        power table per u_j), then the three witnesses of the q-powers RLC
        committed in one batch."""
        spec = self.spec
        k = len(polys)
        n, dev = polys[0].shape[-1], polys[0].device
        u_dev = fd.ints_to_device(spec, [x.v for x in u], dev)     # [16, 3]
        upows = [_powers_device(spec, u_dev[:, j], n) for j in range(len(u))]
        rows = []
        for upow in upows:
            rows += [fd.fsum(spec, fd.fmul(spec, f, upow[:, :f.shape[-1]]),
                             axis=-1) for f in polys]
        vals = fd.device_to_ints(spec, torch.stack(rows, dim=1)).tolist()
        v = [[FElt(int(x), spec) for x in vals[j * k:(j + 1) * k]]
             for j in range(len(u))]
        transcript.append_scalars([x for row in v for x in row])
        q_powers = transcript.challenge_scalar_powers(k)
        B = rlc_polys(spec, polys, q_powers, pad_to=n)
        w = kzg_commit_batch(self.pk, [kzg_quotient(B, uj) for uj in u])
        transcript.append_points(w)
        transcript.challenge_scalar()  # d_0, used only by the verifier
        return w, v

    # -- verification --------------------------------------------------------
    def verify(self, proof: HyperKZGProof, transcript: Transcript,
               opening_point: Sequence[FElt], opening: FElt,
               commitment: HyperKZGCommitment) -> None:
        """(hyperkzg.rs:365-470 + kzg_verify_batch 201-281); raises
        VerificationError."""
        spec = self.spec
        point = list(opening_point)
        ell = len(point)
        one = FElt(1, spec)
        two = FElt(2, spec)

        transcript.append_points(proof.com)
        r = transcript.challenge_scalar()
        if r.is_zero() or commitment.point.is_infinity:
            raise VerificationError("HyperKZG: degenerate challenge or "
                                    "commitment")
        com = [commitment.point] + list(proof.com)
        u = [r, FElt(-r.v, spec), r * r]

        v = proof.v
        if len(v) != 3 or any(len(row) != ell for row in v):
            raise VerificationError("HyperKZG: evaluation table shape")
        ypos, yneg = v[0], v[1]
        Y = list(v[2]) + [opening]
        for i in range(ell):
            x = point[ell - i - 1]
            lhs = two * r * Y[i + 1]
            rhs = (r * (one - x) * (ypos[i] + yneg[i])
                   + x * (ypos[i] - yneg[i]))
            if lhs != rhs:
                raise VerificationError(
                    f"HyperKZG fold consistency failed at {i}")

        if not self._kzg_verify_batch(com, proof.w, u, v, transcript):
            raise VerificationError("HyperKZG batch KZG check failed")

    def _kzg_verify_batch(self, C: list[G1Affine], W: list[G1Affine],
                          u: list[FElt], v: list[list[FElt]],
                          transcript: Transcript) -> bool:
        spec = self.spec
        k = len(C)
        transcript.append_scalars([x for row in v for x in row])
        q_powers = transcript.challenge_scalar_powers(k)
        transcript.append_points(W)
        d0 = transcript.challenge_scalar()
        d1 = d0 * d0

        q_mult = FElt(1, spec) + d0 + d1
        B_u = []
        for row in v:
            acc = FElt(0, spec)
            for a, b in zip(row, q_powers):
                acc = acc + a * b
            B_u.append(acc)

        bases = C + [W[0], W[1], W[2], self.vk.g1]
        scalars = ([(q * q_mult).v for q in q_powers]
                   + [u[0].v, (u[1] * d0).v, (u[2] * d1).v,
                      (-(B_u[0] + d0 * B_u[1] + d1 * B_u[2])).v])
        L = g1_msm_host(bases, scalars)
        R = (W[0].to_jacobian().add(W[1].to_jacobian().mul(d0.v))
             .add(W[2].to_jacobian().mul(d1.v))).to_affine()
        return pairing_product_is_one([(L, self.vk.g2),
                                       (R.neg(), self.vk.beta_g2)])
