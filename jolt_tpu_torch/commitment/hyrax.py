"""Hyrax PCS and Pedersen generators (reference:
poly/commitment/{hyrax,pedersen}.rs, jolt_tpu/commitment/hyrax.py).

Pedersen matrix commitment: the evaluation vector is viewed as an
L_size x R_size matrix; each row is committed with a fixed generator vector.
Opening at r = (r_L, r_R): the prover sends the L-weighted vector-matrix
product; the verifier checks it against the homomorphically-combined row
commitments and dot-products with R (Thaler §14.3).

The generators are g * k for scalars k drawn in order from
random.Random(b"Jolt v1 Hyrax generators"), as jolt_tpu draws them; the
port computes the points on the device with the SRS's fixed-base table
(K6).  The rows of one commitment share their generators, so all rows go
through one windowed MSM (curve/device.py: K6 adds, K7 doublings).  The
vector-matrix product and the batched proof's random linear combination
are limb ops on the polynomial's device; the verifier is host math (its
two MSMs by the bucket method, curve/bn254.py `g1_msm_buckets`).
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Sequence

import torch

from .._device import resolve_device
from ..curve import device as cd
from ..curve.bn254 import G1Affine, G1Jacobian, g1_msm_buckets
from ..field import device as fd
from ..field.host import FElt
from ..field.spec import FieldSpec, fr_spec
from ..poly.mle import eq_evals_host
from ..subprotocols.sumcheck import VerificationError
from ..transcript import Transcript
from ..utils.math import log2_strict, next_power_of_two
from .base import BatchType
from .kzg import fixed_base_points

FR = fr_spec()
GENERATORS_LABEL = b"Jolt v1 Hyrax generators"

TRACE_LEN_R1CS_POLYS_BATCH_RATIO = 64
SURGE_RATIO_READ_WRITE = 16
SURGE_RATIO_FINAL = 4


def batch_type_to_ratio(batch_type: BatchType) -> int:
    return {BatchType.BIG: TRACE_LEN_R1CS_POLYS_BATCH_RATIO,
            BatchType.GRAND_PRODUCT: TRACE_LEN_R1CS_POLYS_BATCH_RATIO,
            BatchType.SMALL: 1,
            BatchType.SURGE_READ_WRITE: SURGE_RATIO_READ_WRITE,
            BatchType.SURGE_INIT_FINAL: SURGE_RATIO_FINAL}[batch_type]


def _isqrt(n: int) -> int:
    return int(n ** 0.5 + 0.5)


def matrix_dimensions(num_vars: int, ratio: int) -> tuple[int, int]:
    """(col_size, row_size) split (hyrax.rs:39-50)."""
    row_size = 1 << (num_vars // 2)
    row_size = next_power_of_two(row_size * _isqrt(ratio))
    right_num_vars = min(log2_strict(row_size), num_vars - 1)
    row_size = 1 << right_num_vars
    col_size = 1 << (num_vars - right_num_vars)
    return col_size, row_size


@dataclass
class PedersenGenerators:
    points: list[G1Affine]
    dev: tuple  # Jacobian device limb tensors (X, Y, Z) [16, n]

    @staticmethod
    def new(n: int, label: bytes = GENERATORS_LABEL, device=None
            ) -> "PedersenGenerators":
        """n generators g * k_i, k_i drawn from random.Random(label), on
        `device` (default: the CUDA card)."""
        dev = resolve_device(device)
        rng = random.Random(label)
        ks = [rng.randrange(1, FR.p) for _ in range(n)]
        jac = fixed_base_points(torch.from_numpy(
            fd.pack_ints(ks).astype("int32")).to(dev))
        return PedersenGenerators(
            [p.to_affine() for p in cd.jacobian_to_host(*jac)], jac)


@dataclass
class HyraxCommitment:
    row_commitments: list[G1Affine]

    def append_to_transcript(self, transcript: Transcript) -> None:
        transcript.append_message(b"poly_commitment_begin")
        for p in self.row_commitments:
            transcript.append_point(p)
        transcript.append_message(b"poly_commitment_end")


@dataclass
class HyraxOpeningProof:
    vector_matrix_product: list[FElt]


class HyraxScheme:
    def __init__(self, generators: PedersenGenerators,
                 spec: FieldSpec | None = None):
        self.gens = generators
        self.spec = spec or FR

    @classmethod
    def setup(cls, max_len: int, ratio: int = 1, device=None
              ) -> "HyraxScheme":
        _, r_size = matrix_dimensions(log2_strict(max_len), ratio)
        return cls(PedersenGenerators.new(r_size, device=device))

    @staticmethod
    def protocol_name() -> bytes:
        return b"Hyrax opening proof"

    def _commit(self, polys, ratio: int) -> list[HyraxCommitment]:
        """Row commitments of equal-length Montgomery Fr evaluation vectors
        [16, n]: every row of every vector in one windowed MSM over the
        shared generators."""
        l_size, r_size = matrix_dimensions(log2_strict(polys[0].shape[-1]),
                                           ratio)
        rows = torch.cat([p.reshape(fd.L, l_size, r_size) for p in polys],
                         dim=1)
        pts = cd.msm(self.gens.dev, rows)
        return [HyraxCommitment(pts[i * l_size:(i + 1) * l_size])
                for i in range(len(polys))]

    def commit(self, poly: torch.Tensor, ratio: int = 1) -> HyraxCommitment:
        return self._commit([poly], ratio)[0]

    def batch_commit(self, polys, batch_type: BatchType = BatchType.BIG,
                     mesh=None):
        """Each vector committed at ratio 1, as jolt_tpu commits a batch;
        vectors of one length share one MSM."""
        # unsharded on a mesh too, as jolt_tpu's Hyrax commits
        by_len: dict[int, list[int]] = {}
        for j, p in enumerate(polys):
            by_len.setdefault(p.shape[-1], []).append(j)
        out = [None] * len(polys)
        for idxs in by_len.values():
            for j, c in zip(idxs, self._commit([polys[j] for j in idxs], 1)):
                out[j] = c
        return out

    def prove(self, poly: torch.Tensor, opening_point: Sequence[FElt],
              transcript: Transcript, ratio: int = 1) -> HyraxOpeningProof:
        spec = self.spec
        transcript.append_protocol_name(self.protocol_name())
        point = list(opening_point)
        l_size, r_size = matrix_dimensions(len(point), ratio)
        L = eq_evals_host(point[:log2_strict(l_size)])
        # vector-matrix product: sum_i L[i] * row_i
        mat = poly.reshape(fd.L, l_size, r_size)
        l_dev = fd.ints_to_device(spec, [x.v for x in L], poly.device)
        vmp = fd.fsum(spec, fd.fmul(spec, mat, l_dev[:, :, None]), axis=0)
        return HyraxOpeningProof([FElt(int(v), spec) for v in
                                  fd.device_to_ints(spec, vmp).tolist()])

    def verify(self, proof: HyraxOpeningProof, transcript: Transcript,
               opening_point: Sequence[FElt], opening: FElt,
               commitment: HyraxCommitment, ratio: int = 1) -> None:
        """Raises VerificationError."""
        transcript.append_protocol_name(self.protocol_name())
        point = list(opening_point)
        l_size, r_size = matrix_dimensions(len(point), ratio)
        L = eq_evals_host(point[:log2_strict(l_size)])
        vmp = proof.vector_matrix_product
        if len(commitment.row_commitments) != l_size:
            raise VerificationError("Hyrax: wrong proof or commitment size")
        self._check_dot(proof, point, opening, ratio)
        derived = g1_msm_buckets(commitment.row_commitments, [x.v for x in L])
        product = g1_msm_buckets(self.gens.points[:r_size],
                                 [x.v for x in vmp])
        if derived != product:
            raise VerificationError("Hyrax opening verification failed")

    def _check_dot(self, proof: HyraxOpeningProof, point: list[FElt],
                   opening: FElt, ratio: int) -> None:
        """<vmp, R> == opening: the verifier's cheap check, made before
        its MSMs (both must hold)."""
        l_size, r_size = matrix_dimensions(len(point), ratio)
        R = eq_evals_host(point[log2_strict(l_size):])
        vmp = proof.vector_matrix_product
        if len(vmp) != r_size:
            raise VerificationError("Hyrax: wrong proof or commitment size")
        dot = FElt(0, self.spec)
        for a, b in zip(vmp, R):
            dot = dot + a * b
        if dot != opening:
            raise VerificationError("Hyrax opening verification failed")

    def prove_batched(self, polys: Sequence[torch.Tensor],
                      opening_point: Sequence[FElt],
                      openings: Sequence[FElt], transcript: Transcript,
                      batch_type: BatchType = BatchType.BIG
                      ) -> "BatchedHyraxOpeningProof":
        return BatchedHyraxOpeningProof.prove(
            self, polys, opening_point, openings, batch_type, transcript)

    def combine_commitments(self, commitments, coeffs):
        max_rows = max(len(c.row_commitments) for c in commitments)
        rows = []
        for i in range(max_rows):
            acc = G1Jacobian.identity()
            for c, co in zip(commitments, coeffs):
                if i < len(c.row_commitments):
                    p = c.row_commitments[i]
                    if not p.is_infinity and co.v:
                        acc = acc.add(p.to_jacobian().mul(co.v))
            rows.append(acc.to_affine())
        return HyraxCommitment(rows)


@dataclass
class BatchedHyraxOpeningProof:
    """RLC batch opening (hyrax.rs:359-505, Thaler PAZK §16.1).

    K polynomials opened at one point collapse into a single Hyrax opening
    of their random linear combination; the verifier re-derives the RLC
    commitment homomorphically from the per-polynomial row commitments.
    """
    joint_proof: HyraxOpeningProof
    ratio: int

    @staticmethod
    def protocol_name() -> bytes:
        return b"Jolt BatchedHyraxOpeningProof"

    @staticmethod
    def prove(scheme: HyraxScheme, polys: Sequence[torch.Tensor],
              opening_point: Sequence[FElt], openings: Sequence[FElt],
              batch_type: BatchType, transcript: Transcript
              ) -> "BatchedHyraxOpeningProof":
        spec = scheme.spec
        transcript.append_protocol_name(
            BatchedHyraxOpeningProof.protocol_name())
        transcript.append_scalars(openings)
        coeffs = transcript.challenge_vector(len(polys))
        stacked = torch.stack(tuple(polys), dim=1)          # [16, K, n]
        c_dev = fd.ints_to_device(spec, [c.v for c in coeffs],
                                  stacked.device)           # [16, K]
        rlc = fd.fsum(spec, fd.fmul(spec, stacked, c_dev[:, :, None]),
                      axis=0)
        ratio = batch_type_to_ratio(batch_type)
        joint = scheme.prove(rlc, opening_point, transcript, ratio)
        return BatchedHyraxOpeningProof(joint, ratio)

    def verify(self, scheme: HyraxScheme, opening_point: Sequence[FElt],
               openings: Sequence[FElt],
               commitments: Sequence[HyraxCommitment],
               transcript: Transcript) -> None:
        """Raises VerificationError."""
        spec = scheme.spec
        if len(openings) != len(commitments):
            raise VerificationError("Hyrax: one opening per commitment")
        l_size, _ = matrix_dimensions(len(opening_point), self.ratio)
        for i, c in enumerate(commitments):
            if len(c.row_commitments) != l_size:
                raise VerificationError(
                    f"Row commitment {i}/{len(commitments)} wrong length")
        transcript.append_protocol_name(self.protocol_name())
        transcript.append_scalars(openings)
        coeffs = transcript.challenge_vector(len(openings))
        rlc_eval = FElt(0, spec)
        for c, o in zip(coeffs, openings):
            rlc_eval = rlc_eval + c * o
        # the cheap check before the host RLC of the row commitments
        scheme._check_dot(self.joint_proof, list(opening_point), rlc_eval,
                          self.ratio)
        rlc_commitment = scheme.combine_commitments(commitments, coeffs)
        scheme.verify(self.joint_proof, transcript, opening_point, rlc_eval,
                      rlc_commitment, self.ratio)
