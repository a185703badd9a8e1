"""Zeromorph multilinear PCS (reference: poly/commitment/zeromorph.rs,
jolt_tpu/commitment/zeromorph.py).

Multilinear-to-univariate via multilinear quotients:
  f(X) - f(u) = sum_k q_k(X) * (X_k - u_k)
Each q_k is committed; a y-RLC "batched lifted-degree quotient" q_hat
enforces degree bounds; the ZM identity polynomial is opened at x with a
degree-shifted KZG witness (shift S = 1), checked by one pairing product.

The quotient cascade, q_hat, the f-combination and the commitments (the
bitplane MSM, K5) run on the polynomial's device; the scalar bookkeeping
(`_eval_and_quotient_scalars`) and the verifier are host math.  The SRS is
drawn from seed 0x5A4D, which no committed fixture has, so `setup`
generates it on the device (K1, K6).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch

from .._device import resolve_device
from ..curve.bn254 import G1Affine, G2Affine, g1_msm_host
from ..curve.pairing import pairing_product_is_one
from ..field import device as fd
from ..field.host import FElt, batch_inverse
from ..field.spec import FieldSpec, fr_spec
from ..poly.mle import bind_top
from ..subprotocols.sumcheck import VerificationError
from ..transcript import Transcript
from .base import BatchType, CommitShape
from .kzg import (KZGProverKey, KZGVerifierKey, _msm_jac, _powers_device,
                  _quotient_coeffs, kzg_commit, kzg_commit_batch, srs_setup,
                  verifier_key)

FR = fr_spec()
ZEROMORPH_SEED = 0x5A4D


@dataclass
class ZeromorphCommitment:
    point: G1Affine

    def append_to_transcript(self, transcript: Transcript) -> None:
        transcript.append_point(None if self.point.is_infinity else self.point)

    def __eq__(self, other):
        return self.point == other.point


@dataclass
class ZeromorphProof:
    pi: G1Affine
    q_hat_com: G1Affine
    q_k_com: list[G1Affine]


def _eval_and_quotient_scalars(y: FElt, x: FElt, z: FElt,
                               challenges: list[FElt], spec: FieldSpec):
    """(zeromorph.rs:161-224)."""
    one = FElt(1, spec)
    n = len(challenges)
    squares = [x]
    for _ in range(n):
        squares.append(squares[-1] * squares[-1])
    # offsets_of_x[k] = prod_{j=k}^{n-1} squares[j]  (rev-scan then reverse)
    offsets = []
    acc = one
    for pow_x in reversed(squares[:-1]):
        acc = acc * pow_x
        offsets.append(acc)
    offsets.reverse()
    v_numer = squares[n] - one
    v_denoms = batch_inverse([s - one for s in squares])
    vs = [v_numer * d for d in v_denoms]
    y_pow = one
    deg_scalars, zm_scalars = [], []
    for k in range(n):
        deg_scalars.append(-(y_pow * offsets[k]))
        zm_scalars.append(-(z * (squares[k] * vs[k + 1]
                                 - challenges[n - 1 - k] * vs[k])))
        y_pow = y_pow * y
    return -(vs[0] * z), deg_scalars, zm_scalars


class Zeromorph:
    def __init__(self, pk: KZGProverKey, vk: KZGVerifierKey,
                 tau_shift_g2: G2Affine, spec: FieldSpec | None = None):
        self.pk = pk
        self.vk = vk
        self.tau_shift_g2 = tau_shift_g2  # g2 * tau^SHIFT (SHIFT = 1)
        self.spec = spec or FR

    @staticmethod
    def protocol_name() -> bytes:
        return b"Zeromorph"

    @classmethod
    def setup(cls, shapes: Sequence[CommitShape] | int,
              seed: int = ZEROMORPH_SEED, device=None) -> "Zeromorph":
        """An SRS of the longest shape's length + 1 points (one extra power
        for the shift-1 opening key) on `device` (default: the CUDA card)."""
        if isinstance(shapes, int):
            max_len = shapes
        else:
            max_len = max(s.input_length for s in shapes)
        pk = srs_setup(max_len + 1, resolve_device(device), seed)
        vk = verifier_key(seed)
        return cls(pk, vk, vk.beta_g2)      # g2 * tau^1 is beta_g2

    # -- commitments ---------------------------------------------------------
    def commit(self, poly: torch.Tensor) -> ZeromorphCommitment:
        return ZeromorphCommitment(kzg_commit(self.pk, poly))

    def batch_commit(self, polys, batch_type: BatchType = BatchType.BIG,
                     mesh=None):
        # unsharded on a mesh too, as jolt_tpu's Zeromorph commits
        return [ZeromorphCommitment(p)
                for p in kzg_commit_batch(self.pk, list(polys))]

    def combine_commitments(self, commitments, coeffs):
        return ZeromorphCommitment(g1_msm_host(
            [c.point for c in commitments], [c.v for c in coeffs]))

    # -- opening -------------------------------------------------------------
    def prove(self, poly: torch.Tensor, opening_point: Sequence[FElt],
              transcript: Transcript) -> ZeromorphProof:
        spec = self.spec
        point = list(opening_point)
        n = len(point)
        if poly.shape[-1] != 1 << n:
            raise ValueError(f"a polynomial of {poly.shape[-1]} evaluations "
                             f"opened at {n} variables")
        dev = poly.device
        transcript.append_protocol_name(self.protocol_name())

        # multilinear quotients q_k, binding the TOP variable each level
        # (zeromorph.rs:89-129: splits at the high half, point[i] top-first)
        quotients = []  # q_k has 2^k coeffs; produced for k = n-1 .. 0
        remainder = poly
        r_dev = fd.ints_to_device(spec, [x.v for x in point], dev)
        for i in range(n):
            half = remainder.shape[-1] // 2
            quotients.append(fd.fsub(spec, remainder[:, half:],
                                     remainder[:, :half]))
            remainder = bind_top(spec, remainder, r_dev[:, i])
        quotients.reverse()  # q_0 (1 coeff) .. q_{n-1} (2^{n-1} coeffs)

        q_k_com = kzg_commit_batch(self.pk, quotients)
        for c in q_k_com:
            transcript.append_point(c)
        y = transcript.challenge_scalar()

        # q_hat = sum_k y^k X^{N - 2^k} q_k  (coeff-offset accumulation)
        N = 1 << n
        q_hat = fd.zeros(spec, (N,), dev)
        y_pows = [FElt(1, spec)]
        for _ in range(1, n):
            y_pows.append(y_pows[-1] * y)
        y_dev = fd.ints_to_device(spec, [v.v for v in y_pows], dev)
        for k, q in enumerate(quotients):
            start = N - (1 << k)
            q_hat[:, start:] = fd.fadd(spec, q_hat[:, start:],
                                       fd.fmul(spec, q, y_dev[:, k:k + 1]))
        q_hat_com = kzg_commit(self.pk, q_hat)
        transcript.append_point(q_hat_com)

        x = transcript.challenge_scalar()
        z = transcript.challenge_scalar()

        eval_scalar, deg_scalars, zm_scalars = _eval_and_quotient_scalars(
            y, x, z, point, spec)

        # f = z * poly + q_hat + [eval_scalar * eval at coeff 0]
        #     + sum_k (deg_k + zm_k) * q_k
        eval_pt = FElt(fd.to_int(spec, remainder[:, 0]), spec)
        coef = fd.ints_to_device(
            spec, [z.v, (eval_scalar * eval_pt).v]
            + [(d + m).v for d, m in zip(deg_scalars, zm_scalars)], dev)
        f = fd.fadd(spec, fd.fmul(spec, poly, coef[:, 0:1]), q_hat)
        f[:, 0] = fd.fadd(spec, f[:, 0], coef[:, 1])
        for k, q in enumerate(quotients):
            m = 1 << k
            f[:, :m] = fd.fadd(spec, f[:, :m],
                               fd.fmul(spec, q, coef[:, 2 + k:3 + k]))

        # pi = [q_f(tau) * tau^1] where q_f = f / (X - x) (f(x) == 0)
        pi = self._open_shifted(f, x)
        return ZeromorphProof(pi, q_hat_com, q_k_com)

    def _open_shifted(self, f: torch.Tensor, x: FElt) -> G1Affine:
        n, dev = f.shape[-1], f.device
        upow = _powers_device(FR, fd.scalar_to_device(FR, x.v, dev), n)
        uinv_pow = _powers_device(
            FR, fd.scalar_to_device(FR, pow(x.v, -1, FR.p), dev), n)
        q = _quotient_coeffs(FR, f, upow, uinv_pow)
        # commit against tau^{1..n-1} (shift-1 SRS slice)
        X, Y, Z = self.pk.g1_jac
        return _msm_jac((X[:, 1:], Y[:, 1:], Z[:, 1:]), q)

    # -- verification --------------------------------------------------------
    def verify(self, proof: ZeromorphProof, transcript: Transcript,
               opening_point: Sequence[FElt], opening: FElt,
               commitment: ZeromorphCommitment) -> None:
        """Raises VerificationError."""
        spec = self.spec
        point = list(opening_point)
        if len(proof.q_k_com) != len(point):
            raise VerificationError("Zeromorph: wrong number of quotient "
                                    "commitments")
        transcript.append_protocol_name(self.protocol_name())
        for c in proof.q_k_com:
            transcript.append_point(c)
        y = transcript.challenge_scalar()
        transcript.append_point(proof.q_hat_com)
        x = transcript.challenge_scalar()
        z = transcript.challenge_scalar()

        eval_scalar, deg_scalars, zm_scalars = _eval_and_quotient_scalars(
            y, x, z, point, spec)
        q_scalars = [d + m for d, m in zip(deg_scalars, zm_scalars)]
        scalars = [FElt(1, spec), z, eval_scalar * opening] + q_scalars
        bases = [proof.q_hat_com, commitment.point, self.vk.g1] + \
            list(proof.q_k_com)
        zeta_z = g1_msm_host(bases, [s.v for s in scalars])

        # e(zeta_z, -g2^{tau^S}) * e(pi, g2^{tau - x}) == 1
        g2_tau_minus_x = (G2Affine.generator().mul((-x.v) % spec.p)
                          .add(self.vk.beta_g2))
        if not pairing_product_is_one([(zeta_z.neg(), self.tau_shift_g2),
                                       (proof.pi, g2_tau_minus_x)]):
            raise VerificationError("Zeromorph pairing check failed")
