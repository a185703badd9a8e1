"""Batched GKR grand products (Thaler'13 layered circuits).

Reference semantics: jolt-core/src/subprotocols/grand_product.rs --
interleaved [L0, R0, L1, R1, ...] layers, product-tree construction,
per-layer batched cubic sumcheck with least-significant-variable binding,
claim folding with a per-layer challenge, and verification that replays
eq(r_gp, rev(r_sumcheck)).

Layout (jolt_tpu's): a layer is a PAIR of batch-leading limb tensors
(l, r): int32[B, 16, s] holding the left/right polynomials in
BIT-REVERSED evaluation order, so every round's sibling pairs (2i, 2i+1)
sit at (i, i + s/2): the round kernels (K2 evals, K3 bind) read contiguous
halves and the bind outputs are the next round's layers.  Sums mod p do
not depend on order, so every transcript byte equals the reference's.

The port runs jolt_tpu's CPU path (`_prove_dense_layers`,
grand_product.py:739, unmasked and shrinking) with every layer and every
round on the device, down to pair size 2; the TPU-only mechanisms (masked
fixed-shape rounds, class-buffered trees, host tails, device Fiat-Shamir)
stay behind.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

import torch

from ..field import device as fd
from ..field import kernels as fk
from ..field.host import FElt
from ..field.spec import FieldSpec, fr_spec
from ..poly.mle import bitrev_indices, eq_evals_device_br
from ..poly.unipoly import CompressedUniPoly, UniPoly
from ..transcript import Transcript
from .sumcheck import SumcheckInstanceProof, VerificationError


@dataclass
class BatchedGrandProductLayerProof:
    proof: SumcheckInstanceProof
    left_claims: list[FElt]
    right_claims: list[FElt]


@dataclass
class BatchedGrandProductProof:
    layers: list[BatchedGrandProductLayerProof]


# ---------------------------------------------------------------------------
# device layers
# ---------------------------------------------------------------------------

def _interleaved_to_pair(spec: FieldSpec, leaves: torch.Tensor):
    """Interleaved leaves [16, B, n] -> bit-reversed batch-leading pair
    (l, r): [B, 16, n/2] each (views of one [B, 16, n] tensor).  The left
    poly occupies even interleaved indices: the first half after
    bit-reversal."""
    n = leaves.shape[-1]
    idx = torch.from_numpy(bitrev_indices(n)).to(leaves.device)
    arr = leaves.index_select(-1, idx).movedim(0, 1).contiguous()
    return arr[..., : n // 2], arr[..., n // 2:]


def _pair_tree_level(spec: FieldSpec, l: torch.Tensor, r: torch.Tensor):
    """Next tree level: l*r elementwise (K4), split into contiguous halves.
    The parent interleaved layer's bit-reversed array IS l*r; its
    left/right polys are its halves."""
    prod = fk.mont_mul_bl(spec, l, r)
    s = prod.shape[-1]
    return prod[..., : s // 2], prod[..., s // 2:]


def _pair_cubic_evals(spec: FieldSpec, l, r, eq, coeffs) -> torch.Tensor:
    """Cubic round-poly evaluations at t = 0, 2, 3 -> [16, 3] (K2)."""
    return fk.gp_pair_evals(spec, l, r, eq, coeffs)


def _pair_bind(spec: FieldSpec, l, r, eq, r_chal):
    """Bind the bottom variable on contiguous halves (K3)."""
    return fk.gp_pair_bind(spec, l, r, eq, r_chal)


def _build_pair_tree(spec: FieldSpec, leaves: torch.Tensor) -> list:
    """Interleaved leaves [16, B, n] -> pair layers bottom-up (layers[0]
    the largest, layers[-1] of pair size 1)."""
    layers = [_interleaved_to_pair(spec, leaves)]
    while layers[-1][0].shape[-1] > 1:
        layers.append(_pair_tree_level(spec, *layers[-1]))
    return layers


def _felts(spec: FieldSpec, a: torch.Tensor) -> list[FElt]:
    return [FElt(int(v), spec) for v in fd.device_to_ints(spec, a).tolist()]


class BatchedDenseGrandProduct:
    """B independent grand products over 2^k leaves, proved jointly."""

    def __init__(self, layers: list[tuple], spec: FieldSpec):
        self.layers = layers  # [(l, r)] pairs, layers[0] = leaves, bit-rev
        self.spec = spec

    @staticmethod
    def construct(leaves: torch.Tensor, spec: FieldSpec | None = None
                  ) -> "BatchedDenseGrandProduct":
        spec = spec or fr_spec()
        return BatchedDenseGrandProduct(_build_pair_tree(spec, leaves), spec)

    def num_layers(self) -> int:
        return len(self.layers)

    def claims(self) -> list[FElt]:
        l, r = self.layers[-1]
        return _felts(self.spec, fd.fmul(self.spec, l[..., 0].T, r[..., 0].T))

    def prove(self, transcript: Transcript
              ) -> tuple[BatchedGrandProductProof, list[FElt]]:
        layer_proofs, r_grand_product, _ = _prove_dense_layers(
            self.spec, self.layers, self.claims(), [], transcript)
        return BatchedGrandProductProof(layer_proofs), r_grand_product


def _prove_dense_layers(spec: FieldSpec, layers: list[tuple],
                        claims: list[FElt], r_grand_product: list[FElt],
                        transcript: Transcript):
    """Prove multiplication-gate layers top-down (grand_product.rs:199-251).

    `layers` are (l, r) bit-reversed pairs, bottom-up; each is released as
    it is consumed.  Returns (layer_proofs, r_grand_product, claims) after
    folding each layer's left/right claims with a fresh challenge."""
    layer_proofs: list[BatchedGrandProductLayerProof] = []
    for li in range(len(layers) - 1, -1, -1):
        l, r = layers[li]
        layers[li] = None
        dev = l.device
        coeffs = transcript.challenge_vector(len(claims))
        joint_claim = FElt(0, spec)
        for c, co in zip(claims, coeffs):
            joint_claim = joint_claim + c * co
        coeffs_dev = fd.ints_to_device(spec, [c.v for c in coeffs], dev)
        eq = eq_evals_device_br(spec, r_grand_product, dev)

        r_sumcheck: list[FElt] = []
        compressed: list[CompressedUniPoly] = []
        previous_claim = joint_claim
        for _ in range(len(r_grand_product)):
            e0, e2, e3 = _felts(spec, _pair_cubic_evals(spec, l, r, eq,
                                                        coeffs_dev))
            round_poly = UniPoly.from_evals([e0, previous_claim - e0, e2, e3])
            cpoly = round_poly.compress()
            cpoly.append_to_transcript(transcript)
            r_j = transcript.challenge_scalar()
            r_sumcheck.append(r_j)
            l, r, eq = _pair_bind(spec, l, r, eq,
                                  fd.scalar_to_device(spec, r_j.v, "cpu"))
            previous_claim = round_poly.evaluate(r_j)
            compressed.append(cpoly)

        finals = _felts(spec, torch.cat([l[..., 0].T, r[..., 0].T], dim=1))
        B = l.shape[0]
        left_claims, right_claims = finals[:B], finals[B:]
        for lc, rc in zip(left_claims, right_claims):
            transcript.append_scalar(lc)
            transcript.append_scalar(rc)

        r_grand_product = list(reversed(r_sumcheck))
        r_layer = transcript.challenge_scalar()
        claims = [lc + r_layer * (rc - lc)
                  for lc, rc in zip(left_claims, right_claims)]
        r_grand_product.append(r_layer)
        layer_proofs.append(BatchedGrandProductLayerProof(
            SumcheckInstanceProof(compressed), left_claims, right_claims))
    return layer_proofs, r_grand_product, claims


# ---------------------------------------------------------------------------
# verifier (host)
# ---------------------------------------------------------------------------

def default_verify_sumcheck_claim(layer_proof: BatchedGrandProductLayerProof,
                                  coeffs: list[FElt], sumcheck_claim: FElt,
                                  eq_eval: FElt, claims: list[FElt],
                                  r_grand_product: list[FElt],
                                  transcript: Transcript,
                                  layer_index: int = 0, num_layers: int = 0
                                  ) -> tuple[list[FElt], list[FElt]]:
    """Multiplication-gate layer claim check (grand_product.rs:89-122)."""
    spec = sumcheck_claim.spec
    expected = FElt(0, spec)
    for co, lc, rc in zip(coeffs, layer_proof.left_claims,
                          layer_proof.right_claims):
        expected = expected + co * lc * rc * eq_eval
    if expected != sumcheck_claim:
        raise VerificationError("grand product layer claim mismatch")

    r_layer = transcript.challenge_scalar()
    new_claims = [lc + r_layer * (rc - lc)
                  for lc, rc in zip(layer_proof.left_claims,
                                    layer_proof.right_claims)]
    return new_claims, r_grand_product + [r_layer]


def verify_grand_product(proof: BatchedGrandProductProof,
                         claims: Sequence[FElt],
                         transcript: Transcript,
                         r_start: Sequence[FElt] = (),
                         verify_sumcheck_claim: Callable = default_verify_sumcheck_claim,
                         ) -> tuple[list[FElt], list[FElt]]:
    """Layer-by-layer verification (grand_product.rs:122-182).

    Returns (final claims = leaf-MLE evaluations, r_grand_product)."""
    claims_to_verify = list(claims)
    r_grand_product = list(r_start)
    fixed_at_start = len(r_start)
    spec = claims_to_verify[0].spec
    one = FElt(1, spec)

    for layer_index, layer_proof in enumerate(proof.layers):
        coeffs = transcript.challenge_vector(len(claims_to_verify))
        joint_claim = FElt(0, spec)
        for c, co in zip(claims_to_verify, coeffs):
            joint_claim = joint_claim + c * co

        sumcheck_claim, r_sumcheck = layer_proof.proof.verify(
            joint_claim, layer_index + fixed_at_start, 3, transcript)
        if len(claims_to_verify) != len(layer_proof.left_claims):
            raise VerificationError("grand product layer has the wrong batch")

        for lc, rc in zip(layer_proof.left_claims, layer_proof.right_claims):
            transcript.append_scalar(lc)
            transcript.append_scalar(rc)

        if len(r_grand_product) != len(r_sumcheck):
            raise VerificationError("grand product layer has the wrong rounds")
        eq_eval = one
        for r_gp, r_sc in zip(r_grand_product, reversed(r_sumcheck)):
            eq_eval = eq_eval * (r_gp * r_sc + (one - r_gp) * (one - r_sc))

        r_grand_product = list(reversed(r_sumcheck))
        claims_to_verify, r_grand_product = verify_sumcheck_claim(
            layer_proof, coeffs, sumcheck_claim, eq_eval, claims_to_verify,
            r_grand_product, transcript, layer_index, len(proof.layers))

    return claims_to_verify, r_grand_product
