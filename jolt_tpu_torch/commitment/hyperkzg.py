"""HyperKZG multilinear PCS, prover setup and commitments
(reference: poly/commitment/hyperkzg.rs).

The commitment to a multilinear polynomial is the KZG commitment to its
evaluation vector.  Opening (`prove`), `verify` and the pairing wait for a
later slice: Surge never opens, because the fork disabled its opening
accumulation (jolt_tpu/lasso/surge.py:304).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch

from .._device import resolve_device
from ..curve.bn254 import G1Affine
from ..transcript import Transcript
from .base import BatchType
from .kzg import SRS_SEED, KZGProverKey, kzg_commit_batch, srs_setup


@dataclass
class HyperKZGCommitment:
    point: G1Affine

    def append_to_transcript(self, transcript: Transcript) -> None:
        transcript.append_point(None if self.point.is_infinity else self.point)

    def __eq__(self, other):
        return self.point == other.point


class HyperKZG:
    def __init__(self, pk: KZGProverKey):
        self.pk = pk

    @staticmethod
    def protocol_name() -> bytes:
        return b"HyperKZG"

    @classmethod
    def setup(cls, max_len: int, seed: int = SRS_SEED, device=None
              ) -> "HyperKZG":
        """An SRS of max_len points on `device` (default: the CUDA card)."""
        return cls(srs_setup(max_len, resolve_device(device), seed))

    def batch_commit(self, polys: Sequence[torch.Tensor],
                     batch_type: BatchType = BatchType.BIG
                     ) -> list[HyperKZGCommitment]:
        """Commitments to Montgomery Fr vectors [16, n].  Every batch type
        commits the same points; the reference's GrandProduct shortcut
        (kzg.rs:223-256) changes only how fast, not what."""
        return [HyperKZGCommitment(p)
                for p in kzg_commit_batch(self.pk, list(polys))]
