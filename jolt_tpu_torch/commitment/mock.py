"""Mock commitment scheme for testing (reference: poly/commitment/mock.rs,
jolt_tpu/commitment/mock.py).

The commitment retains the full polynomial (host ints); `verify` evaluates
it directly.  Like the reference's mock, commitments append nothing to the
transcript, so e2e tests isolate proof-system bugs from PCS bugs
(rv32i_vm.rs:308-311 `fib_e2e_mock`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch

from ..field import device as fd
from ..field.host import FElt
from ..field.spec import FieldSpec, fr_spec
from ..poly.mle import evaluate_host
from ..subprotocols.sumcheck import VerificationError
from ..transcript import Transcript
from .base import BatchType


@dataclass
class MockCommitment:
    evals: list[FElt]  # full polynomial, canonical ints

    def append_to_transcript(self, transcript: Transcript) -> None:
        pass  # mock commitments contribute nothing (mock.rs:29-31)


class MockCommitmentScheme:
    def __init__(self, spec: FieldSpec | None = None):
        self.spec = spec or fr_spec()

    @staticmethod
    def protocol_name() -> bytes:
        return b"mock_commit"

    def commit(self, poly: torch.Tensor) -> MockCommitment:
        return MockCommitment([FElt(int(v), self.spec) for v in
                               fd.device_to_ints(self.spec, poly).tolist()])

    def batch_commit(self, polys: Sequence[torch.Tensor],
                     batch_type: BatchType = BatchType.BIG, mesh=None
                     ) -> list[MockCommitment]:
        # no MSM: nothing for a mesh to split
        return [self.commit(p) for p in polys]

    def prove(self, poly: torch.Tensor, opening_point: Sequence[FElt],
              transcript: Transcript):
        return None

    def verify(self, proof, transcript: Transcript,
               opening_point: Sequence[FElt], opening: FElt,
               commitment: MockCommitment) -> None:
        if evaluate_host(commitment.evals, list(opening_point)) != opening:
            raise VerificationError("mock PCS: evaluation mismatch")

    def combine_commitments(self, commitments: Sequence[MockCommitment],
                            coeffs: Sequence[FElt]) -> MockCommitment:
        n = max(len(c.evals) for c in commitments)
        out = [FElt(0, self.spec)] * n
        for c, co in zip(commitments, coeffs):
            for i, e in enumerate(c.evals):
                out[i] = out[i] + co * e
        return MockCommitment(out)
