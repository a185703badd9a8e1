"""Host-side univariate round polynomials (reference: poly/unipoly.rs).

Round polys have degree <= ~6; interpolation and evaluation are host scalar
math.  `CompressedUniPoly` drops the linear coefficient (unipoly.rs:134-140);
the verifier reconstructs it from the previous-round claim via
`eval_from_hint` (unipoly.rs:233-247) -- this compression is part of the
transcript/proof format and must match exactly.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

from ..field.host import FElt, batch_inverse
from ..transcript import Transcript


@dataclass
class UniPoly:
    coeffs: list[FElt]  # low-to-high degree

    @staticmethod
    def from_evals(evals: Sequence[FElt]) -> "UniPoly":
        """Interpolate from evaluations at x = 0, 1, ..., n-1 (Lagrange)."""
        evals = list(evals)
        n = len(evals)
        spec = evals[0].spec
        one = FElt(1, spec)
        if n == 1:
            return UniPoly([evals[0]])
        xs = [FElt(i, spec) for i in range(n)]
        # denominators d_i = prod_{j != i} (x_i - x_j)
        denoms = []
        for i in range(n):
            d = one
            for j in range(n):
                if j != i:
                    d = d * (xs[i] - xs[j])
            denoms.append(d)
        inv_denoms = batch_inverse(denoms)
        # accumulate coefficient form: sum_i y_i/d_i * prod_{j != i}(X - x_j)
        coeffs = [FElt(0, spec) for _ in range(n)]
        for i in range(n):
            poly = [one]
            for j in range(n):
                if j == i:
                    continue
                nxt = [FElt(0, spec) for _ in range(len(poly) + 1)]
                for k, c in enumerate(poly):
                    nxt[k + 1] = nxt[k + 1] + c
                    nxt[k] = nxt[k] - c * xs[j]
                poly = nxt
            w = evals[i] * inv_denoms[i]
            for k, c in enumerate(poly):
                coeffs[k] = coeffs[k] + c * w
        return UniPoly(coeffs)

    def degree(self) -> int:
        return len(self.coeffs) - 1

    def evaluate(self, x: FElt) -> FElt:
        acc = self.coeffs[0]
        power = x
        for c in self.coeffs[1:]:
            acc = acc + power * c
            power = power * x
        return acc

    def compress(self) -> "CompressedUniPoly":
        return CompressedUniPoly([self.coeffs[0]] + list(self.coeffs[2:]))


@dataclass
class CompressedUniPoly:
    coeffs_except_linear_term: list[FElt]

    def degree(self) -> int:
        return len(self.coeffs_except_linear_term)

    def eval_from_hint(self, hint: FElt, x: FElt) -> FElt:
        """Recover the linear term from hint = f(0) + f(1), then evaluate."""
        c = self.coeffs_except_linear_term
        linear = hint - c[0] - c[0]
        for ci in c[1:]:
            linear = linear - ci
        running_point = x
        running_sum = c[0] + x * linear
        for ci in c[1:]:
            running_point = running_point * x
            running_sum = running_sum + ci * running_point
        return running_sum

    def append_to_transcript(self, transcript: Transcript) -> None:
        transcript.append_message(b"UniPoly_begin")
        for c in self.coeffs_except_linear_term:
            transcript.append_scalar(c)
        transcript.append_message(b"UniPoly_end")
