"""Lasso subtable interface (reference: jolt/subtable/mod.rs:8-21).

A subtable is a size-M lookup table with a closed-form multilinear extension:
  * `materialize_entries(M)` -> vectorized numpy u64 entries (prover side;
    packed to device Montgomery tensors once per preprocessing)
  * `evaluate_mle(point)` -> generic over FElt (host verifier) / DevF (device)

Index convention: an M-entry table has log2(M) variables, big-endian (the
first variable is the most significant index bit), matching EqPolynomial.
For two-operand subtables the index is (x << b) | y with b = log2(M)/2.
"""
from __future__ import annotations

import numpy as np


def split_operands(idx: np.ndarray, b: int):
    """Vectorized split of table index into (x, y) operand halves."""
    idx = np.asarray(idx, dtype=np.uint64)
    return idx >> np.uint64(b), idx & np.uint64((1 << b) - 1)


class LassoSubtable:
    """Base class; subclasses define entries + closed-form MLE."""

    name: str = "subtable"

    def materialize_entries(self, M: int) -> np.ndarray:
        raise NotImplementedError

    def evaluate_mle(self, point):
        """point: list of generic field elements, big-endian."""
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}()"

    def key(self) -> tuple:
        return (type(self).__name__,)

    def __eq__(self, other):
        return isinstance(other, LassoSubtable) and self.key() == other.key()

    def __hash__(self):
        return hash(self.key())


def eval_operand_bits(point):
    """Split an MLE point into (x_bits, y_bits) halves (big-endian)."""
    b = len(point) // 2
    assert len(point) % 2 == 0
    return point[:b], point[b:]
