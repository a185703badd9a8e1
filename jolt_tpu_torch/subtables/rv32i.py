"""RV32I subtables of the mini VM: Eq, Identity and TruncateOverflow
(jolt_tpu/subtables/rv32i.py; reference jolt/subtable/{eq,identity,
truncate_overflow}.rs).

Materializers are vectorized numpy; MLEs are generic over FElt/DevF.  All
bit orders are big-endian (point[0] = most significant).
"""
from __future__ import annotations

import numpy as np

from .base import LassoSubtable, eval_operand_bits, split_operands


def _b(M: int) -> int:
    return (M.bit_length() - 1) // 2


class EqSubtable(LassoSubtable):
    name = "eq"

    def materialize_entries(self, M):
        x, y = split_operands(np.arange(M), _b(M))
        return (x == y).astype(np.uint64)

    def evaluate_mle(self, point):
        x, y = eval_operand_bits(point)
        result = None
        for xi, yi in zip(x, y):
            t = xi * yi + (1 - xi) * (1 - yi)
            result = t if result is None else result * t
        return result


class IdentitySubtable(LassoSubtable):
    name = "identity"

    def materialize_entries(self, M):
        return np.arange(M, dtype=np.uint64)

    def evaluate_mle(self, point):
        n = len(point)
        result = None
        for i in range(n):
            t = point[n - 1 - i] * (1 << i)
            result = t if result is None else result + t
        return result


class TruncateOverflowSubtable(LassoSubtable):
    """table[x] = x & ((1 << (WORD_SIZE % log2(M))) - 1)."""

    def __init__(self, word_size: int = 32):
        self.word_size = word_size
        self.name = f"truncate_overflow_{word_size}"

    def key(self):
        return ("TruncateOverflowSubtable", self.word_size)

    def materialize_entries(self, M):
        log_M = M.bit_length() - 1
        cutoff = self.word_size % log_M
        mask = np.uint64((1 << cutoff) - 1)
        return (np.arange(M, dtype=np.uint64) & mask)

    def evaluate_mle(self, point):
        log_M = len(point)
        cutoff = self.word_size % log_M
        result = 0 * point[0]
        for i in range(cutoff):
            result = result + point[len(point) - 1 - i] * (1 << i)
        return result
