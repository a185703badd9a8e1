"""The XOR subtable (reference: jolt/subtable/xor.rs).

Entry at index (x||y): x ^ y over b-bit operands.
MLE: sum_i 2^i * (x_i + y_i - 2 x_i y_i) over the bits, most significant
first.
"""
from __future__ import annotations

import numpy as np

from .base import LassoSubtable, eval_operand_bits, split_operands


class XorSubtable(LassoSubtable):
    name = "xor"

    def materialize_entries(self, M: int) -> np.ndarray:
        x, y = split_operands(np.arange(M), (M.bit_length() - 1) // 2)
        return (x ^ y).astype(np.uint64)

    def evaluate_mle(self, point):
        x, y = eval_operand_bits(point)
        b = len(x)
        result = None
        for i in range(b):
            xi, yi = x[b - 1 - i], y[b - 1 - i]
            term = (1 << i) * (xi + yi - 2 * (xi * yi))
            result = term if result is None else result + term
        return result
