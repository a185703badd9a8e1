"""AND/OR/XOR subtables (reference: jolt/subtable/{and,or,xor}.rs,
jolt_tpu/subtables/bitwise.py).

Entry at index (x||y): the bitwise op applied to the b-bit operands.
MLE: sum_i 2^i * g(x_{b-1-i}, y_{b-1-i}) with per-bit gate polynomials.
"""
from __future__ import annotations

import numpy as np

from .base import LassoSubtable, eval_operand_bits, split_operands


class AndSubtable(LassoSubtable):
    name = "and"

    def materialize_entries(self, M: int) -> np.ndarray:
        x, y = split_operands(np.arange(M), (M.bit_length() - 1) // 2)
        return (x & y).astype(np.uint64)

    def evaluate_mle(self, point):
        x, y = eval_operand_bits(point)
        b = len(x)
        result = None
        for i in range(b):
            term = (1 << i) * (x[b - 1 - i] * y[b - 1 - i])
            result = term if result is None else result + term
        return result


class OrSubtable(LassoSubtable):
    name = "or"

    def materialize_entries(self, M: int) -> np.ndarray:
        x, y = split_operands(np.arange(M), (M.bit_length() - 1) // 2)
        return (x | y).astype(np.uint64)

    def evaluate_mle(self, point):
        x, y = eval_operand_bits(point)
        b = len(x)
        result = None
        for i in range(b):
            xi, yi = x[b - 1 - i], y[b - 1 - i]
            term = (1 << i) * (xi + yi - xi * yi)
            result = term if result is None else result + term
        return result


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
