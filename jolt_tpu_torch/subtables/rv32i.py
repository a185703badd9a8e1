"""The RV32I subtable zoo (reference: jolt/subtable/*.rs, 20 files;
jolt_tpu/subtables/rv32i.py).

Materializers are vectorized numpy (packed once to device Montgomery tensors
in preprocessing); MLEs are generic over FElt/DevF and match the reference's
closed forms exactly (the verifier evaluates them at random points).

Operand-pair tables use index (x << b) | y with b = log2(M)/2; single-operand
tables use the full log2(M)-bit index.  All bit orders are big-endian
(x[0]/point[0] = most significant).
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


class EqAbsSubtable(LassoSubtable):
    name = "eq_abs"

    def materialize_entries(self, M):
        b = _b(M)
        mask = np.uint64((1 << (b - 1)) - 1)
        x, y = split_operands(np.arange(M), b)
        return ((x & mask) == (y & mask)).astype(np.uint64)

    def evaluate_mle(self, point):
        x, y = eval_operand_bits(point)
        result = None
        for xi, yi in list(zip(x, y))[1:]:  # skip MSB
            t = xi * yi + (1 - xi) * (1 - yi)
            result = t if result is None else result * t
        return result


class LtuSubtable(LassoSubtable):
    name = "ltu"

    def materialize_entries(self, M):
        x, y = split_operands(np.arange(M), _b(M))
        return (x < y).astype(np.uint64)

    def evaluate_mle(self, point):
        x, y = eval_operand_bits(point)
        result = None
        eq_term = None
        for xi, yi in zip(x, y):
            term = (1 - xi) * yi if eq_term is None else (1 - xi) * yi * eq_term
            result = term if result is None else result + term
            e = 1 - xi - yi + xi * yi + xi * yi
            eq_term = e if eq_term is None else eq_term * e
        return result


class LtAbsSubtable(LassoSubtable):
    name = "lt_abs"

    def materialize_entries(self, M):
        b = _b(M)
        mask = np.uint64((1 << (b - 1)) - 1)
        x, y = split_operands(np.arange(M), b)
        return ((x & mask) < (y & mask)).astype(np.uint64)

    def evaluate_mle(self, point):
        x, y = eval_operand_bits(point)
        result = None
        eq_term = None
        for xi, yi in list(zip(x, y))[1:]:  # skip MSB
            term = (1 - xi) * yi if eq_term is None else (1 - xi) * yi * eq_term
            result = term if result is None else result + term
            e = 1 - xi - yi + xi * yi + xi * yi
            eq_term = e if eq_term is None else eq_term * e
        return result


class LeftMSBSubtable(LassoSubtable):
    name = "left_msb"

    def materialize_entries(self, M):
        b = _b(M)
        x, _ = split_operands(np.arange(M), b)
        return ((x >> np.uint64(b - 1)) & np.uint64(1)).astype(np.uint64)

    def evaluate_mle(self, point):
        x, _ = eval_operand_bits(point)
        return x[0]


class RightMSBSubtable(LassoSubtable):
    name = "right_msb"

    def materialize_entries(self, M):
        b = _b(M)
        _, y = split_operands(np.arange(M), b)
        return ((y >> np.uint64(b - 1)) & np.uint64(1)).astype(np.uint64)

    def evaluate_mle(self, point):
        _, y = eval_operand_bits(point)
        return y[0]


class LeftIsZeroSubtable(LassoSubtable):
    name = "left_is_zero"

    def materialize_entries(self, M):
        x, _ = split_operands(np.arange(M), _b(M))
        return (x == 0).astype(np.uint64)

    def evaluate_mle(self, point):
        x, _ = eval_operand_bits(point)
        result = None
        for xi in x:
            t = 1 - xi
            result = t if result is None else result * t
        return result


class RightIsZeroSubtable(LassoSubtable):
    name = "right_is_zero"

    def materialize_entries(self, M):
        _, y = split_operands(np.arange(M), _b(M))
        return (y == 0).astype(np.uint64)

    def evaluate_mle(self, point):
        _, y = eval_operand_bits(point)
        result = None
        for yi in y:
            t = 1 - yi
            result = t if result is None else result * t
        return result


class DivByZeroSubtable(LassoSubtable):
    name = "div_by_zero"

    def materialize_entries(self, M):
        b = _b(M)
        x, y = split_operands(np.arange(M), b)
        return ((x == 0) & (y == np.uint64((1 << b) - 1))).astype(np.uint64)

    def evaluate_mle(self, point):
        x, y = eval_operand_bits(point)
        result = None
        for xi, yi in zip(x, y):
            t = (1 - xi) * yi
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


class SignExtendSubtable(LassoSubtable):
    """table[x] = sign_bit(x, WIDTH) * (2^WIDTH - 1)."""

    def __init__(self, width: int):
        self.width = width
        self.name = f"sign_extend_{width}"

    def key(self):
        return ("SignExtendSubtable", self.width)

    def materialize_entries(self, M):
        idx = np.arange(M, dtype=np.uint64)
        sign = (idx >> np.uint64(self.width - 1)) & np.uint64(1)
        return sign * np.uint64((1 << self.width) - 1)

    def evaluate_mle(self, point):
        sign_bit = point[len(point) - self.width]
        return sign_bit * ((1 << self.width) - 1)


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


class ZeroLSBSubtable(LassoSubtable):
    """table[x] = x with the least significant bit zeroed."""

    name = "zero_lsb"

    def materialize_entries(self, M):
        idx = np.arange(M, dtype=np.uint64)
        return idx & ~np.uint64(1)

    def evaluate_mle(self, point):
        n = len(point)
        result = 0 * point[0]
        for i in range(1, n):
            result = result + point[n - 1 - i] * (1 << i)
        return result


def _k_bits(k: int, log_ws: int):
    """big-endian bits of k as ints."""
    return [(k >> (log_ws - 1 - i)) & 1 for i in range(log_ws)]


class SllSubtable(LassoSubtable):
    """Chunked left-shift subtable (jolt/subtable/sll.rs)."""

    def __init__(self, chunk_index: int, word_size: int = 32):
        self.chunk_index = chunk_index
        self.word_size = word_size
        self.name = f"sll_{chunk_index}"

    def key(self):
        return ("SllSubtable", self.chunk_index, self.word_size)

    def materialize_entries(self, M):
        b = _b(M)
        ws = self.word_size
        suffix = b * self.chunk_index
        x, y = split_operands(np.arange(M), b)
        shift = (y % np.uint64(ws)).astype(np.uint64)
        shifted = np.where(shift < 64, x << shift, 0)
        if ws - suffix >= 64:
            mask = np.uint64(0xFFFFFFFFFFFFFFFF)
        else:
            mask = np.uint64((1 << (ws - suffix)) - 1)
        return (shifted & mask).astype(np.uint64)

    def evaluate_mle(self, point):
        x, y = eval_operand_bits(point)
        b = len(x)
        ws = self.word_size
        log_ws = ws.bit_length() - 1
        result = 0 * point[0]
        for k in range(min(ws, 1 << b)):
            kb = _k_bits(k, log_ws)
            eq_term = None
            for i in range(min(log_ws, b)):
                kbit = kb[log_ws - 1 - i]
                yi = y[b - 1 - i]
                t = yi * kbit + (1 - yi) * (1 - kbit)
                eq_term = t if eq_term is None else eq_term * t
            m = min(b, max(0, (k + b * (self.chunk_index + 1)) - ws)) \
                if (k + b * (self.chunk_index + 1)) > ws else 0
            m_prime = b - m
            acc = 0 * point[0]
            for j in range(m_prime):
                acc = acc + x[b - 1 - j] * (1 << (j + k))
            result = result + eq_term * acc
        return result


class SrlSubtable(LassoSubtable):
    """Chunked logical right-shift subtable (jolt/subtable/srl.rs)."""

    def __init__(self, chunk_index: int, word_size: int = 32):
        self.chunk_index = chunk_index
        self.word_size = word_size
        self.name = f"srl_{chunk_index}"

    def key(self):
        return ("SrlSubtable", self.chunk_index, self.word_size)

    def materialize_entries(self, M):
        b = _b(M)
        ws = self.word_size
        suffix = b * self.chunk_index
        x, y = split_operands(np.arange(M), b)
        up = np.where(suffix < 64, x << np.uint64(suffix), 0)
        shift = (y % np.uint64(ws)).astype(np.uint64)
        return (up >> shift).astype(np.uint64)

    def evaluate_mle(self, point):
        x, y = eval_operand_bits(point)
        b = len(x)
        ws = self.word_size
        log_ws = ws.bit_length() - 1
        ci = self.chunk_index
        result = 0 * point[0]
        for k in range(min(ws, 1 << b)):
            kb = _k_bits(k, log_ws)
            eq_term = None
            for i in range(min(log_ws, b)):
                kbit = kb[log_ws - 1 - i]
                yi = y[b - 1 - i]
                t = yi * kbit + (1 - yi) * (1 - kbit)
                eq_term = t if eq_term is None else eq_term * t
            m = min(b, k - b * ci) if k > b * ci else 0
            chunk_length = min(b, ws - b * ci)
            acc = 0 * point[0]
            for j in range(m, chunk_length):
                acc = acc + x[b - 1 - j] * (1 << (b * ci + j - k))
            result = result + eq_term * acc
        return result


class SraSignSubtable(LassoSubtable):
    """Arithmetic-shift sign-fill subtable (jolt/subtable/sra_sign.rs)."""

    def __init__(self, word_size: int = 32):
        self.word_size = word_size
        self.name = "sra_sign"

    def key(self):
        return ("SraSignSubtable", self.word_size)

    def materialize_entries(self, M):
        b = _b(M)
        ws = self.word_size
        sign_idx = (ws - 1) % b
        x, y = split_operands(np.arange(M), b)
        x_sign = (x >> np.uint64(sign_idx)) & np.uint64(1)
        shift = (y % np.uint64(ws)).astype(np.int64)
        # fill = sum_{i<shift} 2^(ws-1-i)
        fill = np.zeros(M, dtype=np.uint64)
        for s in range(ws):
            mask = shift == s
            val = 0
            for i in range(s):
                val += 1 << (ws - 1 - i)
            fill[mask] = val
        return np.where(x_sign == 1, fill, np.uint64(0)).astype(np.uint64)

    def evaluate_mle(self, point):
        x, y = eval_operand_bits(point)
        b = len(x)
        ws = self.word_size
        log_ws = ws.bit_length() - 1
        sign_index = (ws - 1) % b
        x_sign = x[b - 1 - sign_index]
        result = 0 * point[0]
        for k in range(min(ws, 1 << b)):
            kb = _k_bits(k, log_ws)
            eq_term = None
            for i in range(min(log_ws, b)):
                kbit = kb[log_ws - 1 - i]
                yi = y[b - 1 - i]
                t = yi * kbit + (1 - yi) * (1 - kbit)
                eq_term = t if eq_term is None else eq_term * t
            acc = 0 * point[0]
            for i in range(k):
                acc = acc + x_sign * (1 << (ws - 1 - i))
            result = result + eq_term * acc
        return result
