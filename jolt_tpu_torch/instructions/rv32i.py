"""RV32I lookup instructions of the port: XOR (jolt_tpu/instructions/
rv32i.py:154-201, the bitwise family that Surge benchmarks)."""
from __future__ import annotations

from ..subtables.bitwise import XorSubtable
from ..utils.math import log2_strict
from .base import JoltInstruction, SubtableIndices
from .utils import _u, chunk_and_concatenate_operands_vec, concatenate_lookups


class XorInstruction(JoltInstruction):
    name = "xor"
    subtable_cls = XorSubtable

    def combine_lookups(self, vals, C, M):
        return concatenate_lookups(vals, C, log2_strict(M) // 2)

    def g_poly_degree(self, C):
        return 1

    def subtables(self, C, M):
        return [(self.subtable_cls(), SubtableIndices(range(C)))]

    @classmethod
    def to_indices_vec(cls, x, y, C, log_M):
        return chunk_and_concatenate_operands_vec(x, y, C, log_M)

    @classmethod
    def lookup_entry_vec(cls, x, y):
        return _u(x) ^ _u(y)
