"""RV32I lookup instructions of the port (jolt_tpu/instructions/rv32i.py):
XOR, the bitwise family that Surge benchmarks, and ADD and BNE, the mini
VM's instruction set.  WORD_SIZE = 32."""
from __future__ import annotations

import numpy as np

from ..subtables.bitwise import XorSubtable
from ..subtables.rv32i import (EqSubtable, IdentitySubtable,
                               TruncateOverflowSubtable)
from ..utils.math import log2_strict
from .base import JoltInstruction, SubtableIndices
from .utils import (_u, add_and_chunk_operands_vec,
                    chunk_and_concatenate_operands_vec, concatenate_lookups)

WS = 32
_U32 = np.uint64(0xFFFFFFFF)


def _prod(vals):
    out = None
    for v in vals:
        out = v if out is None else out * v
    return out


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


class AddInstruction(JoltInstruction):
    """Collation = concatenate all chunks; the high chunks read the
    width-cutoff TruncateOverflow table, so the result is mod 2^WS."""
    name = "add"

    def combine_lookups(self, vals, C, M):
        return concatenate_lookups(vals, C, log2_strict(M))

    def g_poly_degree(self, C):
        return 1

    def subtables(self, C, M):
        msb = C - (WS // log2_strict(M)) - 1
        return [
            (TruncateOverflowSubtable(WS), SubtableIndices(range(msb + 1))),
            (IdentitySubtable(), SubtableIndices(range(msb + 1, C))),
        ]

    @classmethod
    def to_indices_vec(cls, x, y, C, log_M):
        return add_and_chunk_operands_vec(x, y, C, log_M)

    @classmethod
    def lookup_entry_vec(cls, x, y):
        return (_u(x) + _u(y)) & _U32


class BneInstruction(JoltInstruction):
    name = "bne"

    def combine_lookups(self, vals, C, M):
        return 1 - _prod(vals)

    def g_poly_degree(self, C):
        return C

    def subtables(self, C, M):
        return [(EqSubtable(), SubtableIndices(range(C)))]

    @classmethod
    def to_indices_vec(cls, x, y, C, log_M):
        return chunk_and_concatenate_operands_vec(x, y, C, log_M)

    @classmethod
    def lookup_entry_vec(cls, x, y):
        return (_u(x) != _u(y)).astype(np.uint64)
