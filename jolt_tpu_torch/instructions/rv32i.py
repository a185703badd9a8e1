"""The RV32I(+virtual) instruction zoo (reference: jolt/instruction/*,
jolt_tpu/instructions/rv32i.py).

29 instructions, each defining operand chunking, subtable usage (with
per-chunk SubtableIndices), the collation polynomial g (generic over
FElt/DevF), its degree, and native u64 semantics (vectorized over numpy
operand arrays).  WORD_SIZE = 32.
"""
from __future__ import annotations

import numpy as np

from ..subtables.bitwise import AndSubtable, OrSubtable, XorSubtable
from ..subtables.rv32i import (DivByZeroSubtable, EqAbsSubtable, EqSubtable,
                               IdentitySubtable, LeftIsZeroSubtable,
                               LeftMSBSubtable, LtAbsSubtable, LtuSubtable,
                               RightIsZeroSubtable, RightMSBSubtable,
                               SignExtendSubtable, SllSubtable,
                               SraSignSubtable, SrlSubtable,
                               TruncateOverflowSubtable)
from .base import JoltInstruction, SubtableIndices
from .utils import (_u, add_and_chunk_operands_vec,
                    chunk_and_concatenate_for_shift_vec,
                    chunk_and_concatenate_operands_vec, chunk_operand_vec,
                    concatenate_lookups, multiply_and_chunk_operands_vec)

WS = 32
_U32 = np.uint64(0xFFFFFFFF)


def _log_m(M):
    return M.bit_length() - 1


def _prod(vals):
    out = None
    for v in vals:
        out = v if out is None else out * v
    return out


def _sum(vals):
    out = None
    for v in vals:
        out = v if out is None else out + v
    return out


# ---------------------------------------------------------------------------
# arithmetic (ADD / SUB / MUL / MULU / MULHU)
# ---------------------------------------------------------------------------

class _TruncIdentityCombine(JoltInstruction):
    """Collation = concatenate all chunks; high chunks are zeroed by the
    width-cutoff TruncateOverflow table, so the result is mod 2^WS."""

    def combine_lookups(self, vals, C, M):
        return concatenate_lookups(vals, C, _log_m(M))

    def g_poly_degree(self, C):
        return 1

    def subtables(self, C, M):
        msb = C - (WS // _log_m(M)) - 1
        return [
            (TruncateOverflowSubtable(WS), SubtableIndices(range(msb + 1))),
            (IdentitySubtable(), SubtableIndices(range(msb + 1, C))),
        ]


class AddInstruction(_TruncIdentityCombine):
    name = "add"

    @classmethod
    def to_indices_vec(cls, x, y, C, log_M):
        return add_and_chunk_operands_vec(x, y, C, log_M)

    @classmethod
    def lookup_entry_vec(cls, x, y):
        return (_u(x) + _u(y)) & _U32


class SubInstruction(_TruncIdentityCombine):
    name = "sub"

    @classmethod
    def to_indices_vec(cls, x, y, C, log_M):
        # x + (2^WS - y), matching the reference's u128 arithmetic (sub.rs)
        return add_and_chunk_operands_vec(_u(x), (np.uint64(1 << WS) - _u(y)),
                                          C, log_M)

    @classmethod
    def lookup_entry_vec(cls, x, y):
        return (_u(x) - _u(y)) & _U32


class MulInstruction(_TruncIdentityCombine):
    name = "mul"

    @classmethod
    def to_indices_vec(cls, x, y, C, log_M):
        return multiply_and_chunk_operands_vec(x, y, C, log_M)

    @classmethod
    def lookup_entry_vec(cls, x, y):
        with np.errstate(over="ignore"):
            return (_u(x) * _u(y)) & _U32


class MulUInstruction(MulInstruction):
    name = "mulu"


class MulHUInstruction(JoltInstruction):
    name = "mulhu"

    def combine_lookups(self, vals, C, M):
        return concatenate_lookups(vals, len(vals), _log_m(M))

    def g_poly_degree(self, C):
        return 1

    def subtables(self, C, M):
        assert C * _log_m(M) == 2 * WS
        return [(IdentitySubtable(), SubtableIndices(range(C // 2)))]

    @classmethod
    def to_indices_vec(cls, x, y, C, log_M):
        return multiply_and_chunk_operands_vec(x, y, C, log_M)

    @classmethod
    def lookup_entry_vec(cls, x, y):
        with np.errstate(over="ignore"):
            return (_u(x) * _u(y)) >> np.uint64(32)


# ---------------------------------------------------------------------------
# bitwise (AND / OR / XOR) — reuse bitwise.py but with partial-range API
# ---------------------------------------------------------------------------

class AndInstruction(JoltInstruction):
    name = "and"
    subtable_cls = AndSubtable

    def combine_lookups(self, vals, C, M):
        return concatenate_lookups(vals, C, _log_m(M) // 2)

    def g_poly_degree(self, C):
        return 1

    def subtables(self, C, M):
        return [(self.subtable_cls(), SubtableIndices(range(C)))]

    @classmethod
    def to_indices_vec(cls, x, y, C, log_M):
        return chunk_and_concatenate_operands_vec(x, y, C, log_M)

    @classmethod
    def lookup_entry_vec(cls, x, y):
        return _u(x) & _u(y)


class OrInstruction(AndInstruction):
    name = "or"
    subtable_cls = OrSubtable

    @classmethod
    def lookup_entry_vec(cls, x, y):
        return _u(x) | _u(y)


class XorInstruction(AndInstruction):
    name = "xor"
    subtable_cls = XorSubtable

    @classmethod
    def lookup_entry_vec(cls, x, y):
        return _u(x) ^ _u(y)


# ---------------------------------------------------------------------------
# comparisons / branches
# ---------------------------------------------------------------------------

class BeqInstruction(JoltInstruction):
    name = "beq"

    def combine_lookups(self, vals, C, M):
        return _prod(vals)

    def g_poly_degree(self, C):
        return C

    def subtables(self, C, M):
        return [(EqSubtable(), SubtableIndices(range(C)))]

    @classmethod
    def to_indices_vec(cls, x, y, C, log_M):
        return chunk_and_concatenate_operands_vec(x, y, C, log_M)

    @classmethod
    def lookup_entry_vec(cls, x, y):
        return (_u(x) == _u(y)).astype(np.uint64)


class BneInstruction(BeqInstruction):
    name = "bne"

    def combine_lookups(self, vals, C, M):
        return 1 - _prod(vals)

    @classmethod
    def lookup_entry_vec(cls, x, y):
        return (_u(x) != _u(y)).astype(np.uint64)


class SltuInstruction(JoltInstruction):
    name = "sltu"

    def combine_lookups(self, vals, C, M):
        sliced = self.slice_values(vals, C, M)
        ltu, eq = sliced[0], sliced[1]
        total = None
        eq_prod = None
        for i in range(C - 1):
            term = ltu[i] if eq_prod is None else ltu[i] * eq_prod
            total = term if total is None else total + term
            eq_prod = eq[i] if eq_prod is None else eq_prod * eq[i]
        return total + ltu[C - 1] * eq_prod

    def g_poly_degree(self, C):
        return C

    def subtables(self, C, M):
        return [(LtuSubtable(), SubtableIndices(range(C))),
                (EqSubtable(), SubtableIndices(range(C - 1)))]

    @classmethod
    def to_indices_vec(cls, x, y, C, log_M):
        return chunk_and_concatenate_operands_vec(x, y, C, log_M)

    @classmethod
    def lookup_entry_vec(cls, x, y):
        return (_u(x) < _u(y)).astype(np.uint64)


class BgeuInstruction(SltuInstruction):
    name = "bgeu"

    def combine_lookups(self, vals, C, M):
        return 1 - SltuInstruction.combine_lookups(self, vals, C, M)

    @classmethod
    def lookup_entry_vec(cls, x, y):
        return (_u(x) >= _u(y)).astype(np.uint64)


class SltInstruction(JoltInstruction):
    name = "slt"

    def combine_lookups(self, vals, C, M):
        s = self.slice_values(vals, C, M)
        left_msb, right_msb, ltu, eq, lt_abs, eq_abs = s
        ltu_sum = lt_abs[0]
        eq_prod = eq_abs[0]
        for i in range(C - 2):
            ltu_sum = ltu_sum + ltu[i] * eq_prod
            eq_prod = eq_prod * eq[i]
        ltu_sum = ltu_sum + ltu[C - 2] * eq_prod
        lm, rm = left_msb[0], right_msb[0]
        return lm * (1 - rm) + (lm * rm + (1 - lm) * (1 - rm)) * ltu_sum

    def g_poly_degree(self, C):
        return C + 1

    def subtables(self, C, M):
        return [(LeftMSBSubtable(), SubtableIndices.single(0)),
                (RightMSBSubtable(), SubtableIndices.single(0)),
                (LtuSubtable(), SubtableIndices(range(1, C))),
                (EqSubtable(), SubtableIndices(range(1, C - 1))),
                (LtAbsSubtable(), SubtableIndices.single(0)),
                (EqAbsSubtable(), SubtableIndices.single(0))]

    @classmethod
    def to_indices_vec(cls, x, y, C, log_M):
        return chunk_and_concatenate_operands_vec(x, y, C, log_M)

    @classmethod
    def lookup_entry_vec(cls, x, y):
        return (_u(x).astype(np.uint32).astype(np.int32)
                < _u(y).astype(np.uint32).astype(np.int32)).astype(np.uint64)


class BgeInstruction(SltInstruction):
    name = "bge"

    def combine_lookups(self, vals, C, M):
        return 1 - SltInstruction.combine_lookups(self, vals, C, M)

    @classmethod
    def lookup_entry_vec(cls, x, y):
        return (_u(x).astype(np.uint32).astype(np.int32)
                >= _u(y).astype(np.uint32).astype(np.int32)).astype(np.uint64)


# ---------------------------------------------------------------------------
# loads / stores (operand = loaded value / rs2 value in self.x)
# ---------------------------------------------------------------------------

class LbInstruction(JoltInstruction):
    name = "lb"

    def combine_lookups(self, vals, C, M):
        byte, sign = vals[0], vals[1]
        result = byte
        for i in range(1, C):
            result = result + sign * (1 << (8 * i))
        return result

    def g_poly_degree(self, C):
        return 1

    def subtables(self, C, M):
        assert M >= 1 << 8
        return [(TruncateOverflowSubtable(8), SubtableIndices.single(C - 1)),
                (SignExtendSubtable(8), SubtableIndices.single(C - 1)),
                (IdentitySubtable(), SubtableIndices(range(C - 1)))]

    @classmethod
    def to_indices_vec(cls, x, y, C, log_M):
        return chunk_operand_vec(x, C, log_M)

    @classmethod
    def lookup_entry_vec(cls, x, y):
        b = (_u(x) & np.uint64(0xFF)).astype(np.uint8).astype(np.int8)
        return b.astype(np.int32).astype(np.uint32).astype(np.uint64)


class LhInstruction(JoltInstruction):
    name = "lh"

    def combine_lookups(self, vals, C, M):
        assert M == 1 << 16
        half, sign = vals[0], vals[1]
        result = half
        for i in range(1, C // 2):
            result = result + sign * (1 << (16 * i))
        return result

    def g_poly_degree(self, C):
        return 1

    def subtables(self, C, M):
        assert M == 1 << 16
        return [(IdentitySubtable(), SubtableIndices.single(C - 1)),
                (SignExtendSubtable(16), SubtableIndices.single(C - 1)),
                (IdentitySubtable(), SubtableIndices(range(C - 1)))]

    @classmethod
    def to_indices_vec(cls, x, y, C, log_M):
        return chunk_operand_vec(x, C, log_M)

    @classmethod
    def lookup_entry_vec(cls, x, y):
        h = (_u(x) & np.uint64(0xFFFF)).astype(np.uint16).astype(np.int16)
        return h.astype(np.int32).astype(np.uint32).astype(np.uint64)


class SbInstruction(JoltInstruction):
    name = "sb"

    def combine_lookups(self, vals, C, M):
        return vals[0]

    def g_poly_degree(self, C):
        return 1

    def subtables(self, C, M):
        assert M >= 1 << 8
        return [(TruncateOverflowSubtable(8), SubtableIndices.single(C - 1)),
                (IdentitySubtable(), SubtableIndices(range(C - 1)))]

    @classmethod
    def to_indices_vec(cls, x, y, C, log_M):
        return chunk_operand_vec(x, C, log_M)

    @classmethod
    def lookup_entry_vec(cls, x, y):
        return _u(x) & np.uint64(0xFF)


class ShInstruction(JoltInstruction):
    name = "sh"

    def combine_lookups(self, vals, C, M):
        assert M == 1 << 16
        return vals[0]

    def g_poly_degree(self, C):
        return 1

    def subtables(self, C, M):
        assert M == 1 << 16
        return [(IdentitySubtable(), SubtableIndices.single(C - 1)),
                (IdentitySubtable(), SubtableIndices(range(C - 1)))]

    @classmethod
    def to_indices_vec(cls, x, y, C, log_M):
        return chunk_operand_vec(x, C, log_M)

    @classmethod
    def lookup_entry_vec(cls, x, y):
        return _u(x) & np.uint64(0xFFFF)


class SwInstruction(JoltInstruction):
    name = "sw"

    def combine_lookups(self, vals, C, M):
        assert M == 1 << 16
        return vals[0] * M + vals[1]

    def g_poly_degree(self, C):
        return 1

    def subtables(self, C, M):
        assert M == 1 << 16
        return [(IdentitySubtable(), SubtableIndices(range(C - 2, C)))]

    @classmethod
    def to_indices_vec(cls, x, y, C, log_M):
        return chunk_operand_vec(x, C, log_M)

    @classmethod
    def lookup_entry_vec(cls, x, y):
        return _u(x) & _U32


# ---------------------------------------------------------------------------
# shifts
# ---------------------------------------------------------------------------

class SllInstruction(JoltInstruction):
    name = "sll"

    def combine_lookups(self, vals, C, M):
        return concatenate_lookups(vals, C, _log_m(M) // 2)

    def g_poly_degree(self, C):
        return 1

    def subtables(self, C, M):
        # chunk i (most significant first) uses SllSubtable<CHUNK_INDEX=C-1-i>
        return [(SllSubtable(C - 1 - i, WS), SubtableIndices.single(i))
                for i in range(C)]

    @classmethod
    def to_indices_vec(cls, x, y, C, log_M):
        return chunk_and_concatenate_for_shift_vec(x, y, C, log_M)

    @classmethod
    def lookup_entry_vec(cls, x, y):
        sh = _u(y) % np.uint64(WS)
        return (_u(x) << sh) & _U32


class SrlInstruction(JoltInstruction):
    name = "srl"

    def combine_lookups(self, vals, C, M):
        return _sum(vals)

    def g_poly_degree(self, C):
        return 1

    def subtables(self, C, M):
        return [(SrlSubtable(C - 1 - i, WS), SubtableIndices.single(i))
                for i in range(C)]

    @classmethod
    def to_indices_vec(cls, x, y, C, log_M):
        return chunk_and_concatenate_for_shift_vec(x, y, C, log_M)

    @classmethod
    def lookup_entry_vec(cls, x, y):
        return (_u(x) & _U32) >> (_u(y) % np.uint64(WS))


class SraInstruction(JoltInstruction):
    name = "sra"

    def combine_lookups(self, vals, C, M):
        return _sum(vals)

    def g_poly_degree(self, C):
        return 1

    def subtables(self, C, M):
        subs = [(SrlSubtable(C - 1 - i, WS), SubtableIndices.single(i))
                for i in range(C)]
        subs.append((SraSignSubtable(WS), SubtableIndices.single(0)))
        return subs

    @classmethod
    def to_indices_vec(cls, x, y, C, log_M):
        return chunk_and_concatenate_for_shift_vec(x, y, C, log_M)

    @classmethod
    def lookup_entry_vec(cls, x, y):
        xv = _u(x).astype(np.uint32).astype(np.int32)
        sh = (_u(y) % np.uint64(WS)).astype(np.int32)
        return (xv >> sh).astype(np.uint32).astype(np.uint64)


# ---------------------------------------------------------------------------
# virtual instructions (M-extension sequences)
# ---------------------------------------------------------------------------

class VirtualMoveInstruction(JoltInstruction):
    name = "virtual_move"

    def combine_lookups(self, vals, C, M):
        return concatenate_lookups(vals, C, _log_m(M))

    def g_poly_degree(self, C):
        return 1

    def subtables(self, C, M):
        assert M == 1 << 16
        return [(IdentitySubtable(), SubtableIndices(range(C)))]

    @classmethod
    def to_indices_vec(cls, x, y, C, log_M):
        return chunk_operand_vec(x, C, log_M)

    @classmethod
    def lookup_entry_vec(cls, x, y):
        return _u(x)


class VirtualAdviceInstruction(_TruncIdentityCombine):
    name = "virtual_advice"

    @classmethod
    def to_indices_vec(cls, x, y, C, log_M):
        return chunk_operand_vec(x, C, log_M)

    @classmethod
    def lookup_entry_vec(cls, x, y):
        return _u(x)


class VirtualMovsignInstruction(JoltInstruction):
    name = "virtual_movsign"

    def combine_lookups(self, vals, C, M):
        assert M == 1 << 16
        val = vals[0]
        repeat = WS // 16
        return concatenate_lookups([val] * repeat, repeat, _log_m(M))

    def g_poly_degree(self, C):
        return 1

    def subtables(self, C, M):
        assert M == 1 << 16
        msb_chunk_index = C - (WS // 16)
        return [(SignExtendSubtable(16), SubtableIndices.single(msb_chunk_index)),
                (IdentitySubtable(), SubtableIndices(range(C)))]

    @classmethod
    def to_indices_vec(cls, x, y, C, log_M):
        return chunk_operand_vec(x, C, log_M)

    @classmethod
    def lookup_entry_vec(cls, x, y):
        return np.where((_u(x) & np.uint64(1 << 31)) != 0,
                        np.uint64(0xFFFFFFFF), np.uint64(0))


class VirtualAssertLteInstruction(JoltInstruction):
    name = "virtual_assert_lte"

    def combine_lookups(self, vals, C, M):
        s = self.slice_values(vals, C, M)
        ltu, eq = s
        total = None
        eq_prod = None
        for i in range(C):
            term = ltu[i] if eq_prod is None else ltu[i] * eq_prod
            total = term if total is None else total + term
            eq_prod = eq[i] if eq_prod is None else eq_prod * eq[i]
        return total + eq_prod

    def g_poly_degree(self, C):
        return C

    def subtables(self, C, M):
        return [(LtuSubtable(), SubtableIndices(range(C))),
                (EqSubtable(), SubtableIndices(range(C)))]

    @classmethod
    def to_indices_vec(cls, x, y, C, log_M):
        return chunk_and_concatenate_operands_vec(x, y, C, log_M)

    @classmethod
    def lookup_entry_vec(cls, x, y):
        return (_u(x) <= _u(y)).astype(np.uint64)


class VirtualAssertValidDiv0Instruction(JoltInstruction):
    name = "virtual_assert_valid_div0"

    def combine_lookups(self, vals, C, M):
        s = self.slice_values(vals, C, M)
        divisor_is_zero = _prod(s[0])
        is_valid = _prod(s[1])
        return 1 - divisor_is_zero + is_valid

    def g_poly_degree(self, C):
        return C

    def subtables(self, C, M):
        return [(LeftIsZeroSubtable(), SubtableIndices(range(C))),
                (DivByZeroSubtable(), SubtableIndices(range(C)))]

    @classmethod
    def to_indices_vec(cls, x, y, C, log_M):
        return chunk_and_concatenate_operands_vec(x, y, C, log_M)

    @classmethod
    def lookup_entry_vec(cls, x, y):
        return np.where(_u(x) == 0, (_u(y) == _U32).astype(np.uint64),
                        np.uint64(1))


class VirtualAssertValidUnsignedRemainderInstruction(JoltInstruction):
    name = "virtual_assert_valid_unsigned_remainder"

    def combine_lookups(self, vals, C, M):
        s = self.slice_values(vals, C, M)
        ltu, eq, rzero = s
        divisor_is_zero = _prod(rzero)
        total = None
        eq_prod = None
        for i in range(C):
            term = ltu[i] if eq_prod is None else ltu[i] * eq_prod
            total = term if total is None else total + term
            eq_prod = eq[i] if eq_prod is None else eq_prod * eq[i]
        return total + divisor_is_zero

    def g_poly_degree(self, C):
        return C

    def subtables(self, C, M):
        return [(LtuSubtable(), SubtableIndices(range(C))),
                (EqSubtable(), SubtableIndices(range(C))),
                (RightIsZeroSubtable(), SubtableIndices(range(C)))]

    @classmethod
    def to_indices_vec(cls, x, y, C, log_M):
        return chunk_and_concatenate_operands_vec(x, y, C, log_M)

    @classmethod
    def lookup_entry_vec(cls, x, y):
        return ((_u(y) == 0) | (_u(x) < _u(y))).astype(np.uint64)


class VirtualAssertValidSignedRemainderInstruction(JoltInstruction):
    name = "virtual_assert_valid_signed_remainder"

    def combine_lookups(self, vals, C, M):
        s = self.slice_values(vals, C, M)
        left_msb, right_msb, eq, ltu, eq_abs, lt_abs, lzero, rzero = s
        remainder_is_zero = _prod(lzero)
        divisor_is_zero = _prod(rzero)
        ltu_sum = lt_abs[0]
        eq_prod = eq_abs[0]
        for ltu_i, eq_i in zip(ltu, eq):
            ltu_sum = ltu_sum + ltu_i * eq_prod
            eq_prod = eq_prod * eq_i
        lm, rm = left_msb[0], right_msb[0]
        return ((1 - lm - rm) * ltu_sum
                + lm * rm * (1 - eq_prod)
                + (1 - lm) * rm * remainder_is_zero
                + divisor_is_zero)

    def g_poly_degree(self, C):
        return C + 2

    def subtables(self, C, M):
        return [(LeftMSBSubtable(), SubtableIndices.single(0)),
                (RightMSBSubtable(), SubtableIndices.single(0)),
                (EqSubtable(), SubtableIndices(range(1, C))),
                (LtuSubtable(), SubtableIndices(range(1, C))),
                (EqAbsSubtable(), SubtableIndices.single(0)),
                (LtAbsSubtable(), SubtableIndices.single(0)),
                (LeftIsZeroSubtable(), SubtableIndices(range(C))),
                (RightIsZeroSubtable(), SubtableIndices(range(C)))]

    @classmethod
    def to_indices_vec(cls, x, y, C, log_M):
        return chunk_and_concatenate_operands_vec(x, y, C, log_M)

    @classmethod
    def lookup_entry_vec(cls, x, y):
        xs = _u(x).astype(np.uint32).astype(np.int32).astype(np.int64)
        ys = _u(y).astype(np.uint32).astype(np.int32).astype(np.int64)
        trivial = (xs == 0) | (ys == 0)
        ok = (np.abs(xs) < np.abs(ys)) & ((xs < 0) == (ys < 0))
        return np.where(trivial, np.uint64(1), ok.astype(np.uint64))


# canonical RV32I instruction order (rv32i_vm.rs:107-138)
RV32I_INSTRUCTIONS = [
    AddInstruction, SubInstruction, AndInstruction, OrInstruction,
    XorInstruction, LbInstruction, LhInstruction, SbInstruction,
    ShInstruction, SwInstruction, BeqInstruction, BgeInstruction,
    BgeuInstruction, BneInstruction, SltInstruction, SltuInstruction,
    SllInstruction, SraInstruction, SrlInstruction,
    VirtualMovsignInstruction, MulInstruction, MulUInstruction,
    MulHUInstruction, VirtualAdviceInstruction, VirtualMoveInstruction,
    VirtualAssertLteInstruction,
    VirtualAssertValidSignedRemainderInstruction,
    VirtualAssertValidUnsignedRemainderInstruction,
    VirtualAssertValidDiv0Instruction,
]
