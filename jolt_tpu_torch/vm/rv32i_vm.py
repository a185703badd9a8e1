"""RV32I VM instantiation (reference: jolt-core/src/jolt/vm/rv32i_vm.rs,
jolt_tpu/vm/rv32i_vm.py): C = 4 chunks, M = 2^16 subtable entries,
WORD_SIZE = 32; the canonical 29-instruction set and 26-subtable enum
order.  `mini_vm` builds a reduced instruction set over the same protocol
(fibonacci needs ADD and BNE over the TruncateOverflow, Identity and Eq
subtables).
"""
from __future__ import annotations

from ..instructions.rv32i import RV32I_INSTRUCTIONS
from ..subtables.bitwise import AndSubtable, OrSubtable, XorSubtable
from ..subtables.rv32i import (DivByZeroSubtable, EqAbsSubtable, EqSubtable,
                               IdentitySubtable, LeftIsZeroSubtable,
                               LeftMSBSubtable, LtAbsSubtable, LtuSubtable,
                               RightIsZeroSubtable, RightMSBSubtable,
                               SignExtendSubtable, SllSubtable,
                               SraSignSubtable, SrlSubtable,
                               TruncateOverflowSubtable)
from .jolt import JoltVM

C = 4
M = 1 << 16
WORD_SIZE = 32

# rv32i_vm.rs:139-167 subtable_enum! order
RV32I_SUBTABLES = [
    AndSubtable(), EqAbsSubtable(), EqSubtable(), LeftMSBSubtable(),
    RightMSBSubtable(), IdentitySubtable(), LtAbsSubtable(), LtuSubtable(),
    OrSubtable(), SignExtendSubtable(8), SignExtendSubtable(16),
    SllSubtable(0, WORD_SIZE), SllSubtable(1, WORD_SIZE),
    SllSubtable(2, WORD_SIZE), SllSubtable(3, WORD_SIZE),
    SraSignSubtable(WORD_SIZE), SrlSubtable(0, WORD_SIZE),
    SrlSubtable(1, WORD_SIZE), SrlSubtable(2, WORD_SIZE),
    SrlSubtable(3, WORD_SIZE), TruncateOverflowSubtable(WORD_SIZE),
    TruncateOverflowSubtable(8), XorSubtable(), LeftIsZeroSubtable(),
    RightIsZeroSubtable(), DivByZeroSubtable(),
]


def rv32i_vm(spec=None) -> JoltVM:
    """The full RV32I Jolt VM (its device is chosen at preprocessing)."""
    return JoltVM(RV32I_INSTRUCTIONS, RV32I_SUBTABLES, C, M, spec=spec)


def mini_vm(instruction_classes, subtable_order, M_mini: int = M,
            spec=None) -> JoltVM:
    """A reduced-instruction-set VM with C = 4 and M = M_mini."""
    return JoltVM(instruction_classes, subtable_order, C, M_mini, spec=spec)
