"""RV32I VM instantiation (reference: jolt-core/src/jolt/vm/rv32i_vm.rs,
jolt_tpu/vm/rv32i_vm.py): C = 4 chunks, WORD_SIZE = 32.

The port carries the mini VM: a reduced instruction set over the same
protocol (fibonacci needs ADD and BNE over the TruncateOverflow, Identity
and Eq subtables).  The full 29-instruction `rv32i_vm()` comes with the
instruction and subtable zoo.
"""
from __future__ import annotations

from .jolt import JoltVM

C = 4
M = 1 << 16
WORD_SIZE = 32


def mini_vm(instruction_classes, subtable_order, M_mini: int = M,
            spec=None) -> JoltVM:
    """A reduced-instruction-set VM with C = 4 and M = M_mini."""
    return JoltVM(instruction_classes, subtable_order, C, M_mini, spec=spec)
