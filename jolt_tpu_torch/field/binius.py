"""Binius binary-field scaffolding (experimental parity stub): a copy of
jolt_tpu/field/binius.py (host code, pure Python).

Reference: jolt-core/src/field/binius.rs — a `BiniusField<BinaryField128b>`
wrapper whose div/inverse are `unimplemented!()` and whose PCS is a
`todo!()` stub (commitment/binius.rs:14-99).  The reference never uses it
in the production path; this module mirrors that inventory slot with a
minimal GF(2^128) tower implementation (add = xor, carryless mul) and the
same unimplemented boundaries.
"""
from __future__ import annotations

from dataclasses import dataclass

# BinaryField128b: GF(2)[x]/(x^128 + x^7 + x^2 + x + 1) (POLYVAL modulus)
_MOD_POLY = (1 << 128) | 0x87
_MASK = (1 << 128) - 1


def _clmul(a: int, b: int) -> int:
    acc = 0
    while b:
        if b & 1:
            acc ^= a
        a <<= 1
        b >>= 1
    return acc


def _reduce(x: int) -> int:
    while x.bit_length() > 128:
        x ^= _MOD_POLY << (x.bit_length() - 129)
    return x


@dataclass(frozen=True)
class BiniusElt:
    """GF(2^128) element; add/sub = xor, mul = carryless mul mod the
    field polynomial.  inverse/div unimplemented, as in the reference."""
    v: int

    def __add__(self, other: "BiniusElt") -> "BiniusElt":
        return BiniusElt(self.v ^ other.v)

    __sub__ = __add__

    def __mul__(self, other: "BiniusElt") -> "BiniusElt":
        return BiniusElt(_reduce(_clmul(self.v, other.v)))

    def square(self) -> "BiniusElt":
        return self * self

    def inverse(self):
        raise NotImplementedError(
            "unimplemented in the reference (field/binius.rs)")

    @staticmethod
    def zero() -> "BiniusElt":
        return BiniusElt(0)

    @staticmethod
    def one() -> "BiniusElt":
        return BiniusElt(1)

    @staticmethod
    def from_u64(x: int) -> "BiniusElt":
        return BiniusElt(x & 0xFFFFFFFFFFFFFFFF)


class BiniusPCS:
    """todo!()-stub PCS (commitment/binius.rs:14-99)."""

    def __init__(self, *a, **kw):
        raise NotImplementedError("todo-stub in the reference")
