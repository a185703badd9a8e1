"""Host-side field elements: arbitrary-precision ints mod p.

The verifier and all transcript/challenge scalar math run on the host over
Python ints.  This doubles as the bit-exactness oracle for the device limb
kernels.
"""
from __future__ import annotations

from typing import Iterable

from .spec import FieldSpec, fq_spec, fr_spec


class FElt:
    """Immutable field element (canonical residue) with operator overloads."""

    __slots__ = ("v", "spec")

    def __init__(self, v: int, spec: FieldSpec):
        object.__setattr__(self, "v", v % spec.p)
        object.__setattr__(self, "spec", spec)

    def __setattr__(self, *_):
        raise AttributeError("FElt is immutable")

    # -- arithmetic --------------------------------------------------------
    def _coerce(self, other) -> int:
        if isinstance(other, FElt):
            assert other.spec == self.spec
            return other.v
        if isinstance(other, int):
            return other % self.spec.p
        return NotImplemented

    def __add__(self, other):
        o = self._coerce(other)
        return FElt(self.v + o, self.spec) if o is not NotImplemented else o

    __radd__ = __add__

    def __sub__(self, other):
        o = self._coerce(other)
        return FElt(self.v - o, self.spec) if o is not NotImplemented else o

    def __rsub__(self, other):
        o = self._coerce(other)
        return FElt(o - self.v, self.spec) if o is not NotImplemented else o

    def __mul__(self, other):
        o = self._coerce(other)
        return FElt(self.v * o, self.spec) if o is not NotImplemented else o

    __rmul__ = __mul__

    def __neg__(self):
        return FElt(-self.v, self.spec)

    def __pow__(self, e: int):
        return FElt(pow(self.v, e, self.spec.p), self.spec)

    def inverse(self) -> "FElt":
        return FElt(pow(self.v, -1, self.spec.p), self.spec)

    def __truediv__(self, other):
        o = self._coerce(other)
        return FElt(self.v * pow(o, -1, self.spec.p), self.spec)

    def square(self) -> "FElt":
        return self * self

    def is_zero(self) -> bool:
        return self.v == 0

    def __eq__(self, other):
        if isinstance(other, FElt):
            return self.v == other.v and self.spec == other.spec
        if isinstance(other, int):
            return self.v == other % self.spec.p
        return NotImplemented

    def __hash__(self):
        return hash((self.v, self.spec.p))

    def __repr__(self):
        return f"{self.spec.name}({self.v})"

    def __int__(self):
        return self.v


def fr(v: int = 0) -> FElt:
    return FElt(v, fr_spec())


def fq(v: int = 0) -> FElt:
    return FElt(v, fq_spec())


def batch_inverse(values: Iterable[FElt]) -> list[FElt]:
    """Montgomery batch-inversion trick: n inversions -> 1 inversion + 3n muls."""
    vals = list(values)
    if not vals:
        return []
    spec = vals[0].spec
    prefix = []
    acc = FElt(1, spec)
    for x in vals:
        prefix.append(acc)
        acc = acc * x
    inv = acc.inverse()
    out = [None] * len(vals)
    for i in range(len(vals) - 1, -1, -1):
        out[i] = inv * prefix[i]
        inv = inv * vals[i]
    return out
