"""Generic field-element wrapper for device limb tensors.

Instruction `combine_lookups` collation polynomials and subtable MLEs are
written once over a generic field type: they take either host `FElt`s
(verifier) or `DevF` device tensors (prover sumcheck).  int/FElt operands
are structural constants such as 2^b, uploaded as one limb vector and
broadcast (the Montgomery kernel reads a scalar operand with stride 0).
"""
from __future__ import annotations

import torch

from . import device as fd
from .host import FElt
from .spec import FieldSpec


class DevF:
    """A batch of field elements on a device: limbs int32[16, *shape]."""

    __slots__ = ("limbs", "spec")

    def __init__(self, limbs: torch.Tensor, spec: FieldSpec):
        self.limbs = limbs
        self.spec = spec

    def _coerce(self, other):
        if isinstance(other, DevF):
            return self.limbs, other.limbs
        if isinstance(other, FElt):
            v = other.v
        elif isinstance(other, int):
            v = other % self.spec.p
        else:
            return NotImplemented
        const = fd.scalar_to_device(self.spec, v, self.limbs.device)
        return self.limbs, const.reshape(
            (fd.L,) + (1,) * (self.limbs.dim() - 1))

    def __add__(self, other):
        a, b = self._coerce(other)
        return DevF(fd.fadd(self.spec, a, b), self.spec)

    __radd__ = __add__

    def __sub__(self, other):
        a, b = self._coerce(other)
        return DevF(fd.fsub(self.spec, a, b), self.spec)

    def __rsub__(self, other):
        a, b = self._coerce(other)
        return DevF(fd.fsub(self.spec, b, a), self.spec)

    def __mul__(self, other):
        a, b = self._coerce(other)
        return DevF(fd.fmul(self.spec, a, b), self.spec)

    __rmul__ = __mul__

    def __neg__(self):
        return DevF(fd.fneg(self.spec, self.limbs), self.spec)
