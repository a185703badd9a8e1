"""BN254 G1 host arithmetic (Python ints): the commit path's host tail and
the oracle for the device point kernels.

Curve: y^2 = x^3 + 3 over Fq, generator (1, 2) (EIP-196).  G2 and the
pairing wait for the port of HyperKZG's opening proof.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..field.spec import FQ_MODULUS, FR_MODULUS

Q = FQ_MODULUS
R_ORDER = FR_MODULUS


@dataclass(frozen=True)
class G1Affine:
    x: int
    y: int
    is_infinity: bool = False

    @staticmethod
    def identity() -> "G1Affine":
        return G1Affine(0, 0, True)

    @staticmethod
    def generator() -> "G1Affine":
        return G1Affine(1, 2)

    def is_on_curve(self) -> bool:
        if self.is_infinity:
            return True
        return (self.y * self.y - self.x ** 3 - 3) % Q == 0

    def neg(self) -> "G1Affine":
        if self.is_infinity:
            return self
        return G1Affine(self.x, (-self.y) % Q)

    def to_jacobian(self) -> "G1Jacobian":
        if self.is_infinity:
            return G1Jacobian(1, 1, 0)
        return G1Jacobian(self.x, self.y, 1)

    def __eq__(self, other):
        if self.is_infinity or other.is_infinity:
            return self.is_infinity == other.is_infinity
        return self.x == other.x and self.y == other.y


@dataclass(frozen=True)
class G1Jacobian:
    x: int
    y: int
    z: int

    def is_infinity(self) -> bool:
        return self.z == 0

    @staticmethod
    def identity() -> "G1Jacobian":
        return G1Jacobian(1, 1, 0)

    def to_affine(self) -> G1Affine:
        if self.z == 0:
            return G1Affine.identity()
        zinv = pow(self.z, -1, Q)
        zinv2 = zinv * zinv % Q
        return G1Affine(self.x * zinv2 % Q, self.y * zinv2 * zinv % Q)

    def double(self) -> "G1Jacobian":
        if self.z == 0:
            return self
        X, Y, Z = self.x, self.y, self.z
        A = X * X % Q
        B = Y * Y % Q
        C = B * B % Q
        D = 2 * ((X + B) * (X + B) - A - C) % Q
        E = 3 * A % Q
        F = E * E % Q
        X3 = (F - 2 * D) % Q
        Y3 = (E * (D - X3) - 8 * C) % Q
        Z3 = 2 * Y * Z % Q
        return G1Jacobian(X3, Y3, Z3)

    def add(self, other: "G1Jacobian") -> "G1Jacobian":
        if self.z == 0:
            return other
        if other.z == 0:
            return self
        Z1Z1 = self.z * self.z % Q
        Z2Z2 = other.z * other.z % Q
        U1 = self.x * Z2Z2 % Q
        U2 = other.x * Z1Z1 % Q
        S1 = self.y * other.z * Z2Z2 % Q
        S2 = other.y * self.z * Z1Z1 % Q
        if U1 == U2:
            if S1 != S2:
                return G1Jacobian.identity()
            return self.double()
        H = (U2 - U1) % Q
        Rr = (S2 - S1) % Q
        H2 = H * H % Q
        H3 = H * H2 % Q
        V = U1 * H2 % Q
        X3 = (Rr * Rr - H3 - 2 * V) % Q
        Y3 = (Rr * (V - X3) - S1 * H3) % Q
        Z3 = self.z * other.z * H % Q
        return G1Jacobian(X3, Y3, Z3)

    def mul(self, k: int) -> "G1Jacobian":
        k %= R_ORDER
        acc = G1Jacobian.identity()
        base = self
        while k:
            if k & 1:
                acc = acc.add(base)
            base = base.double()
            k >>= 1
        return acc
