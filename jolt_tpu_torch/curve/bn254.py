"""BN254 G1/G2 host arithmetic (Python ints): the commit path's host tail,
the verifier's MSMs and pairing inputs, and the oracle for the device
point kernels.

Curve: y^2 = x^3 + 3 over Fq, generator (1, 2) (EIP-196); G2: y^2 = x^3 +
3/(9+u) over Fq2 (EIP-197).
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


def g1_msm_host(points: list[G1Affine], scalars: list[int]) -> G1Affine:
    """Reference MSM (slow; oracle for the device Pippenger)."""
    acc = G1Jacobian.identity()
    for p, s in zip(points, scalars):
        if not p.is_infinity and s % R_ORDER:
            acc = acc.add(p.to_jacobian().mul(s))
    return acc.to_affine()


def g1_msm_buckets(points: list[G1Affine], scalars: list[int]) -> G1Affine:
    """sum_i s_i * P_i on the host by the bucket method: c-bit windows,
    top first; each window's points go to the bucket of their digit, and a
    running sum over the buckets weights bucket d by d.  About
    (N + 2^(c+1)) adds per window against N * (bits + bits / 2) for
    g1_msm_host: six times fewer at N = 1,024 (the verifiers' MSMs)."""
    terms = [(p.to_jacobian(), s % R_ORDER) for p, s in zip(points, scalars)
             if not p.is_infinity and s % R_ORDER]
    if not terms:
        return G1Affine.identity()
    c = max(2, len(terms).bit_length() - 3)
    mask = (1 << c) - 1
    bits = max(s for _, s in terms).bit_length()
    acc = G1Jacobian.identity()
    for w in reversed(range(-(-bits // c))):
        for _ in range(c):
            acc = acc.double()
        buckets = [G1Jacobian.identity()] * (mask + 1)
        for p, s in terms:
            d = (s >> (w * c)) & mask
            if d:
                buckets[d] = buckets[d].add(p)
        run = total = G1Jacobian.identity()
        for d in range(mask, 0, -1):
            run = run.add(buckets[d])
            total = total.add(run)
        acc = acc.add(total)
    return acc.to_affine()


# --- G2 over Fq2 = Fq[u]/(u^2+1) --------------------------------------------

def fq2_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    return ((a0 * b0 - a1 * b1) % Q, (a0 * b1 + a1 * b0) % Q)


def fq2_add(a, b):
    return ((a[0] + b[0]) % Q, (a[1] + b[1]) % Q)


def fq2_sub(a, b):
    return ((a[0] - b[0]) % Q, (a[1] - b[1]) % Q)


def fq2_scalar(a, k):
    return (a[0] * k % Q, a[1] * k % Q)


def fq2_square(a):
    return fq2_mul(a, a)


def fq2_inv(a):
    a0, a1 = a
    norm_inv = pow((a0 * a0 + a1 * a1) % Q, -1, Q)
    return (a0 * norm_inv % Q, (-a1 * norm_inv) % Q)


def fq2_neg(a):
    return ((-a[0]) % Q, (-a[1]) % Q)


# standard BN254 G2 generator (EIP-197 ordering: c1*u + c0 given as (c0, c1))
G2_GENERATOR_X = (
    10857046999023057135944570762232829481370756359578518086990519993285655852781,
    11559732032986387107991004021392285783925812861821192530917403151452391805634,
)
G2_GENERATOR_Y = (
    8495653923123431417604973247489272438418190587263600148770280649306958101930,
    4082367875863433681332203403145435568316851327593401208105741076214120093531,
)


@dataclass(frozen=True)
class G2Affine:
    x: tuple[int, int]
    y: tuple[int, int]
    is_infinity: bool = False

    @staticmethod
    def identity() -> "G2Affine":
        return G2Affine((0, 0), (0, 0), True)

    @staticmethod
    def generator() -> "G2Affine":
        return G2Affine(G2_GENERATOR_X, G2_GENERATOR_Y)

    def neg(self) -> "G2Affine":
        if self.is_infinity:
            return self
        return G2Affine(self.x, fq2_neg(self.y))

    def is_on_curve(self) -> bool:
        if self.is_infinity:
            return True
        # b' = 3 / (9 + u)
        b = fq2_mul((3, 0), fq2_inv((9, 1)))
        lhs = fq2_square(self.y)
        rhs = fq2_add(fq2_mul(fq2_square(self.x), self.x), b)
        return lhs == rhs

    def add(self, other: "G2Affine") -> "G2Affine":
        if self.is_infinity:
            return other
        if other.is_infinity:
            return self
        if self.x == other.x:
            if self.y != other.y:
                return G2Affine.identity()
            # double
            lam = fq2_mul(fq2_scalar(fq2_square(self.x), 3),
                          fq2_inv(fq2_scalar(self.y, 2)))
        else:
            lam = fq2_mul(fq2_sub(other.y, self.y),
                          fq2_inv(fq2_sub(other.x, self.x)))
        x3 = fq2_sub(fq2_sub(fq2_square(lam), self.x), other.x)
        y3 = fq2_sub(fq2_mul(lam, fq2_sub(self.x, x3)), self.y)
        return G2Affine(x3, y3)

    def mul(self, k: int) -> "G2Affine":
        k %= R_ORDER
        acc = G2Affine.identity()
        base = self
        while k:
            if k & 1:
                acc = acc.add(base)
            base = base.add(base)
            k >>= 1
        return acc
