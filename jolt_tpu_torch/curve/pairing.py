"""Optimal ate pairing on BN254 (host ints) — KZG pairing checks.

Implements the Fq12 tower as Fq[w]/(w^12 - 18w^6 + 82) with the standard
D-type twist embedding, the 63-bit ate Miller loop with the two Frobenius
correction steps, and final exponentiation by (q^12 - 1) / r.  Host-only:
each HyperKZG verification performs one product of pairings, so a plain
square-and-multiply final exponentiation is adequate.
"""
from __future__ import annotations

from ..field.spec import FQ_MODULUS as Q, FR_MODULUS as R_ORDER
from .bn254 import G1Affine, G2Affine

ATE_LOOP_COUNT = 29793968203157093288
LOG_ATE_LOOP_COUNT = 63

# w^12 = 18 w^6 - 82
_FQ12_MOD = [82, 0, 0, 0, 0, 0, -18, 0, 0, 0, 0, 0]


class FQ12:
    __slots__ = ("c",)

    def __init__(self, coeffs):
        self.c = [x % Q for x in coeffs]
        assert len(self.c) == 12

    @staticmethod
    def one():
        return FQ12([1] + [0] * 11)

    @staticmethod
    def zero():
        return FQ12([0] * 12)

    def __add__(self, o):
        return FQ12([a + b for a, b in zip(self.c, o.c)])

    def __sub__(self, o):
        return FQ12([a - b for a, b in zip(self.c, o.c)])

    def __mul__(self, o):
        if isinstance(o, int):
            return FQ12([a * o for a in self.c])
        t = [0] * 23
        for i, a in enumerate(self.c):
            if a:
                for j, b in enumerate(o.c):
                    t[i + j] += a * b
        for k in range(22, 11, -1):
            v = t[k] % Q
            if v:
                t[k - 6] += v * 18
                t[k - 12] -= v * 82
        return FQ12(t[:12])

    __rmul__ = __mul__

    def square(self):
        return self * self

    def inv(self):
        # extended Euclid over Fq[w] against the tower modulus
        lm, hm = [1] + [0] * 12, [0] * 13
        low = self.c + [0]
        high = _FQ12_MOD + [1]

        def deg(p):
            for i in range(len(p) - 1, -1, -1):
                if p[i] % Q:
                    return i
            return 0

        def poly_rounded_div(a, b):
            dega, degb = deg(a), deg(b)
            temp = [x for x in a]
            out = [0] * len(a)
            binv = pow(b[degb] % Q, -1, Q)
            for i in range(dega - degb, -1, -1):
                out[i] = (out[i] + temp[degb + i] * binv) % Q
                for c in range(degb + 1):
                    temp[c + i] = (temp[c + i] - out[i] * b[c]) % Q
            return [x % Q for x in out[: deg(out) + 1]]

        while deg(low):
            r = poly_rounded_div(high, low)
            r += [0] * (13 - len(r))
            nm = [x for x in hm]
            new = [x for x in high]
            for i in range(13):
                for j in range(13 - i):
                    nm[i + j] -= lm[i] * r[j]
                    new[i + j] -= low[i] * r[j]
            nm = [x % Q for x in nm]
            new = [x % Q for x in new]
            lm, low, hm, high = nm, new, lm, low
        inv_low0 = pow(low[0] % Q, -1, Q)
        return FQ12([(x * inv_low0) % Q for x in lm[:12]])

    def __pow__(self, e: int):
        result = FQ12.one()
        base = self
        while e:
            if e & 1:
                result = result * base
            base = base.square()
            e >>= 1
        return result

    def __eq__(self, o):
        return all((a - b) % Q == 0 for a, b in zip(self.c, o.c))

    def is_one(self):
        return self == FQ12.one()


def _twist(pt: G2Affine):
    """Embed a G2 point into the Fq12 curve (D-twist untwisting)."""
    if pt.is_infinity:
        return None
    x0, x1 = pt.x
    y0, y1 = pt.y
    # coefficients in the (w^6 = 9 + u)-aligned basis
    xc = [(x0 - 9 * x1) % Q, x1]
    yc = [(y0 - 9 * y1) % Q, y1]
    nx = FQ12([xc[0]] + [0] * 5 + [xc[1]] + [0] * 5)
    ny = FQ12([yc[0]] + [0] * 5 + [yc[1]] + [0] * 5)
    w2 = FQ12([0, 0, 1] + [0] * 9)
    w3 = FQ12([0, 0, 0, 1] + [0] * 8)
    return (nx * w2, ny * w3)


def _cast_g1(pt: G1Affine):
    return (FQ12([pt.x] + [0] * 11), FQ12([pt.y] + [0] * 11))


def _linefunc(p1, p2, t):
    """Evaluate the line through p1, p2 at t (all on the Fq12 curve)."""
    x1, y1 = p1
    x2, y2 = p2
    xt, yt = t
    if not (x1 == x2):
        m = (y2 - y1) * (x2 - x1).inv()
        return m * (xt - x1) - (yt - y1)
    if y1 == y2:
        m = 3 * (x1 * x1) * (2 * y1).inv()
        return m * (xt - x1) - (yt - y1)
    return xt - x1


def _add_pts(p1, p2):
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2 and y1 == y2:
        m = 3 * (x1 * x1) * (2 * y1).inv()
    else:
        m = (y2 - y1) * (x2 - x1).inv()
    x3 = m * m - x1 - x2
    y3 = m * (x1 - x3) - y1
    return (x3, y3)


def _frobenius_pt(pt):
    """(x, y) -> (x^q, y^q) on the Fq12 curve."""
    x, y = pt
    return (x ** Q, y ** Q)


def miller_loop(p: G1Affine, q: G2Affine) -> FQ12:
    """Miller loop of the optimal ate pairing (no final exponentiation)."""
    if p.is_infinity or q.is_infinity:
        return FQ12.one()
    tq = _twist(q)
    tp = _cast_g1(p)
    r = tq
    f = FQ12.one()
    for i in range(LOG_ATE_LOOP_COUNT, -1, -1):
        f = f * f * _linefunc(r, r, tp)
        r = _add_pts(r, r)
        if ATE_LOOP_COUNT & (1 << i):
            f = f * _linefunc(r, tq, tp)
            r = _add_pts(r, tq)
    q1 = _frobenius_pt(tq)
    nq2 = _frobenius_pt(q1)
    nq2 = (nq2[0], FQ12.zero() - nq2[1])
    f = f * _linefunc(r, q1, tp)
    r = _add_pts(r, q1)
    f = f * _linefunc(r, nq2, tp)
    return f


def final_exponentiation(f: FQ12) -> FQ12:
    return f ** ((Q ** 12 - 1) // R_ORDER)


def pairing(p: G1Affine, q: G2Affine) -> FQ12:
    return final_exponentiation(miller_loop(p, q))


def pairing_product_is_one(pairs) -> bool:
    """Check prod e(P_i, Q_i) == 1 with a single final exponentiation."""
    f = FQ12.one()
    for p, q in pairs:
        f = f * miller_loop(p, q)
    return final_exponentiation(f).is_one()
