"""arkworks-compatible (ark-serialize "compressed") byte encodings
(jolt_tpu/utils/ark_serialize.py).

The reference persists proofs and the SRS with ark-serialize's
CanonicalSerialize (common/src/serializable.rs; kzg.rs:22-84 SRS):

- Fr / Fq: 32 bytes, little-endian canonical integer (no flags).
- G1Affine compressed: 32 bytes = x (LE), flags in the two top bits of the
  last byte: 0x40 = point at infinity (x serialized as 0), 0x80 =
  "negative" y (SWFlags: y is negative iff y > -y as integers).
- G1Affine uncompressed: 64 bytes = x || y (LE), infinity flag on byte 63.
- G2Affine compressed: 64 bytes = x.c0 || x.c1 (LE), flags in the last
  byte; the y-sign compares Fq2 elements lexicographically (c1, then c0).
- Vec<T>: u64 LE length prefix, then elements.

Decompression solves y^2 = x^3 + 3 (q = 3 mod 4, so y = rhs^((q+1)/4));
for G2, the square root in Fq2 = Fq[u]/(u^2+1) goes by the norm.  All host
ints; bytes that do not decode to a canonical element or a curve point
raise ValueError.
"""
from __future__ import annotations

import struct

from ..curve.bn254 import (Q, G1Affine, G2Affine, fq2_add, fq2_inv, fq2_mul,
                           fq2_square)
from ..field.spec import FR_MODULUS

_INF_FLAG = 0x40
_NEG_FLAG = 0x80


def _check_len(b: bytes, n: int, what: str) -> None:
    if len(b) != n:
        raise ValueError(f"{what}: expected {n} bytes, got {len(b)}")


def fr_to_bytes(v: int) -> bytes:
    return (v % FR_MODULUS).to_bytes(32, "little")


def fr_from_bytes(b: bytes) -> int:
    _check_len(b, 32, "Fr")
    v = int.from_bytes(b, "little")
    if v >= FR_MODULUS:
        raise ValueError("non-canonical Fr encoding")
    return v


def _fq_is_negative(y: int) -> bool:
    """SWFlags convention: y is negative iff y > -y (canonical ints)."""
    return y > Q - y


def g1_to_compressed(p: G1Affine) -> bytes:
    if p.is_infinity:
        b = bytearray(32)
        b[31] |= _INF_FLAG
        return bytes(b)
    b = bytearray(p.x.to_bytes(32, "little"))
    if _fq_is_negative(p.y):
        b[31] |= _NEG_FLAG
    return bytes(b)


def _fq_sqrt(a: int) -> int:
    """Square root in Fq (q = 3 mod 4); raises if a is not a square."""
    r = pow(a, (Q + 1) // 4, Q)
    if r * r % Q != a % Q:
        raise ValueError("not a quadratic residue in Fq")
    return r


def _on_curve(p):
    if not p.is_on_curve():
        raise ValueError("decoded point is not on the curve")
    return p


def g1_from_compressed(b: bytes) -> G1Affine:
    _check_len(b, 32, "G1 compressed")
    flags = b[31] & 0xC0
    x = int.from_bytes(b[:31] + bytes([b[31] & 0x3F]), "little")
    if flags & _INF_FLAG:
        if x:
            raise ValueError("G1 infinity with nonzero x")
        return G1Affine.identity()
    y = _fq_sqrt((x * x % Q * x + 3) % Q)
    if bool(flags & _NEG_FLAG) != _fq_is_negative(y):
        y = Q - y
    return _on_curve(G1Affine(x, y))


def g1_to_uncompressed(p: G1Affine) -> bytes:
    if p.is_infinity:
        b = bytearray(64)
        b[63] |= _INF_FLAG
        return bytes(b)
    return p.x.to_bytes(32, "little") + p.y.to_bytes(32, "little")


def g1_from_uncompressed(b: bytes) -> G1Affine:
    _check_len(b, 64, "G1 uncompressed")
    if b[63] & _INF_FLAG:
        return G1Affine.identity()
    return _on_curve(G1Affine(int.from_bytes(b[:32], "little"),
                              int.from_bytes(b[32:], "little")))


# -- G2 ---------------------------------------------------------------------

def _fq2_is_negative(y: tuple[int, int]) -> bool:
    """Lexicographic (c1, then c0) comparison of y against -y (ark's
    QuadExtField order)."""
    ny = ((Q - y[0]) % Q, (Q - y[1]) % Q)
    return (y[1], y[0]) > (ny[1], ny[0])


def _fq2_sqrt(a: tuple[int, int]) -> tuple[int, int]:
    """Square root in Fq[u]/(u^2+1) by the norm (q = 3 mod 4)."""
    c0, c1 = a
    if c1 == 0:
        try:
            return (_fq_sqrt(c0), 0)
        except ValueError:
            # sqrt(c0) = t*u with t^2 = -c0
            return (0, _fq_sqrt((Q - c0) % Q))
    d = _fq_sqrt((c0 * c0 + c1 * c1) % Q)      # the norm (u^2 = -1)
    inv2 = pow(2, Q - 2, Q)
    g0 = (c0 + d) * inv2 % Q
    try:
        r0 = _fq_sqrt(g0)
    except ValueError:
        g0 = (c0 - d) * inv2 % Q
        r0 = _fq_sqrt(g0)
    return (r0, c1 * pow(2 * r0, Q - 2, Q) % Q)


def g2_to_compressed(p: G2Affine) -> bytes:
    if p.is_infinity:
        b = bytearray(64)
        b[63] |= _INF_FLAG
        return bytes(b)
    b = bytearray(p.x[0].to_bytes(32, "little")
                  + p.x[1].to_bytes(32, "little"))
    if _fq2_is_negative(p.y):
        b[63] |= _NEG_FLAG
    return bytes(b)


def g2_from_compressed(b: bytes) -> G2Affine:
    _check_len(b, 64, "G2 compressed")
    flags = b[63] & 0xC0
    c0 = int.from_bytes(b[:32], "little")
    c1 = int.from_bytes(b[32:63] + bytes([b[63] & 0x3F]), "little")
    if flags & _INF_FLAG:
        return G2Affine.identity()
    x = (c0, c1)
    bprime = fq2_mul((3, 0), fq2_inv((9, 1)))
    y = _fq2_sqrt(fq2_add(fq2_mul(fq2_square(x), x), bprime))
    if bool(flags & _NEG_FLAG) != _fq2_is_negative(y):
        y = ((Q - y[0]) % Q, (Q - y[1]) % Q)
    return _on_curve(G2Affine(x, y))


# -- SRS persistence (kzg.rs:22-84) ------------------------------------------

def save_srs(path: str, g1_points: list[G1Affine], g2: G2Affine,
             beta_g2: G2Affine) -> None:
    """Vec<G1Affine> (compressed) || g2 || beta_g2, ark's byte layout."""
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(g1_points)))
        for p in g1_points:
            f.write(g1_to_compressed(p))
        f.write(g2_to_compressed(g2))
        f.write(g2_to_compressed(beta_g2))


def load_srs(path: str) -> tuple[list[G1Affine], G2Affine, G2Affine]:
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        g1 = [g1_from_compressed(f.read(32)) for _ in range(n)]
        g2 = g2_from_compressed(f.read(64))
        beta_g2 = g2_from_compressed(f.read(64))
        if f.read():
            raise ValueError("trailing bytes in SRS file")
    return g1, g2, beta_g2
