"""Plain limb arithmetic in PyTorch: int64 limbs, written to be obviously right.

These functions are the port's modular add/sub and the plain versions
that the CUDA kernels are held against: carries run limb by limb, and the
Montgomery product is the schoolbook product followed by one REDC, as in
jolt_tpu/field/device.py (`_mul_columns`, `_carry`, `_mont_redc`).
Inputs are limb tensors [16, *batch] (any integer dtype, values < 2^16,
field elements < p); outputs are int32 limbs of the reduced value.  Every
reduced result is unique, so these agree bit for bit with the JAX package
and with the kernels.
"""
from __future__ import annotations

import functools

import torch

from .spec import FieldSpec, LIMB_BITS, LIMB_MASK, NUM_LIMBS

L = NUM_LIMBS
W = LIMB_BITS
MASK = LIMB_MASK


@functools.lru_cache(maxsize=64)
def const_limbs(spec: FieldSpec, name: str, device: torch.device
                ) -> torch.Tensor:
    """A constant of `spec` ("p", "nprime", "r", "r2", or "one", the
    integer 1) as int32 limbs [16] on `device`, made once per device."""
    limbs = {"p": spec.p_limbs, "nprime": spec.nprime_limbs,
             "r": spec.r_limbs, "r2": spec.r2_limbs}.get(name)
    if limbs is None:
        assert name == "one"
        limbs = [1] + [0] * (L - 1)
    return torch.tensor([int(v) for v in limbs], dtype=torch.int32,
                        device=device)


def _col(t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Limb vector [k] -> [k, 1, ..., 1] for broadcasting over ndim dims."""
    return t.reshape((t.shape[0],) + (1,) * ndim)


def carry(t: torch.Tensor) -> torch.Tensor:
    """Propagate carries along the limb axis: nonnegative int64 column
    sums [k, ...] -> 16-bit limbs [k, ...] (the carry out of the top limb
    is dropped, i.e. the result is mod 2^(16k))."""
    out = torch.empty_like(t)
    c = torch.zeros_like(t[0])
    for k in range(t.shape[0]):
        v = t[k] + c
        out[k] = v & MASK
        c = v >> W
    return out


def sub_borrow(a: torch.Tensor, b: torch.Tensor):
    """a - b limbwise over int64 16-bit limbs -> (diff limbs mod 2^256,
    final borrow 0/1)."""
    shape = torch.broadcast_shapes(a.shape, b.shape)
    out = torch.empty(shape, dtype=torch.int64, device=a.device)
    borrow = torch.zeros(shape[1:], dtype=torch.int64, device=a.device)
    for k in range(shape[0]):
        v = a[k] - b[k] - borrow
        out[k] = v & MASK
        borrow = -(v >> W)          # v in [-2^16, 2^16): v >> 16 is -1 or 0
    return out, borrow


def cond_sub_p(spec: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    """x - p if x >= p else x (int64 limbs)."""
    p = _col(const_limbs(spec, "p", x.device).long(), x.dim() - 1)
    d, borrow = sub_borrow(x, p)
    return torch.where(borrow == 0, d, x)


def add(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod p."""
    s = carry(a.long() + b.long())        # < 2p < 2^256: no carry is lost
    return cond_sub_p(spec, s).int()


def sub(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod p."""
    d, borrow = sub_borrow(a.long(), b.long())
    p = _col(const_limbs(spec, "p", d.device).long(), d.dim() - 1)
    dp = carry(d + p)                     # mod 2^256: wraps back into [0, p)
    return torch.where(borrow == 1, dp, d).int()


def mont_mul(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor
             ) -> torch.Tensor:
    """Montgomery product a*b*R^{-1} mod p over broadcast limb tensors:
    schoolbook columns, then m = (T mod R)*N' mod R and (T + m*p)/R."""
    a, b = a.long(), b.long()
    shape = torch.broadcast_shapes(a.shape[1:], b.shape[1:])
    a = a.expand((L,) + shape)
    b = b.expand((L,) + shape)
    t = torch.zeros((2 * L + 1,) + shape, dtype=torch.int64, device=a.device)
    for i in range(L):
        t[i:i + L] += a[i] * b            # each column < 16 * 2^32
    t = carry(t)                          # T = a*b < p^2, 16-bit limbs
    nprime = _col(const_limbs(spec, "nprime", a.device).long(), len(shape))
    m = torch.zeros((L,) + shape, dtype=torch.int64, device=a.device)
    for i in range(L):
        m[i:] += t[i] * nprime[:L - i]    # truncated mod R
    m = carry(m)                          # m = (T mod R) * N' mod R
    p = _col(const_limbs(spec, "p", a.device).long(), len(shape))
    u = torch.zeros((2 * L + 1,) + shape, dtype=torch.int64, device=a.device)
    for i in range(L):
        u[i:i + L] += m[i] * p
    s = carry(u + t)                      # T + m*p, divisible by R
    return cond_sub_p(spec, s[L:2 * L]).int()


def sum_limbs(spec: FieldSpec, a: torch.Tensor, dim: int, mul
              ) -> torch.Tensor:
    """Modular sum over logical axis `dim` of a limb tensor [16, ...].

    The limbs are summed as plain integers (exact in int64 for fewer than
    2^47 terms); the carried total V = lo + hi * 2^256 is then reduced:
    lo < 2^256 < 6p by five conditional subtractions, and hi * 2^256 mod p
    = mul(hi, R^2 mod p) with `mul` a Montgomery product (the plain one,
    or the kernel's).  One multiply, whatever the number of terms."""
    ax = dim + 1 if dim >= 0 else dim + a.dim()
    n = a.shape[ax]
    total = a.long().sum(dim=ax)                       # [16, ...]
    extra = max(1, -(-(max(n, 1).bit_length() + 1) // W))
    t = torch.cat([total, total.new_zeros((extra,) + total.shape[1:])])
    t = carry(t)                                       # exact: no carry lost
    lo = t[:L]
    for _ in range(5):
        lo = cond_sub_p(spec, lo)
    hi = torch.cat([t[L:], t.new_zeros((L - extra,) + t.shape[1:])])
    r2 = _col(const_limbs(spec, "r2", a.device), hi.dim() - 1)
    return add(spec, lo, mul(spec, hi.int(), r2))
