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


def bshape(x: torch.Size, y: torch.Size) -> torch.Size:
    """torch.broadcast_shapes, with the common cases first: equal shapes,
    or one operand a broadcast column of the other (the general call costs
    a fifth of a millisecond of Python)."""
    if x == y:
        return x
    if len(x) == len(y):
        if all(b in (1, a) for a, b in zip(x, y)):
            return x
        if all(a in (1, b) for a, b in zip(x, y)):
            return y
    return torch.broadcast_shapes(x, y)


CARRY_PARALLEL_MAX = 1 << 8    # lanes up to which a CPU carry or borrow
#   takes whole-tensor passes (see carry; threshold from
#   scripts/time_cpu_carry.py)


def carry(t: torch.Tensor) -> torch.Tensor:
    """Propagate carries along the limb axis: nonnegative int64 column
    sums [k, ...] -> 16-bit limbs [k, ...] (the carry out of the top limb
    is dropped, i.e. the result is mod 2^(16k)).

    Two routes give the same limbs.  Limb by limb costs three ops a limb;
    whole-tensor passes (each moves every limb's carry one limb up, until
    none is left) cost a few ops a pass, fewer ops where carries are
    short, but each pass reads every limb and asks the host whether to go
    on.  On the CPU an op costs microseconds of overhead, so a tensor of
    up to CARRY_PARALLEL_MAX lanes takes the passes; a CUDA tensor, whose
    ops must not sync, always goes limb by limb."""
    if t.device.type == "cpu" and t[0].numel() <= CARRY_PARALLEL_MAX:
        return _carry_passes(t)
    return _carry_limbs(t)


def _carry_limbs(t: torch.Tensor) -> torch.Tensor:
    out = torch.empty_like(t)
    c = torch.zeros_like(t[0])
    for k in range(t.shape[0]):
        v = t[k] + c
        out[k] = v & MASK
        c = v >> W
    return out


def _carry_passes(t: torch.Tensor) -> torch.Tensor:
    out = t
    c = out >> W
    while bool(c.any()):
        out = out & MASK
        out[1:] += c[:-1]
        c = out >> W
    return out


def sub_borrow(a: torch.Tensor, b: torch.Tensor):
    """a - b limbwise over int64 16-bit limbs -> (diff limbs mod 2^256,
    final borrow 0/1); the routes are carry()'s."""
    d = a - b                           # each limb in (-2^16, 2^16)
    if d.device.type == "cpu" and d[0].numel() <= CARRY_PARALLEL_MAX:
        return _borrow_passes(d)
    return _borrow_limbs(d)


def _borrow_limbs(d: torch.Tensor):
    out = torch.empty_like(d)
    borrow = torch.zeros_like(d[0])
    for k in range(d.shape[0]):
        v = d[k] - borrow
        out[k] = v & MASK
        borrow = -(v >> W)          # v in [-2^16, 2^16): v >> 16 is -1 or 0
    return out, borrow


def _borrow_passes(d: torch.Tensor):
    out, borrow = d, torch.zeros_like(d[0])
    b = -(out >> W)                     # 1 where a limb is < 0
    while bool(b.any()):
        out = out & MASK
        out[1:] -= b[:-1]
        borrow = borrow + b[-1]
        b = -(out >> W)
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
    shape = bshape(a.shape[1:], b.shape[1:])
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


def reduce_wide(spec: FieldSpec, total: torch.Tensor, n: int, mul
                ) -> torch.Tensor:
    """Limb-wise integer sums of n field elements (int64 [16, ...], each
    limb sum below 2^47) -> their value mod p.

    The carried total V = lo + hi * 2^256 is reduced: lo < 2^256 < 6p by
    five conditional subtractions, and hi * 2^256 mod p = mul(hi, R^2 mod p)
    with `mul` a Montgomery product (the plain one, or the kernel's)."""
    extra = max(1, -(-(max(n, 1).bit_length() + 1) // W))
    t = torch.cat([total, total.new_zeros((extra,) + total.shape[1:])])
    t = carry(t)                                       # exact: no carry lost
    lo = t[:L]
    for _ in range(5):
        lo = cond_sub_p(spec, lo)
    hi = torch.cat([t[L:], t.new_zeros((L - extra,) + t.shape[1:])])
    r2 = _col(const_limbs(spec, "r2", total.device), hi.dim() - 1)
    return add(spec, lo, mul(spec, hi.int(), r2))


def sum_limbs(spec: FieldSpec, a: torch.Tensor, dim: int) -> torch.Tensor:
    """Modular sum over logical axis `dim` of a limb tensor [16, ...]: the
    limbs are summed as plain integers (exact in int64 for fewer than 2^47
    terms), then reduced once (reduce_wide).  One multiply, whatever the
    number of terms."""
    ax = dim + 1 if dim >= 0 else dim + a.dim()
    return reduce_wide(spec, a.long().sum(dim=ax), a.shape[ax], mont_mul)


def suffix_sums(spec: FieldSpec, a: torch.Tensor, mul) -> torch.Tensor:
    """out[..., j] = sum_{i >= j} a[..., i] mod p along the last axis: one
    integer cumulative sum of the limbs, then one reduction."""
    total = a.long().flip(-1).cumsum(dim=-1).flip(-1)
    return reduce_wide(spec, total, a.shape[-1], mul)
