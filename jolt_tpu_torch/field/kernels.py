"""Field kernels: Montgomery products (K1, K4) and the GKR pair round (K2, K3).

Each wrapper takes limb tensors in jolt_tpu's layouts.  On CPU tensors it
runs the plain PyTorch version beside it (the tests' path); on CUDA
tensors it checks device, dtype, shape and strides, allocates its outputs
with torch.empty, launches the hand-written kernel of csrc/mont.cu or
csrc/gp_pair.cu on the current stream, and counts the launch.  It never
falls back from the card to the plain version.

| wrapper        | replaces (jolt_tpu/field/pallas_mont.py) | source          |
| mont_mul       | mont_mul_pallas (K1)                     | csrc/mont.cu    |
| mont_mul_bl    | mont_mul_bl_pallas (K4)                  | csrc/mont.cu    |
| gp_pair_evals  | gp_pair_evals_pallas (K2)                | csrc/gp_pair.cu |
| gp_pair_bind   | gp_pair_bind_pallas (K3)                 | csrc/gp_pair.cu |
"""
from __future__ import annotations

import torch

from .. import _native as nat
from . import arith
from .spec import FieldSpec, NUM_LIMBS

L = NUM_LIMBS

_MONT_ARGS = [nat.vptr] * 3 + [nat.i64] * 10 + [nat.u32p, nat.vptr]

MONT_MUL = nat.CudaKernel(
    "mont_mul", "mont", "jt_mont_mul", _MONT_ARGS,
    "jolt_tpu/field/pallas_mont.py:248 mont_mul_pallas", "mont_mul_kernel",
    256)
MONT_MUL_BL = nat.CudaKernel(
    "mont_mul_bl", "mont", "jt_mont_mul", _MONT_ARGS,
    "jolt_tpu/field/pallas_mont.py:496 mont_mul_bl_pallas", "mont_mul_kernel",
    256)
GP_PAIR_EVALS = nat.CudaKernel(
    "gp_pair_evals", "gp_pair", "jt_gp_pair_evals",
    [nat.vptr] * 7 + [nat.i64] * 11 + [nat.u32p, nat.vptr],
    "jolt_tpu/field/pallas_mont.py:754 gp_pair_evals_pallas",
    "gp_pair_evals_kernel", 256)
GP_PAIR_BIND = nat.CudaKernel(
    "gp_pair_bind", "gp_pair", "jt_gp_pair_bind",
    [nat.vptr] * 6 + [nat.i64] * 7 + [nat.u32p, nat.u32p, nat.vptr],
    "jolt_tpu/field/pallas_mont.py:769 gp_pair_bind_pallas",
    "gp_pair_bind_kernel", 256)

GP_WARPS = 8          # warps per K2 block (GP_THREADS / 32 in gp_pair.cu)
GP_MIN_BLOCKS = 2     # K2 blocks per SM (its launch bound in gp_pair.cu)
GP_TILE = 32          # pair indices per warp
GP_MAX_BLOCKS = 1024  # K2 blocks, each writing one partial sum
GP_MAX_B = 64         # circuits per batch (GP_MAX_B there)
H100_SMS = 132
GP_WAVE_WARPS = H100_SMS * GP_MIN_BLOCKS * GP_WARPS  # K2 warps resident at
#   once on the H100


def _all_cpu(*ts) -> bool:
    return all(t.device.type == "cpu" for t in ts)


def _operand(name: str, t: torch.Tensor, shape):
    """(tensor, limb stride, element stride) of a K1 operand: a scalar
    [16, 1, ...] goes in with element stride 0 (never materialised); a
    full-shape operand whose limb rows are contiguous goes in as it is;
    anything else is made contiguous first."""
    if t.dim() < 1 or t.shape[0] != L:
        raise ValueError(f"{name}: expected [16, ...] limbs, got {tuple(t.shape)}")
    if t[0].numel() == 1:
        return t, t.stride(0), 0
    if tuple(t.shape) != tuple(shape) or not t[0].is_contiguous():
        t = t.expand(shape).contiguous()
    return t, t.stride(0), 1


# ---------------------------------------------------------------------------
# K1: elementwise Montgomery product over [16, *batch]
# ---------------------------------------------------------------------------

def mont_mul(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor
             ) -> torch.Tensor:
    """a * b * R^{-1} mod p over broadcast limb tensors [16, *batch]."""
    if _all_cpu(a, b):
        return arith.mont_mul(spec, a, b)
    nat.require_cuda("mont_mul", a, b)
    shape = arith.bshape(a.shape, b.shape)
    out = torch.empty(shape, dtype=torch.int32, device=a.device)
    n = out[0].numel()
    if n == 0:
        return out
    a, a_ls, a_es = _operand("mont_mul", a, shape)
    b, b_ls, b_es = _operand("mont_mul", b, shape)
    MONT_MUL.launch(nat.ptr(a), nat.ptr(b), nat.ptr(out), 1, n,
                    0, a_ls, a_es, 0, b_ls, b_es, 0, n,
                    nat.words(spec.words32()), nat.stream(out))
    return out


# ---------------------------------------------------------------------------
# K4: the same product on batch-leading layers [B, 16, s]
# ---------------------------------------------------------------------------

def mont_mul_bl_plain(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor
                      ) -> torch.Tensor:
    return arith.mont_mul(spec, a.movedim(0, 1), b.movedim(0, 1)
                          ).movedim(0, 1).contiguous()


def _check_bl(name: str, *ts: torch.Tensor):
    shape = ts[0].shape
    for t in ts:
        if t.dim() != 3 or t.shape[1] != L or t.shape != shape:
            raise ValueError(f"{name}: expected equal [B, 16, s] layers, "
                             f"got {[tuple(x.shape) for x in ts]}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: the last axis must be contiguous")


def mont_mul_bl(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor
                ) -> torch.Tensor:
    """Elementwise Montgomery product of [B, 16, s] layers (the GP tree
    level).  Views with a contiguous last axis go in without a copy."""
    _check_bl("mont_mul_bl", a, b)
    if _all_cpu(a, b):
        return mont_mul_bl_plain(spec, a, b)
    nat.require_cuda("mont_mul_bl", a, b)
    B, _, s = a.shape
    out = torch.empty((B, L, s), dtype=torch.int32, device=a.device)
    if B * s == 0:
        return out
    MONT_MUL_BL.launch(nat.ptr(a), nat.ptr(b), nat.ptr(out), B, s,
                       a.stride(0), a.stride(1), 1,
                       b.stride(0), b.stride(1), 1, L * s, s,
                       nat.words(spec.words32()), nat.stream(out))
    return out


def _check_pair(name: str, l, r, eq):
    """A GP round's layout: equal [B, 16, s] layers, s even, eq [16, s],
    each with a contiguous last axis."""
    _check_bl(name, l, r)
    s = l.shape[-1]
    if s < 2 or s % 2:
        raise ValueError(f"{name}: pair size {s} must be even")
    if tuple(eq.shape) != (L, s):
        raise ValueError(f"{name}: eq {tuple(eq.shape)} != (16, {s})")
    if eq.stride(-1) != 1:
        raise ValueError(f"{name}: eq's last axis must be contiguous")


# ---------------------------------------------------------------------------
# K2: cubic GKR round evaluations over bit-reversed pair layers
# ---------------------------------------------------------------------------

def gp_pair_evals_plain(spec: FieldSpec, l, r, eq, coeffs) -> torch.Tensor:
    """jolt_tpu/subprotocols/grand_product.py:203-227, term for term."""
    mul = arith.mont_mul
    add = lambda x, y: arith.add(spec, x, y)
    sub = lambda x, y: arith.sub(spec, x, y)
    s = l.shape[-1]
    h = s // 2
    lf, rf = l.movedim(0, 1), r.movedim(0, 1)            # [16, B, s]
    l0, l1 = lf[..., :h], lf[..., h:]
    r0, r1 = rf[..., :h], rf[..., h:]
    cb = coeffs[:, :, None]
    cl0 = mul(spec, cb, l0)
    cl1 = mul(spec, cb, l1)
    m_l = sub(cl1, cl0)
    m_r = sub(r1, r0)
    le2 = add(cl1, m_l)
    le3 = add(le2, m_l)
    re2 = add(r1, m_r)
    re3 = add(re2, m_r)
    fsum = lambda x, d: arith.sum_limbs(spec, x, d, mul)
    s0 = fsum(mul(spec, cl0, r0), 0)                     # [16, h]
    s2 = fsum(mul(spec, le2, re2), 0)
    s3 = fsum(mul(spec, le3, re3), 0)
    eq0, eq1 = eq[..., :h], eq[..., h:]
    m_eq = sub(eq1, eq0)
    eqe2 = add(eq1, m_eq)
    eqe3 = add(eqe2, m_eq)
    e0 = fsum(mul(spec, eq0, s0), 0)
    e2 = fsum(mul(spec, eqe2, s2), 0)
    e3 = fsum(mul(spec, eqe3, s3), 0)
    return torch.stack([e0, e2, e3], dim=1)              # [16, 3]


def gp_evals_plan(B: int, h: int) -> tuple[int, int]:
    """K2's launch geometry for B circuits and h pair indices: (groups,
    blocks).  A warp covers 32 consecutive pair indices and one group of
    circuits (b = g, g + groups, ...).  groups is 1, 2, 4 or 8 (a block's
    8 warps hold 8 / groups tiles) or a multiple of 8 (groups / 8 blocks
    share a tile); it is the largest whose warps fit in one wave
    (GP_WAVE_WARPS), or 1: a large round runs as one even wave with the
    fewest group partials, a small round spreads its circuits until each
    thread holds one.  blocks is capped at GP_MAX_BLOCKS and the tiles are
    looped over beyond it.  The blocks that share a tile pay for
    themselves: K2's device time per fib T = 2^16 prove is 8.1 ms with
    them and 11.5 ms with groups capped at 8, on an H100
    (scripts/profile_torch_prove.py --replay-k2 on each variant)."""
    if not 1 <= B <= GP_MAX_B or h < 1:
        raise ValueError(f"gp_evals_plan: B = {B}, h = {h}")
    tiles = -(-h // GP_TILE)
    top = 1 << (B - 1).bit_length() if B <= GP_WARPS else -(-B // 8) * 8
    cands = [g for g in (1, 2, 4, 8, *range(16, GP_MAX_B + 1, 8)) if g <= top]
    groups = max(g for g in cands if g == 1 or tiles * g <= GP_WAVE_WARPS)
    per_block = min(groups, GP_WARPS)
    shared = groups // per_block                 # blocks that share a tile
    tile_blocks = -(-tiles // (GP_WARPS // per_block))
    return groups, min(tile_blocks, GP_MAX_BLOCKS // shared) * shared


_GP_COUNTERS: dict[tuple[torch.device, int], torch.Tensor] = {}


def _gp_counter(device: torch.device) -> torch.Tensor:
    """K2's last-block ticket for the current stream of `device`: 0
    between launches (the last block resets it).  One counter per stream,
    so no two launches that may overlap share one: a stream runs its
    launches in order."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    if key not in _GP_COUNTERS:
        _GP_COUNTERS[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return _GP_COUNTERS[key]


def gp_pair_evals(spec: FieldSpec, l: torch.Tensor, r: torch.Tensor,
                  eq: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """sum_i eq_t(i) * sum_b coeff_b * l_t(b, i) * r_t(b, i) at t = 0, 2, 3
    -> [16, 3].  l, r: [B, 16, s]; eq: [16, s]; coeffs: [16, B]."""
    _check_pair("gp_pair_evals", l, r, eq)
    B = l.shape[0]
    if B > GP_MAX_B:
        raise ValueError(f"gp_pair_evals: batch {B} above {GP_MAX_B}")
    if tuple(coeffs.shape) != (L, B):
        raise ValueError(f"gp_pair_evals: coeffs {tuple(coeffs.shape)}")
    if _all_cpu(l, r, eq, coeffs):
        return gp_pair_evals_plain(spec, l, r, eq, coeffs)
    nat.require_cuda("gp_pair_evals", l, r, eq, coeffs)
    h = l.shape[-1] // 2
    groups, nblocks = gp_evals_plan(B, h)
    partials = torch.empty((nblocks, 3, 8), dtype=torch.int32, device=l.device)
    out = torch.empty((L, 3), dtype=torch.int32, device=l.device)
    GP_PAIR_EVALS.launch(
        nat.ptr(l), nat.ptr(r), nat.ptr(eq), nat.ptr(coeffs),
        nat.ptr(partials), nat.ptr(_gp_counter(l.device)), nat.ptr(out), B, h,
        groups, l.stride(0), l.stride(1), r.stride(0), r.stride(1),
        eq.stride(0), coeffs.stride(0), coeffs.stride(1), nblocks,
        nat.words(spec.words32()), nat.stream(out))
    return out


# ---------------------------------------------------------------------------
# K3: bind the pair layers and eq to the round challenge
# ---------------------------------------------------------------------------

def gp_pair_bind_plain(spec: FieldSpec, l, r, eq, r_chal):
    """jolt_tpu/subprotocols/grand_product.py:241-249."""
    h = l.shape[-1] // 2
    rc = r_chal.reshape(L).to(l.device)

    def bind_lf(t):                                      # t: [16, ..., s]
        lo, hi = t[..., :h], t[..., h:]
        rb = rc.reshape((L,) + (1,) * (t.dim() - 1))
        return arith.add(spec, lo, arith.mont_mul(
            spec, rb, arith.sub(spec, hi, lo)))

    nl = bind_lf(l.movedim(0, 1)).movedim(0, 1).contiguous()
    nr = bind_lf(r.movedim(0, 1)).movedim(0, 1).contiguous()
    return nl, nr, bind_lf(eq)


def gp_pair_bind(spec: FieldSpec, l: torch.Tensor, r: torch.Tensor,
                 eq: torch.Tensor, r_chal: torch.Tensor):
    """new = lo + r * (hi - lo) on contiguous halves of l, r [B, 16, s] and
    eq [16, s].  r_chal: Montgomery limbs [16], passed to the kernel by
    value (hand it a CPU tensor: a CUDA one costs a sync to read)."""
    _check_pair("gp_pair_bind", l, r, eq)
    if _all_cpu(l, r, eq):
        return gp_pair_bind_plain(spec, l, r, eq, r_chal)
    nat.require_cuda("gp_pair_bind", l, r, eq)
    B, _, s = l.shape
    h = s // 2
    limbs = [int(v) for v in r_chal.reshape(L).tolist()]
    rc = nat.words(limbs[2 * k] | (limbs[2 * k + 1] << 16) for k in range(8))
    nl = torch.empty((B, L, h), dtype=torch.int32, device=l.device)
    nr = torch.empty((B, L, h), dtype=torch.int32, device=l.device)
    neq = torch.empty((L, h), dtype=torch.int32, device=l.device)
    GP_PAIR_BIND.launch(
        nat.ptr(l), nat.ptr(r), nat.ptr(eq), nat.ptr(nl), nat.ptr(nr),
        nat.ptr(neq), B, h, l.stride(0), l.stride(1), r.stride(0),
        r.stride(1), eq.stride(0), rc, nat.words(spec.words32()),
        nat.stream(nl))
    return nl, nr, neq
