"""Field kernels: Montgomery products (K1, K4), the GKR pair round (K2,
K3), the modular add, subtract and sum (K10, K11), and the sumcheck
rounds of the toggled grand product and the opening reduction (K14-K17).

Each wrapper takes limb tensors in jolt_tpu's layouts.  On CPU tensors it
runs the plain PyTorch version beside it (the tests' path); on CUDA
tensors it checks device, dtype, shape and strides, allocates its outputs
with torch.empty, launches the hand-written kernel of csrc/ on the
current stream, and counts the launch.  It never falls back from the
card to the plain version.

| wrapper        | replaces                                        | source             |
| mont_mul       | field/pallas_mont.py mont_mul_pallas (K1)       | csrc/mont.cu       |
| mont_mul_bl    | field/pallas_mont.py mont_mul_bl_pallas (K4)    | csrc/mont.cu       |
| gp_pair_evals  | field/pallas_mont.py gp_pair_evals_pallas (K2)  | csrc/gp_pair.cu    |
| gp_pair_bind   | field/pallas_mont.py gp_pair_bind_pallas (K3)   | csrc/gp_pair.cu    |
| field_addsub   | field/device.py _fadd_jit, _fsub_jit (K10, jit) | csrc/field_ops.cu  |
| field_sum      | field/device.py _fsum_jit (K11, jit)            | csrc/field_ops.cu  |

(paths under jolt_tpu/; the toggle round, the reduction round and the RLC
in csrc/sumcheck_ops.cu, each replacing a jax.jit program:)

| wrapper         | replaces                                                |
| toggle_evals    | subprotocols/grand_product.py _toggle_cubic_evals (K14) |
| bind_halves     | grand_product.py _toggle_bind; poly/opening_proof.py    |
|                 | _reduction_round_fs's bind_top calls (K15)              |
| reduction_evals | opening_proof.py _reduction_round_fs's evaluations,     |
|                 | _quadratic_evals (K16)                                  |
| rlc             | opening_proof.py _rlc and rlc_polys' padding (K17)      |

(paths under jolt_tpu/; the primary sumcheck's round, with its
collations and finisher, is vm/instruction_lookups.py's `primary_round`,
csrc/collate.cu.)
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
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
    [nat.vptr] * 6 + [nat.i64] * 7 + [nat.u32p, nat.vptr, nat.u32p,
                                       nat.vptr],
    "jolt_tpu/field/pallas_mont.py:769 gp_pair_bind_pallas",
    "gp_pair_bind_kernel", 256)

FIELD_ADDSUB = nat.CudaKernel(
    "field_addsub", "field_ops", "jt_field_addsub",
    [nat.vptr] * 3 + [nat.i64] * 9 + [nat.u32p, nat.vptr],
    "jolt_tpu/field/device.py:199-200 _fadd_jit, _fsub_jit (jax.jit)",
    "field_addsub_kernel", 256)
FIELD_SUM = nat.CudaKernel(
    "field_sum", "field_ops", "jt_field_sum",
    [nat.vptr] * 2 + [nat.i64] * 11 + [nat.vptr] * 2 + [nat.u32p, nat.vptr],
    "jolt_tpu/field/device.py:401-403 _fsum_jit (jax.jit)",
    "field_sum_kernel", 256)

_I64P = ctypes.POINTER(ctypes.c_int64)
TOGGLE_EVALS = nat.CudaKernel(
    "toggle_evals", "sumcheck_ops", "jt_toggle_evals",
    [nat.vptr] * 4 + [_I64P] + [nat.i64] * 4 + [nat.vptr] * 3
    + [nat.u32p, nat.vptr],
    "jolt_tpu/subprotocols/grand_product.py:976 _toggle_cubic_evals (jax.jit)",
    "toggle_evals_kernel", 256)
BIND_HALVES = nat.CudaKernel(
    "bind_halves", "sumcheck_ops", "jt_bind_halves",
    [_I64P] * 7 + [nat.i64, nat.u32p, nat.vptr, nat.u32p, nat.vptr],
    "jolt_tpu/subprotocols/grand_product.py:1017 _toggle_bind (jax.jit); "
    "jolt_tpu/poly/opening_proof.py:71-72 (the binds of "
    "_reduction_round_fs)", "bind_halves_kernel", 256)
REDUCTION_EVALS = nat.CudaKernel(
    "reduction_evals", "sumcheck_ops", "jt_reduction_evals",
    [_I64P] * 4 + [nat.u32p, nat.i64, nat.i64, nat.u32p, nat.i64]
    + [nat.vptr] * 3 + [nat.u32p, nat.vptr],
    "jolt_tpu/poly/opening_proof.py:56 _reduction_round_fs (jax.jit) and "
    ":144 _quadratic_evals", "reduction_evals_kernel", 256)
RLC = nat.CudaKernel(
    "rlc", "sumcheck_ops", "jt_rlc",
    [_I64P] * 3 + [nat.u32p, nat.i64, nat.i64] + [nat.vptr] * 2
    + [nat.u32p, nat.vptr],
    "jolt_tpu/poly/opening_proof.py:30 _rlc (jax.jit) and :41 rlc_polys",
    "rlc_kernel", 256)

GP_WARPS = 8          # warps per K2 block (GP_THREADS / 32 in gp_pair.cu)
GP_MIN_BLOCKS = 2     # K2 blocks per SM (its launch bound in gp_pair.cu)
GP_TILE = 32          # pair indices per warp
GP_MAX_BLOCKS = 1024  # K2 blocks, each writing one partial sum
GP_MAX_B = 128        # circuits per launch (GP_MAX_B there); larger batches
#   are split over launches by `gp_batch_chunks`
H100_SMS = 132
GP_WAVE_WARPS = H100_SMS * GP_MIN_BLOCKS * GP_WARPS  # K2 warps resident at
#   once on the H100


def _all_cpu(*ts) -> bool:
    return all(t.device.type == "cpu" for t in ts)


@functools.cache
def field_words(spec: FieldSpec) -> ctypes.Array:
    """spec's modulus and inverse as the kernels take them (made once)."""
    return nat.words(spec.words32())


def _strides2d(t: torch.Tensor, shape) -> tuple[int, int, int] | None:
    """(batch stride, limb stride, element stride) that address `t`
    broadcast to `shape` [16, *batch] as (bb, i), i the last logical axis
    and bb the others flattened; None where the leading axes do not
    flatten to one stride."""
    st = t.stride() if t.shape == shape else t.expand(shape).stride()
    if len(shape) == 1:
        return 0, st[0], 0
    es = st[-1] if shape[-1] > 1 else 0
    bs = span = None
    for d in range(len(shape) - 2, 0, -1):        # innermost first
        if shape[d] == 1:
            continue
        if span is not None and st[d] != span:
            return None
        bs = st[d] if bs is None else bs
        span = st[d] * shape[d]
    return bs or 0, st[0], es


def _operand(name: str, t: torch.Tensor, shape, n: int):
    """A K1 or K10 operand broadcast to `shape` (n elements): (tensor,
    bs, ls, es), a view without a copy where _strides2d finds strides (a
    scalar [16, 1, ...] with strides 0, a half of a wider tensor), else
    the broadcast made contiguous."""
    if t.dim() < 1 or t.shape[0] != L:
        raise ValueError(f"{name}: expected [16, ...] limbs, got "
                         f"{tuple(t.shape)}")
    if not (t.shape == shape and t.is_contiguous()):
        st = _strides2d(t, shape)
        if st is not None:
            return (t, *st)
        t = t.expand(shape).contiguous()
    return t, (shape[-1] if len(shape) > 1 else 1), n, 1


# ---------------------------------------------------------------------------
# K1: elementwise Montgomery product over [16, *batch]
# ---------------------------------------------------------------------------

def mont_mul(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor
             ) -> torch.Tensor:
    """a * b * R^{-1} mod p over broadcast limb tensors [16, *batch]."""
    if _all_cpu(a, b):
        return arith.mont_mul(spec, a, b)
    nat.require_cuda("mont_mul", a, b)
    shape = a.shape if a.shape == b.shape else arith.bshape(a.shape, b.shape)
    out = torch.empty(shape, dtype=torch.int32, device=a.device)
    n = out.numel() // L
    if n == 0:
        return out
    s = shape[-1] if len(shape) > 1 else 1
    a, a_bs, a_ls, a_es = _operand("mont_mul", a, shape, n)
    b, b_bs, b_ls, b_es = _operand("mont_mul", b, shape, n)
    MONT_MUL.launch(nat.ptr(a), nat.ptr(b), nat.ptr(out), n // s, s,
                    a_bs, a_ls, a_es, b_bs, b_ls, b_es, s, n,
                    field_words(spec), nat.stream(out),
                    device=out.device)
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
                       field_words(spec), nat.stream(out),
                       device=out.device)
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
    fsum = lambda x, d: arith.sum_limbs(spec, x, d)
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
    (scripts/profile_torch_prove.py --replay-k2 on each variant).  B is
    one launch's batch, at most GP_MAX_B."""
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


def gp_batch_chunks(B: int) -> list[tuple[int, int]]:
    """K2's launches for a batch of B circuits: [b0, b1) slices of at most
    GP_MAX_B circuits.  The evals are linear in the circuits, so their sum
    mod p over the slices is the whole batch's."""
    return [(b0, min(b0 + GP_MAX_B, B)) for b0 in range(0, B, GP_MAX_B)]


def gp_pair_evals(spec: FieldSpec, l: torch.Tensor, r: torch.Tensor,
                  eq: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """sum_i eq_t(i) * sum_b coeff_b * l_t(b, i) * r_t(b, i) at t = 0, 2, 3
    -> [16, 3].  l, r: [B, 16, s]; eq: [16, s]; coeffs: [16, B]; any
    B >= 1 (one launch per `gp_batch_chunks` slice)."""
    _check_pair("gp_pair_evals", l, r, eq)
    B = l.shape[0]
    if tuple(coeffs.shape) != (L, B):
        raise ValueError(f"gp_pair_evals: coeffs {tuple(coeffs.shape)}")
    if _all_cpu(l, r, eq, coeffs):
        return gp_pair_evals_plain(spec, l, r, eq, coeffs)
    nat.require_cuda("gp_pair_evals", l, r, eq, coeffs)
    out = None
    for b0, b1 in gp_batch_chunks(B):
        part = _gp_pair_evals_launch(spec, l[b0:b1], r[b0:b1], eq,
                                     coeffs[:, b0:b1])
        out = part if out is None else field_addsub(spec, out, part, ADD)
    return out


def _gp_pair_evals_launch(spec: FieldSpec, l, r, eq, coeffs) -> torch.Tensor:
    """One K2 launch over at most GP_MAX_B circuits."""
    B, h = l.shape[0], l.shape[-1] // 2
    groups, nblocks = gp_evals_plan(B, h)
    partials = torch.empty((nblocks, 3, 8), dtype=torch.int32, device=l.device)
    out = torch.empty((L, 3), dtype=torch.int32, device=l.device)
    GP_PAIR_EVALS.launch(
        nat.ptr(l), nat.ptr(r), nat.ptr(eq), nat.ptr(coeffs),
        nat.ptr(partials), nat.ptr(_gp_counter(l.device)), nat.ptr(out), B, h,
        groups, l.stride(0), l.stride(1), r.stride(0), r.stride(1),
        eq.stride(0), coeffs.stride(0), coeffs.stride(1), nblocks,
        field_words(spec), nat.stream(out), device=out.device)
    return out


# ---------------------------------------------------------------------------
# K3: bind the pair layers and eq to the round challenge
# ---------------------------------------------------------------------------

def _challenge_arg(name: str, r: torch.Tensor, like: torch.Tensor):
    """A challenge [16] for K3 or K15: (8 words by value, null) from a CPU
    tensor, or (zeros, its limbs' address) from one on the card (drawn
    there by K9, read by the kernel with no host sync)."""
    if r.device.type == "cpu":
        limbs = [int(v) for v in r.reshape(L).tolist()]
        return nat.words(limbs[2 * k] | (limbs[2 * k + 1] << 16)
                         for k in range(8)), ctypes.c_void_p(None), r
    nat.require_cuda(name, like, r)
    r = r.reshape(L).contiguous()
    return nat.words([0] * 8), nat.ptr(r), r


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
    eq [16, s].  r_chal: Montgomery limbs [16].  A CPU r_chal goes to the
    kernel by value; a CUDA one (a challenge drawn on the card by device
    Fiat-Shamir) is read by the kernel, with no host sync."""
    _check_pair("gp_pair_bind", l, r, eq)
    if _all_cpu(l, r, eq):
        return gp_pair_bind_plain(spec, l, r, eq, r_chal)
    nat.require_cuda("gp_pair_bind", l, r, eq)
    B, _, s = l.shape
    h = s // 2
    rc, rc_dev, r_chal = _challenge_arg("gp_pair_bind", r_chal, l)
    nl = torch.empty((B, L, h), dtype=torch.int32, device=l.device)
    nr = torch.empty((B, L, h), dtype=torch.int32, device=l.device)
    neq = torch.empty((L, h), dtype=torch.int32, device=l.device)
    GP_PAIR_BIND.launch(
        nat.ptr(l), nat.ptr(r), nat.ptr(eq), nat.ptr(nl), nat.ptr(nr),
        nat.ptr(neq), B, h, l.stride(0), l.stride(1), r.stride(0),
        r.stride(1), eq.stride(0), rc, rc_dev, field_words(spec),
        nat.stream(nl), device=nl.device)
    return nl, nr, neq


# ---------------------------------------------------------------------------
# K10: (a + b), (a - b) or -b mod p over broadcast limb tensors
# ---------------------------------------------------------------------------

ADD, SUB, NEG = 0, 1, 2        # K10's op codes (csrc/field_ops.cu)


def field_addsub_plain(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor,
                       op: int) -> torch.Tensor:
    """field_addsub's function in plain limb arithmetic (arith.py)."""
    if op == NEG:
        return arith.sub(spec, torch.zeros_like(b), b)
    return (arith.add if op == ADD else arith.sub)(spec, a, b)


def field_addsub(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor,
                 op: int) -> torch.Tensor:
    """(a + b) mod p (op ADD), (a - b) mod p (SUB) or (0 - b) mod p (NEG;
    `a` is not read) over broadcast limb tensors [16, *batch], both
    reduced.  On CUDA, views (halves, broadcast scalars) go in with their
    strides, without a copy; the output is contiguous."""
    if _all_cpu(a, b):
        return field_addsub_plain(spec, a, b, op)
    nat.require_cuda("field_addsub", a, b)
    if op == NEG:
        a = b
    shape = a.shape if a.shape == b.shape else arith.bshape(a.shape, b.shape)
    out = torch.empty(shape, dtype=torch.int32, device=b.device)
    n = out.numel() // L
    if n == 0:
        return out
    s = shape[-1] if len(shape) > 1 else 1
    a, a_bs, a_ls, a_es = _operand("field_addsub", a, shape, n)
    b, b_bs, b_ls, b_es = _operand("field_addsub", b, shape, n)
    FIELD_ADDSUB.launch(nat.ptr(a), nat.ptr(b), nat.ptr(out), n // s, s,
                        a_bs, a_ls, a_es, b_bs, b_ls, b_es, op,
                        field_words(spec), nat.stream(out),
                        device=out.device)
    return out


# ---------------------------------------------------------------------------
# K11: the modular sum along one logical axis
# ---------------------------------------------------------------------------

SUM_THREADS = 256              # K11's block (csrc/field_ops.cu)
SUM_MIN_BLOCKS = 2             # K11 blocks per SM (its launch bounds there)
SUM_WAVE = H100_SMS * SUM_MIN_BLOCKS   # blocks of one resident wave: a
#   tile's terms are cut into segments until about this many exist
SUM_MIN_TERMS = 8              # terms a thread at least, where a tile's
#   terms are cut
SUM_VEC_MIN = 128              # terms of a row from which K11 loads four
#   at once: below it a warp's lanes hold a few terms each, and the
#   quads' longer add chains cost more than they save


class SumPlan(NamedTuple):
    """K11's cut of `rows` sums of n terms (csrc/field_ops.cu)."""
    across: bool   # lanes across 32 rows, the 8 warps along the terms
    tpr: int       # threads of a row: 32-256 along the rows, 8 across
    vec: bool      # a thread loads 4 terms of a limb at once
    chunk: int     # terms of a segment (a multiple of 4 with vec)
    chunks: int    # segments of a tile
    tiles: int     # tiles of SUM_THREADS // tpr rows
    blocks: int    # the grid: one wave at most, walked by grid stride


def field_sum_plain(spec: FieldSpec, a: torch.Tensor, axis: int
                    ) -> torch.Tensor:
    return arith.sum_limbs(spec, a, axis)


def sum_plan(rows: int, n: int, across: bool, vec: bool) -> SumPlan:
    """K11's cut.  Along the rows a row gets about n / 4 threads, a power
    of two from 32 (a warp) to SUM_THREADS; across them a tile is 32
    rows, a lane each, and 8 warps.  While fewer than SUM_WAVE tiles
    exist, a tile's terms are cut into segments of at least
    SUM_MIN_TERMS terms a thread, until about SUM_WAVE segments exist.
    Four terms a load (`vec`, where the layout allows it) from
    SUM_VEC_MIN terms a row."""
    vec = vec and n >= SUM_VEC_MIN
    if across:
        tpr = SUM_THREADS // 32
    else:
        tpr = min(SUM_THREADS, max(32, 1 << (-(-n // 4) - 1).bit_length()))
    tiles = -(-rows // (SUM_THREADS // tpr))
    chunks = max(1, min(-(-SUM_WAVE // tiles),
                        -(-n // (SUM_MIN_TERMS * tpr))))
    chunk = -(-n // chunks)
    if vec:
        chunk = -(-chunk // 4) * 4
    chunks = -(-n // chunk)
    return SumPlan(across, tpr, vec, chunk, chunks, tiles,
                   min(SUM_WAVE, tiles * chunks))


_SUM_SCRATCH: dict[tuple[torch.device, int], list[torch.Tensor]] = {}


def sum_scratch(like: torch.Tensor, rows: int, chunks: int):
    """K11's partial sums and per-tile tickets (the round kernel's
    partials and ticket: one row, a chunk per (point, tile)) on `like`'s
    device, as kernel arguments (partials, counters); null pointers where
    one chunk a row needs neither.  Both are kept per stream, as K2's
    ticket: a stream runs its launches in order, so the next launch finds
    the counters back at 0 (the last block of a tile resets its own) and
    may reuse the partials.  The counters are SUM_WAVE words: sum_plan
    cuts a tile's terms only while fewer tiles exist.  The partials grow
    to the largest call's rows x chunks x 8 words."""
    if chunks == 1:
        return None, None
    key = (like.device, nat.stream(like))
    if key not in _SUM_SCRATCH:
        _SUM_SCRATCH[key] = [torch.zeros(SUM_WAVE, dtype=torch.int32,
                                         device=like.device), like.new_empty(0)]
    counters, partials = _SUM_SCRATCH[key]
    need = rows * chunks * 8
    if partials.numel() < need:
        partials = like.new_empty(max(need, 2 * partials.numel()))
        _SUM_SCRATCH[key][1] = partials
    return nat.ptr(partials), nat.ptr(counters)


def sum_view(a: torch.Tensor, ax: int):
    """K11's operand: a [16, ...] tensor with the summed (tensor) axis `ax`
    moved last, as a view where its other axes flatten to one row stride
    (else a contiguous copy): (view, rows, n, rs, ls, es)."""
    v = a if ax == a.dim() - 1 else a.movedim(ax, -1)   # [16, *rest, n]
    n = v.shape[-1]
    rows = v.numel() // (L * n)
    st = None if v.is_contiguous() else _strides2d(v, v.shape)
    if st is None:
        v = v.contiguous()
        st = (n, rows * n, int(n > 1))
    return (v, rows, n, *st)


def sum_vec(v: torch.Tensor, rows: int, rs: int, ls: int, es: int,
            across: bool) -> bool:
    """Whether K11 loads four terms of a limb at once: rows of unit
    stride along the rows, every row and limb at a 16-byte boundary."""
    return (not across and es == 1 and ls % 4 == 0
            and (rows == 1 or rs % 4 == 0) and v.data_ptr() % 16 == 0)


def field_sum(spec: FieldSpec, a: torch.Tensor, axis: int) -> torch.Tensor:
    """Modular sum of a limb tensor [16, ...] along logical axis `axis`:
    one K11 launch on CUDA, whatever the length."""
    if a.device.type == "cpu":
        return field_sum_plain(spec, a, axis)
    nat.require_cuda("field_sum", a)
    ax = axis + 1 if axis >= 0 else axis + a.dim()
    if not 1 <= ax < a.dim() or a.shape[0] != L:
        raise ValueError(f"field_sum: axis {axis} of {tuple(a.shape)}")
    rest = a.shape[1:ax] + a.shape[ax + 1:]
    if a.numel() == 0:
        return torch.zeros((L,) + rest, dtype=torch.int32, device=a.device)
    v, rows, n, rs, ls, es = sum_view(a, ax)
    across = rows >= 32 and es != 1
    plan = sum_plan(rows, n, across, sum_vec(v, rows, rs, ls, es, across))
    out = torch.empty((L, rows), dtype=torch.int32, device=a.device)
    partials, counters = sum_scratch(a, rows, plan.chunks)
    FIELD_SUM.launch(nat.ptr(v), nat.ptr(out), rows, n, rs, ls, es,
                     plan.tpr, int(plan.across), int(plan.vec), plan.chunk,
                     plan.chunks, plan.blocks, partials, counters,
                     field_words(spec), nat.stream(out), device=out.device)
    return out.reshape((L,) + rest)


# ---------------------------------------------------------------------------
# K14-K17: the toggled grand product's round, the opening reduction's round
# and its RLC (csrc/sumcheck_ops.cu)
# ---------------------------------------------------------------------------

TOGGLE_WARPS = 8               # warps of a K14 block
TOGGLE_MIN_BLOCKS = 2          # K14 blocks an SM (its launch bounds)
TOGGLE_MAX_M = 128             # memories a K14 launch; more are split
TOGGLE_WAVE = H100_SMS * TOGGLE_MIN_BLOCKS   # K14's grid at most
OPS_THREADS = 256              # K15, K16, K17 blocks
REDUCE_MIN_BLOCKS = 2          # K16 blocks an SM (its launch bounds)
REDUCE_WAVE = H100_SMS * REDUCE_MIN_BLOCKS   # K16's grid at most
BIND_MAX = 32                  # tensors a K15 launch
REDUCE_MAX_PAIRS = 16          # pairs a K16 launch
RLC_MAX = 48                   # polynomials a K17 launch


def host_limbs(spec: FieldSpec, values) -> torch.Tensor:
    """Host ints -> Montgomery limbs [16, k] int32 on the CPU, converted
    on the host (no tensor op): the coefficients and constants that K16
    and K17 take by value."""
    buf = b"".join(spec.to_mont(int(v) % spec.p).to_bytes(32, "little")
                   for v in values)
    limbs = np.frombuffer(buf, dtype="<u2").reshape(-1, L).T
    return torch.from_numpy(limbs.astype(np.int32))


def _words_by_value(name: str, limbs: torch.Tensor) -> ctypes.Array:
    """Montgomery limbs [16, k] on the CPU -> 8 words per element, in
    order, for a kernel argument."""
    if limbs.device.type != "cpu":
        raise ValueError(f"{name}: coefficients go by value: pass them as "
                         "CPU limbs (host_limbs)")
    v = limbs.reshape(L, -1).numpy().astype(np.uint32)
    return nat.words((v[0::2] | (v[1::2] << 16)).T.reshape(-1))


def _i64s(values) -> ctypes.Array:
    vals = [int(v) for v in values]
    return (ctypes.c_int64 * len(vals))(*vals)


def toggle_evals_plain(spec: FieldSpec, flags, fps, eq, coeffs
                       ) -> torch.Tensor:
    """jolt_tpu/subprotocols/grand_product.py:976-1014, term for term."""
    f2 = flags.repeat_interleave(2, dim=1)
    h = f2.shape[-1] // 2
    one = arith.const_limbs(spec, "r", f2.device).reshape(L, 1, 1)
    f0, f1 = f2[..., :h], f2[..., h:]
    p0, p1 = fps[..., :h], fps[..., h:]
    e0, e1 = eq[..., :h], eq[..., h:]
    m_f, m_p, m_e = (arith.sub(spec, f1, f0), arith.sub(spec, p1, p0),
                     arith.sub(spec, e1, e0))
    cb = coeffs.to(f2.device)[:, :, None]
    out = []
    ft, pt, et = f0, p0, e0
    for t in (0, 2, 3):
        if t == 2:
            ft, pt, et = (arith.add(spec, f1, m_f), arith.add(spec, p1, m_p),
                          arith.add(spec, e1, m_e))
        elif t == 3:
            ft, pt, et = (arith.add(spec, ft, m_f), arith.add(spec, pt, m_p),
                          arith.add(spec, et, m_e))
        gate = arith.add(spec, arith.mont_mul(spec, ft, pt),
                         arith.sub(spec, one, ft))
        per_i = arith.sum_limbs(spec, arith.mont_mul(spec, cb, gate), 0)
        out.append(arith.sum_limbs(spec, arith.mont_mul(spec, et, per_i),
                                   -1))
    return torch.stack(out, dim=1)


def toggle_plan(m: int, h: int) -> tuple[int, int]:
    """K14's launch geometry for m memories and h pair indices: (groups,
    blocks).  A warp task is a tile of 32 pair indices and a group of the
    memories (j = g, g + groups, ...); groups is the most whose tasks fit
    one wave of warps (TOGGLE_WAVE blocks of TOGGLE_WARPS), at most m,
    evened so that the groups' memories differ by at most one.  The
    blocks walk the tasks by grid stride, one wave at most."""
    if not 1 <= m <= TOGGLE_MAX_M or h < 1:
        raise ValueError(f"toggle_plan: m = {m}, h = {h}")
    tiles = -(-h // 32)
    groups = max(1, min(m, TOGGLE_WAVE * TOGGLE_WARPS // tiles))
    groups = -(-m // -(-m // groups))
    return groups, min(-(-tiles * groups // TOGGLE_WARPS), TOGGLE_WAVE)


def toggle_chunks(m: int) -> list[tuple[int, int]]:
    """K14's launches for m memories: [j0, j1) slices of at most
    TOGGLE_MAX_M.  The evaluations are linear in the memories (each
    slice's launch adds its own coefficients' sum), so their sum mod p
    over the slices is the whole round's."""
    return [(j0, min(j0 + TOGGLE_MAX_M, m))
            for j0 in range(0, m, TOGGLE_MAX_M)]


def _last_axis_unit(name: str, *ts: torch.Tensor) -> None:
    for t in ts:
        if t.shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError(f"{name}: the last axis must be contiguous, "
                             f"got strides {t.stride()}")


def toggle_evals(spec: FieldSpec, flags: torch.Tensor, fps: torch.Tensor,
                 eq: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """The toggle round's evaluations at t = 0, 2, 3 -> [16, 3]:
    sum_i eq_t(i) sum_b c_b (f_t(b // 2, i) p_t(b, i) + 1 - f_t(b // 2, i))
    over bit-reversed flags [16, m, s], fingerprints [16, 2m, s], eq
    [16, s] (sibling pairs the contiguous halves) and coeffs [16, 2m].
    One K14 launch a `toggle_chunks` slice on CUDA tensors."""
    m, s = flags.shape[1], flags.shape[-1]
    if (flags.dim() != 3 or tuple(fps.shape) != (L, 2 * m, s)
            or tuple(eq.shape) != (L, s) or tuple(coeffs.shape) != (L, 2 * m)
            or flags.shape[0] != L or s < 2 or s % 2):
        raise ValueError("toggle_evals: expected flags [16, m, s], "
                         "fingerprints [16, 2m, s], eq [16, s], coeffs "
                         f"[16, 2m], s even; got {tuple(flags.shape)}, "
                         f"{tuple(fps.shape)}, {tuple(eq.shape)}, "
                         f"{tuple(coeffs.shape)}")
    if _all_cpu(flags, fps, eq, coeffs):
        return toggle_evals_plain(spec, flags, fps, eq, coeffs)
    nat.require_cuda("toggle_evals", flags, fps, eq, coeffs)
    _last_axis_unit("toggle_evals", flags, fps, eq)
    out = None
    for j0, j1 in toggle_chunks(m):
        part = _toggle_launch(spec, flags[:, j0:j1], fps[:, 2 * j0:2 * j1],
                              eq, coeffs[:, 2 * j0:2 * j1])
        out = part if out is None else field_addsub(spec, out, part, ADD)
    return out


def _toggle_launch(spec: FieldSpec, flags, fps, eq, coeffs) -> torch.Tensor:
    """One K14 launch over at most TOGGLE_MAX_M memories."""
    m, h = flags.shape[1], flags.shape[-1] // 2
    groups, blocks = toggle_plan(m, h)
    partials = torch.empty((blocks, 3, 8), dtype=torch.int32,
                           device=flags.device)
    out = torch.empty((L, 3), dtype=torch.int32, device=flags.device)
    strides = _i64s((flags.stride(0), flags.stride(1), fps.stride(0),
                     fps.stride(1), eq.stride(0), coeffs.stride(0),
                     coeffs.stride(1)))
    TOGGLE_EVALS.launch(
        nat.ptr(flags), nat.ptr(fps), nat.ptr(eq), nat.ptr(coeffs), strides,
        m, h, groups, blocks, nat.ptr(partials),
        nat.ptr(_gp_counter(flags.device)), nat.ptr(out), field_words(spec),
        nat.stream(out), device=out.device)
    return out


def bind_halves_plain(spec: FieldSpec, tensors, r: torch.Tensor) -> list:
    """jolt_tpu/subprotocols/grand_product.py:1017-1026 (and poly/mle.py
    bind_top, the reduction's binds): lo + r (hi - lo) on each tensor's
    halves."""
    out = []
    for t in tensors:
        h = t.shape[-1] // 2
        lo, hi = t[..., :h], t[..., h:]
        rb = r.reshape((L,) + (1,) * (t.dim() - 1)).to(t.device)
        out.append(arith.add(spec, lo, arith.mont_mul(
            spec, rb, arith.sub(spec, hi, lo))))
    return out


def bind_halves(spec: FieldSpec, tensors, r: torch.Tensor) -> list:
    """Bind the top variable of each limb tensor [16, ..., n] (n even) to
    r: new contiguous [16, ..., n/2] = lo + r (hi - lo) on the halves,
    never in place.  r: Montgomery limbs [16], on the CPU (by value) or on
    the card (read by the kernel with no host sync).  One K15 launch for
    up to BIND_MAX tensors on CUDA; a longer list takes a launch per
    BIND_MAX."""
    tensors = list(tensors)
    for t in tensors:
        if t.dim() < 2 or t.shape[0] != L or t.shape[-1] < 2 \
                or t.shape[-1] % 2:
            raise ValueError(f"bind_halves: expected [16, ..., n], n even, "
                             f"got {tuple(t.shape)}")
    if _all_cpu(*tensors):
        return bind_halves_plain(spec, tensors, r)
    nat.require_cuda("bind_halves", *tensors)
    rc, rc_dev, r = _challenge_arg("bind_halves", r, tensors[0])
    outs, views = [], []
    for t in tensors:
        st = _strides2d(t, t.shape)
        if st is None:
            t = t.contiguous()
            st = _strides2d(t, t.shape)
        n = t.shape[-1]
        rows = t.numel() // (L * n)
        outs.append(torch.empty(t.shape[:-1] + (n // 2,), dtype=torch.int32,
                                device=t.device))
        views.append((t, rows, n // 2, *st))
    for k0 in range(0, len(views), BIND_MAX):
        part = views[k0:k0 + BIND_MAX]
        dst = outs[k0:k0 + BIND_MAX]
        BIND_HALVES.launch(
            _i64s(nat.ptr(v[0]) for v in part), _i64s(map(nat.ptr, dst)),
            _i64s(v[4] for v in part), _i64s(v[3] for v in part),
            _i64s(v[5] for v in part), _i64s(v[1] for v in part),
            _i64s(v[2] for v in part), len(part), rc, rc_dev,
            field_words(spec), nat.stream(dst[0]), device=dst[0].device)
    return outs


def quadratic_evals_plain(spec: FieldSpec, poly, eq) -> torch.Tensor:
    """jolt_tpu/poly/opening_proof.py:144-154: (eval_0, eval_2) of
    sum_x P(t, x) eq(t, x) -> [16, 2]."""
    n = poly.shape[-1]
    p_lo, p_hi = poly[..., : n // 2], poly[..., n // 2:]
    e_lo, e_hi = eq[..., : n // 2], eq[..., n // 2:]
    ev0 = arith.sum_limbs(spec, arith.mont_mul(spec, p_lo, e_lo), -1)
    p2 = arith.add(spec, p_hi, arith.sub(spec, p_hi, p_lo))
    e2 = arith.add(spec, e_hi, arith.sub(spec, e_hi, e_lo))
    ev2 = arith.sum_limbs(spec, arith.mont_mul(spec, p2, e2), -1)
    return torch.stack([ev0, ev2], dim=1)


def reduction_evals_plain(spec: FieldSpec, polys, eqs, coeffs, k
                          ) -> torch.Tensor:
    """jolt_tpu/poly/opening_proof.py:56-67, term for term: from k, each
    pair's quadratic evaluations times its coefficient added."""
    dev = polys[0].device
    ev0 = ev2 = k.reshape(L).to(dev)
    for a, (p, q) in enumerate(zip(polys, eqs)):
        pair = quadratic_evals_plain(spec, p, q)
        c = coeffs[:, a].to(dev)
        ev0 = arith.add(spec, ev0, arith.mont_mul(spec, c, pair[:, 0]))
        ev2 = arith.add(spec, ev2, arith.mont_mul(spec, c, pair[:, 1]))
    return torch.stack([ev0, ev2], dim=1)


def reduction_plan(h: int) -> int:
    """K16's blocks for pairs of 2h entries: a thread a pair index (and
    grid stride past one resident wave)."""
    if h < 1:
        raise ValueError(f"reduction_plan: h = {h}")
    return min(-(-h // OPS_THREADS), REDUCE_WAVE)


def reduction_evals(spec: FieldSpec, polys, eqs, coeffs: torch.Tensor,
                    k: torch.Tensor) -> torch.Tensor:
    """The opening reduction's round over A active pairs (P_a, eq_a), all
    [16, n] (n = 2^remaining, even): [16, 2] = (k + sum_a c_a sum_x
    P_a(0, x) eq_a(0, x), k + sum_a c_a sum_x P_a(2, x) eq_a(2, x)).
    coeffs [16, A] and k [16]: Montgomery limbs on the CPU (host_limbs),
    passed by value.  One K16 launch per REDUCE_MAX_PAIRS pairs on CUDA
    (the launches' outputs added mod p, k in the first)."""
    polys, eqs = list(polys), list(eqs)
    A = len(polys)
    if A < 1 or len(eqs) != A or tuple(coeffs.shape) != (L, A):
        raise ValueError(f"reduction_evals: {A} polynomials, {len(eqs)} eq "
                         f"tables, coeffs {tuple(coeffs.shape)}")
    n = polys[0].shape[-1]
    for t in polys + eqs:
        if tuple(t.shape) != (L, n):
            raise ValueError("reduction_evals: every pair must be [16, n] "
                             f"of one length n = {n}, got {tuple(t.shape)}")
    if n < 2 or n % 2:
        raise ValueError(f"reduction_evals: length {n} must be even")
    if _all_cpu(*polys, *eqs):
        return reduction_evals_plain(spec, polys, eqs, coeffs, k)
    nat.require_cuda("reduction_evals", *polys, *eqs)
    _last_axis_unit("reduction_evals", *polys, *eqs)
    cw = _words_by_value("reduction_evals", coeffs)
    kw = _words_by_value("reduction_evals", k.reshape(L, 1))
    dev, h = polys[0].device, n // 2
    blocks = reduction_plan(h)
    out = None
    for q0 in range(0, A, REDUCE_MAX_PAIRS):
        q1 = min(q0 + REDUCE_MAX_PAIRS, A)
        part = torch.empty((L, 2), dtype=torch.int32, device=dev)
        partials = torch.empty((blocks, 2, 8), dtype=torch.int32, device=dev)
        REDUCTION_EVALS.launch(
            _i64s(map(nat.ptr, polys[q0:q1])), _i64s(map(nat.ptr, eqs[q0:q1])),
            _i64s(t.stride(0) for t in polys[q0:q1]),
            _i64s(t.stride(0) for t in eqs[q0:q1]),
            nat.words(cw[8 * q0:8 * q1]), q1 - q0, h,
            kw if q0 == 0 else nat.words([0] * 8), blocks, nat.ptr(partials),
            nat.ptr(_gp_counter(dev)), nat.ptr(part), field_words(spec),
            nat.stream(part), device=dev)
        out = part if out is None else field_addsub(spec, out, part, ADD)
    return out


def rlc_plain(spec: FieldSpec, polys, coeffs, n: int) -> torch.Tensor:
    """jolt_tpu/poly/opening_proof.py:30-52, term for term: each
    polynomial zero-padded at the tail to n, then sum_i c_i P_i."""
    out = None
    for i, p in enumerate(polys):
        if p.shape[-1] < n:
            p = torch.cat([p, p.new_zeros((L, n - p.shape[-1]))], dim=1)
        term = arith.mont_mul(spec, coeffs[:, i:i + 1].to(p.device), p)
        out = term if out is None else arith.add(spec, out, term)
    return out


def rlc(spec: FieldSpec, polys, coeffs: torch.Tensor, n: int
        ) -> torch.Tensor:
    """sum_i c_i P_i over [16, n], each P_i [16, n_i] (n_i <= n) read as
    zero past n_i; views with a contiguous last axis (a column of
    [16, k, T]) are read in place.  coeffs [16, len(polys)]: Montgomery
    limbs on the CPU (host_limbs), passed by value.  One K17 launch per
    RLC_MAX polynomials on CUDA, each after the first adding its sum into
    the output."""
    polys = list(polys)
    if not polys or tuple(coeffs.shape) != (L, len(polys)):
        raise ValueError(f"rlc: {len(polys)} polynomials, coeffs "
                         f"{tuple(coeffs.shape)}")
    for p in polys:
        if p.dim() != 2 or p.shape[0] != L or not 1 <= p.shape[-1] <= n:
            raise ValueError(f"rlc: expected [16, n_i] with n_i <= {n}, got "
                             f"{tuple(p.shape)}")
    if _all_cpu(*polys):
        return rlc_plain(spec, polys, coeffs, n)
    nat.require_cuda("rlc", *polys)
    _last_axis_unit("rlc", *polys)
    cw = _words_by_value("rlc", coeffs)
    out = torch.empty((L, n), dtype=torch.int32, device=polys[0].device)
    prev = ctypes.c_void_p(None)
    for i0 in range(0, len(polys), RLC_MAX):
        part = polys[i0:i0 + RLC_MAX]
        RLC.launch(_i64s(map(nat.ptr, part)), _i64s(p.stride(0) for p in part),
                   _i64s(p.shape[-1] for p in part),
                   nat.words(cw[8 * i0:8 * (i0 + len(part))]), len(part), n,
                   prev, nat.ptr(out), field_words(spec), nat.stream(out),
                   device=out.device)
        prev = nat.ptr(out)
    return out
