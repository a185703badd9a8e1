"""Field kernels: Montgomery products (K1, K4), the GKR pair round (K2,
K3), and the modular add, subtract and sum (K10, K11).

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

(paths under jolt_tpu/; the primary sumcheck's round, with its
collations and finisher, is vm/instruction_lookups.py's `primary_round`,
csrc/collate.cu.)
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

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
    rc_dev = ctypes.c_void_p(None)
    if r_chal.device.type == "cpu":
        limbs = [int(v) for v in r_chal.reshape(L).tolist()]
        rc = nat.words(limbs[2 * k] | (limbs[2 * k + 1] << 16)
                       for k in range(8))
    else:
        nat.require_cuda("gp_pair_bind", l, r_chal)
        r_chal = r_chal.reshape(L).contiguous()
        rc, rc_dev = nat.words([0] * 8), nat.ptr(r_chal)
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
