"""Multilinear extensions (MLEs) as device limb tensors.

A (batch of) MLE(s) in evaluation form is an int32 limb tensor
``[16, ..., n]`` with the hypercube on the LAST axis, n = 2^num_vars, index
bits big-endian (first/bound-first variable = most significant bit) -- the
reference's DensePolynomial / EqPolynomial convention
(jolt-core/src/poly/dense_mlpoly.rs, eq_poly.rs:25-77).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..field import device as fd
from ..field.host import FElt
from ..field.spec import FieldSpec, fr_spec


def bind_top(spec: FieldSpec, z: torch.Tensor, r: torch.Tensor
             ) -> torch.Tensor:
    """Bind the top (most-significant) variable to r (limb vector [16]).

    z: [16, ..., n] -> [16, ..., n/2]:  out[i] = lo[i] + r * (hi[i] - lo[i])
    (dense_mlpoly.rs:74-139)."""
    n = z.shape[-1]
    lo, hi = z[..., : n // 2], z[..., n // 2:]
    rb = r.reshape((fd.L,) + (1,) * (z.dim() - 1))
    return fd.fadd(spec, lo, fd.fmul(spec, rb, fd.fsub(spec, hi, lo)))


def bind_bot(spec: FieldSpec, z: torch.Tensor, r: torch.Tensor
             ) -> torch.Tensor:
    """Bind the bottom (least-significant) variable to r:
    out[i] = z[2i] + r * (z[2i+1] - z[2i])  (dense_mlpoly.rs:206-236)."""
    lo, hi = z[..., 0::2], z[..., 1::2]
    rb = r.reshape((fd.L,) + (1,) * (z.dim() - 1))
    return fd.fadd(spec, lo, fd.fmul(spec, rb, fd.fsub(spec, hi, lo)))


def _stack_point(spec: FieldSpec, r, device) -> torch.Tensor:
    """Challenge point (host FElts or ints) -> Montgomery limbs [16, k]:
    one upload and one conversion for the whole point."""
    vals = [x.v if isinstance(x, FElt) else int(x) % spec.p for x in r]
    return fd.ints_to_device(spec, vals, device)


def eq_evals_device(spec: FieldSpec, r, device) -> torch.Tensor:
    """eq(r, x) over the 2^ell hypercube, index bits big-endian w.r.t. r
    (eq_poly.rs:34-49 doubling DP)."""
    table = fd.ones(spec, (1,), device)
    if not r:
        return table
    rs = _stack_point(spec, r, device)
    for j in range(rs.shape[1]):
        hi = fd.fmul(spec, table, rs[:, j:j + 1])
        lo = fd.fsub(spec, table, hi)
        # interleave: new[2i] = lo[i], new[2i+1] = hi[i]
        table = torch.stack([lo, hi], dim=-1).reshape(fd.L, -1)
    return table


def eq_evals_device_br(spec: FieldSpec, r, device) -> torch.Tensor:
    """eq(r, x) in BIT-REVERSED index order: out[p] = eq_evals[rev(p)].

    Each new variable extends the table by concatenation instead of
    interleaving; the grand-product prover keeps its layers bit-reversed so
    that every bind is a contiguous half-split."""
    table = fd.ones(spec, (1,), device)
    if not r:
        return table
    rs = _stack_point(spec, r, device)
    for j in range(rs.shape[1]):
        hi = fd.fmul(spec, table, rs[:, j:j + 1])
        lo = fd.fsub(spec, table, hi)
        table = torch.cat([lo, hi], dim=-1)
    return table


def bitrev_indices(n: int) -> np.ndarray:
    """Permutation p with p[pos] = bit-reverse(pos) over log2(n) bits."""
    k = n.bit_length() - 1
    assert 1 << k == n, "power of two required"
    idx = np.arange(n, dtype=np.int64)
    out = np.zeros(n, dtype=np.int64)
    for _ in range(k):
        out = (out << 1) | (idx & 1)
        idx >>= 1
    return out


def evaluate_many_host(spec: FieldSpec, polys, eq_table: torch.Tensor
                       ) -> list[FElt]:
    """Evaluate many same-length MLEs at one point (given its eq table):
    one stacked inner product and one pull."""
    stacked = torch.stack(list(polys), dim=1)              # [16, P, n]
    vals = fd.fsum(spec, fd.fmul(spec, stacked, eq_table[:, None, :]),
                   axis=-1)                                # [16, P]
    return [FElt(int(v), spec) for v in fd.device_to_ints(spec, vals).tolist()]


def evaluate_device(spec: FieldSpec, z: torch.Tensor, eq_table: torch.Tensor
                    ) -> torch.Tensor:
    """<Z, eq(r, .)> -> limb vector [16] (dense_mlpoly.rs:238-253)."""
    eq = eq_table.reshape((fd.L,) + (1,) * (z.dim() - 2) + eq_table.shape[-1:])
    out = fd.fmul(spec, z, eq)
    while out.dim() > 1:
        out = fd.fsum(spec, out, axis=out.dim() - 2)       # logical last axis
    return out


# ---------------------------------------------------------------------------
# host-side reference MLE (verifier + tests)
# ---------------------------------------------------------------------------

def eq_evals_host(r: Sequence[FElt]) -> list[FElt]:
    spec = r[0].spec if r else fr_spec()
    table = [FElt(1, spec)]
    for rj in r:
        nxt = []
        for x in table:
            hi = x * rj
            nxt.append(x - hi)
            nxt.append(hi)
        table = nxt
    return table


def eq_evaluate_host(r: Sequence[FElt], x: Sequence[FElt]) -> FElt:
    assert len(r) == len(x)
    spec = r[0].spec if r else fr_spec()
    out = FElt(1, spec)
    for a, b in zip(r, x):
        out = out * (a * b + (FElt(1, spec) - a) * (FElt(1, spec) - b))
    return out


def evaluate_host(z: Sequence[FElt], r: Sequence[FElt]) -> FElt:
    chis = eq_evals_host(list(r))
    assert len(chis) == len(z)
    spec = r[0].spec if r else fr_spec()
    acc = FElt(0, spec)
    for zi, ci in zip(z, chis):
        acc = acc + zi * ci
    return acc


def mle_from_ints(spec: FieldSpec, values, device, shape=None) -> torch.Tensor:
    return fd.ints_to_device(spec, values, device, shape)


def mle_to_felts(spec: FieldSpec, z: torch.Tensor) -> np.ndarray:
    ints = fd.device_to_ints(spec, z)
    out = np.empty(ints.shape, dtype=object)
    for idx, v in np.ndenumerate(ints):
        out[idx] = FElt(int(v), spec)
    return out
