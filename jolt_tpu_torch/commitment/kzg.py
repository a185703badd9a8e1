"""Univariate KZG over BN254 (reference: poly/commitment/kzg.rs,
jolt_tpu/commitment/kzg.py): the SRS, the batch commit, openings and the
pairing check.

* The SRS is g * tau^i for a tau drawn from a deterministic seed, kept in
  Jacobian form [16, N] per coordinate.  `srs_setup` reads the committed
  `fixtures/srs/srs_<n>_<seed>.npz` (`utils/caches.py` `srs_cache_dir`;
  JOLT_TPU_SRS_CACHE_DIR overrides) when one of at least n points exists
  (any prefix of a larger SRS is the smaller SRS) and otherwise generates
  the points on the device: powers of tau, then a fixed-base windowed table
  gather and a log-depth tree of Jacobian adds (K6).  It never writes into
  `fixtures/`.
* commit = the bitplane batch MSM over the SRS prefix (curve/device.py).
  A grand product's leaves are mostly ones, so their commit is the sum of
  the first n SRS points (`KZGProverKey.g_products`, a tree of Jacobian
  adds, K6) plus the MSM of the residual coeffs - 1 (kzg.rs:223-256): the
  same point as the plain commit.
* open(B, u): the quotient q = (B - B(u)) / (X - u) without a sequential
  synthetic division: q[j] = u^{-(j+1)} * sum_{i > j} b_i u^i, two power
  tables and one suffix sum on the device.
* verify: host pairing check e(C - v*g + u*W, g2) == e(W, beta_g2).
"""
from __future__ import annotations

import functools
import random
import re
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from ..curve import device as cd
from ..curve.bn254 import G1Affine, G1Jacobian, G2Affine
from ..curve.pairing import pairing_product_is_one
from ..field import device as fd
from ..field.host import FElt
from ..field.spec import FieldSpec, fr_spec
from ..parallel import sharding as sh
from ..utils import caches

FR = fr_spec()
SRS_SEED = 0x6A6F6C74
SRS_CHUNK = 1 << 18   # points per generation pass (bounds [16, 32, chunk])


@dataclass
class KZGProverKey:
    g1_jac: tuple  # (X, Y, Z) device limb tensors [16, N] -- g * tau^i
    n: int
    _g_products: list | None = field(default=None, repr=False)

    def g_products(self) -> list[G1Jacobian]:
        """[sum(g1[:2^k]) for k in 0..log2(N)], the commitments of the
        all-ones vectors (kzg.rs:66-77), built at the first call from the
        whole key, as jolt_tpu builds them (kzg.py:41-48)."""
        if self._g_products is None:
            self._g_products = _compute_g_products(self.g1_jac, self.n)
        return self._g_products


@dataclass
class KZGVerifierKey:
    g1: G1Affine
    g2: G2Affine
    beta_g2: G2Affine  # g2 * tau


def verifier_key(seed: int = SRS_SEED) -> KZGVerifierKey:
    """The verifier key of the SRS drawn from `seed` (host G2 math)."""
    g2 = G2Affine.generator()
    return KZGVerifierKey(G1Affine.generator(), g2, g2.mul(srs_tau(seed)))


@functools.cache
def _fixed_base_table(base: G1Affine, c: int = 8, windows: int = 32):
    """Host table T[w][d] = base * (d << (c*w)); [windows, 2^c] affine.
    Kept once computed (8,192 host adds and inverses, about half a second):
    every SRS and every set of Pedersen generators reads the generator's."""
    table = []
    cur_base = base.to_jacobian()
    for _ in range(windows):
        row = [G1Jacobian.identity()]
        for _ in range(1, 1 << c):
            row.append(row[-1].add(cur_base))
        table.append([p.to_affine() for p in row])
        for _ in range(c):
            cur_base = cur_base.double()
    return table


def _srs_points(tx, ty, tinf, digits):
    """Gather fixed-base table entries and tree-sum the 32 windows.

    tx/ty: [16, W, 2^c] table coords; tinf: bool [W, 2^c]; digits: int64
    [W, N].  Returns Jacobian (X, Y, Z) [16, N]; window w is added to
    window w + W/2 at each level, as in jolt_tpu (kzg.py:73-92)."""
    W, N = digits.shape
    idx = digits[None].expand(fd.L, W, N)
    gx = torch.gather(tx, 2, idx).contiguous()           # [16, W, N]
    gy = torch.gather(ty, 2, idx).contiguous()
    ginf = torch.gather(tinf, 1, digits)                 # [W, N]
    one = fd.ones(cd.FQ, (W, N), digits.device)
    gz = torch.where(ginf[None], 0, one).contiguous()
    P = (gx, gy, gz)
    w = W
    while w > 1:
        half = w // 2
        P = cd.jac_add(tuple(t[:, :half] for t in P),
                       tuple(t[:, half:2 * half] for t in P))
        w = half
    return tuple(t[:, 0] for t in P)


def srs_tau(seed: int = SRS_SEED) -> int:
    return random.Random(seed).randrange(1, FR.p)


def srs_generate(n: int, device, seed: int = SRS_SEED):
    """The first n SRS points g * tau^i, generated on `device`.

    The host computes the first min(n, 2^16) powers of tau; every further
    chunk is the previous one times tau^chunk on the device (K1)."""
    tau = srs_tau(seed)
    C = min(n, 1 << 16)
    powers, acc = [], 1
    for _ in range(C):
        powers.append(acc)
        acc = acc * tau % FR.p
    chunk = fd.to_mont_device(
        FR, torch.from_numpy(fd.pack_ints(powers).astype(np.int32)).to(device))
    chunks = [chunk]
    if n > C:
        step = fd.scalar_to_device(FR, pow(tau, C, FR.p), device)[:, None]
        for _ in range(-(-n // C) - 1):
            chunk = fd.fmul(FR, chunk, step)
            chunks.append(chunk)
    return fixed_base_points(
        fd.from_mont_device(FR, torch.cat(chunks, dim=1)[:, :n]))


def fixed_base_points(canon: torch.Tensor):
    """g * k for canonical scalar limbs k [16, n] (k < 2^256), on their
    device: the 32 byte-windows of each k gather entries of a host table
    of g * (d << 8w), and a tree of Jacobian adds (K6) sums them.  Returns
    Jacobian (X, Y, Z) [16, n]."""
    device, n = canon.device, canon.shape[1]
    table = _fixed_base_table(G1Affine.generator())
    tx = fd.ints_to_device(cd.FQ, [[p.x for p in row] for row in table],
                           device)
    ty = fd.ints_to_device(cd.FQ, [[p.y for p in row] for row in table],
                           device)
    tinf = torch.tensor([[p.is_infinity for p in row] for row in table],
                        device=device)
    digits = torch.stack([(canon[w // 2] >> (8 * (w % 2))) & 0xFF
                          for w in range(32)]).long()      # [32, n]
    parts = [_srs_points(tx, ty, tinf, digits[:, off:off + SRS_CHUNK])
             for off in range(0, n, SRS_CHUNK)]
    return tuple(torch.cat([p[i] for p in parts], dim=1) for i in range(3))


def fixture_path(n: int, seed: int = SRS_SEED) -> Path | None:
    """The smallest committed SRS fixture of at least n points, if any, in
    `caches.srs_cache_dir()`."""
    srs_dir = Path(caches.srs_cache_dir())
    if not srs_dir.is_dir():
        return None
    pat = re.compile(rf"srs_(\d+)_{seed:x}\.npz$")
    sizes = {}
    for f in srs_dir.iterdir():
        m = pat.match(f.name)
        if m:
            sizes[int(m.group(1))] = f
    fits = [k for k in sizes if k >= n]
    return sizes[min(fits)] if fits else None


def srs_setup(max_degree: int, device, seed: int = SRS_SEED) -> KZGProverKey:
    """The prover key of a (test/dev) SRS of max_degree points: a committed
    fixture's prefix when one is large enough, else generated on device."""
    n = max_degree
    path = fixture_path(n, seed)
    if path is None:
        return KZGProverKey(srs_generate(n, device, seed), n)
    with np.load(path) as z:
        pts = tuple(torch.from_numpy(np.ascontiguousarray(z[k][:, :n])
                                     .astype(np.int32)).to(device)
                    for k in ("X", "Y", "Z"))
    return KZGProverKey(pts, n)


def kzg_commit(pk: KZGProverKey, coeffs_mont: torch.Tensor) -> G1Affine:
    """Commit to one coefficient vector (the bitplane MSM over the SRS)."""
    return kzg_commit_batch(pk, [coeffs_mont])[0]


def _msm_jac(points_jac, scalars_mont: torch.Tensor) -> G1Affine:
    """The bitplane MSM (K5) of Montgomery Fr scalars [16, n] over the
    first n of Jacobian device bases (X, Y, Z)."""
    n = scalars_mont.shape[-1]
    return cd.batch_msm_bitplane(tuple(t[:, :n] for t in points_jac),
                                 [scalars_mont])[0]


def _point_tree_level(P):
    """One level of pairwise Jacobian adds (K6): out[i] = P[2i] + P[2i+1]."""
    return cd.jac_add(tuple(t[:, 0::2].contiguous() for t in P),
                      tuple(t[:, 1::2].contiguous() for t in P))


def _compute_g_products(g1_jac, n: int) -> list[G1Jacobian]:
    """[sum(g1[:2^k]) for k in 0..log2(n)] from one sweep of pairwise
    reductions: after j halvings, element 0 is the sum of the first 2^j
    points.  The element-0 columns are pulled to the host together."""
    k_max = n.bit_length() - 1
    P = tuple(t[:, :1 << k_max] for t in g1_jac)
    firsts = [tuple(t[:, :1] for t in P)]
    for _ in range(k_max):
        P = _point_tree_level(P)
        firsts.append(tuple(t[:, :1] for t in P))
    return cd.jacobian_to_host(*(torch.cat([f[i] for f in firsts], dim=1)
                                 for i in range(3)))


def kzg_commit_grand_product(pk: KZGProverKey, coeffs_mont: torch.Tensor
                             ) -> G1Affine:
    """CommitMode::GrandProduct (kzg.rs:137-144, 223-256;
    jolt_tpu/commitment/kzg.py:243-258): g_products[log2 n] plus the MSM
    (K5) of the residual coeffs - 1, where one is R mod p in Montgomery
    form.  The same point as kzg_commit; a length that is not a power of
    two goes to kzg_commit."""
    n = coeffs_mont.shape[-1]
    if n & (n - 1):
        return kzg_commit(pk, coeffs_mont)
    residual = fd.fsub(FR, coeffs_mont,
                       fd.ones(FR, (n,), coeffs_mont.device))
    msm_part = _msm_jac(pk.g1_jac, residual)
    total = pk.g_products()[n.bit_length() - 1].add(msm_part.to_jacobian())
    return total.to_affine()


def kzg_commit_batch(pk: KZGProverKey, polys: list, mesh=None
                     ) -> list[G1Affine]:
    """Batch commit: every polynomial's scalar bit-planes share one fold
    over the same SRS bases (its point axis split over `mesh`, if one is
    given: parallel/sharding.py sharded_masked_fold)."""
    fold = None if mesh is None else \
        functools.partial(sh.sharded_masked_fold, mesh)
    return cd.batch_msm_bitplane(pk.g1_jac, list(polys), fold)


def _powers_device(spec: FieldSpec, u: torch.Tensor, n: int) -> torch.Tensor:
    """[1, u, u^2, ..., u^{n-1}] by log-doubling; u: Montgomery limbs [16]."""
    table = fd.ones(spec, (1,), u.device)
    cur = u[:, None]
    while table.shape[-1] < n:
        table = torch.cat([table, fd.fmul(spec, table, cur)], dim=-1)
        cur = fd.fmul(spec, cur, cur)
    return table[..., :n]


def _quotient_coeffs(spec: FieldSpec, b: torch.Tensor, upow: torch.Tensor,
                     uinv_pow: torch.Tensor) -> torch.Tensor:
    """q[j] = u^{-(j+1)} * sum_{i >= j+1} b_i u^i, j = 0..n-2."""
    suffix = fd.fsuffix_sum(spec, fd.fmul(spec, b, upow))[..., 1:]
    return fd.fmul(spec, suffix, uinv_pow[..., 1:])


def kzg_quotient(coeffs_mont: torch.Tensor, u: FElt) -> torch.Tensor:
    """Coefficients of (B(X) - B(u)) / (X - u) (kzg.rs:258-275)."""
    n, dev = coeffs_mont.shape[-1], coeffs_mont.device
    upow = _powers_device(FR, fd.scalar_to_device(FR, u.v, dev), n)
    uinv_pow = _powers_device(
        FR, fd.scalar_to_device(FR, pow(u.v, -1, FR.p), dev), n)
    return _quotient_coeffs(FR, coeffs_mont, upow, uinv_pow)


def kzg_open_no_rem(pk: KZGProverKey, coeffs_mont: torch.Tensor,
                    u: FElt) -> G1Affine:
    """Commitment to (B(X) - B(u)) / (X - u) (kzg.rs:258-275)."""
    return kzg_commit_batch(pk, [kzg_quotient(coeffs_mont, u)])[0]


def kzg_verify(vk: KZGVerifierKey, commitment: G1Affine, u: FElt, v: FElt,
               w: G1Affine) -> bool:
    """Pairing check e(C - v*g + u*W, g2) == e(W, beta_g2)
    (kzg.rs:277-296)."""
    lhs = (commitment.to_jacobian()
           .add(vk.g1.to_jacobian().mul((-v.v) % FR.p))
           .add(w.to_jacobian().mul(u.v))).to_affine()
    return pairing_product_is_one([(lhs, vk.g2), (w.neg(), vk.beta_g2)])


def poly_eval_device(coeffs_mont: torch.Tensor, u: FElt) -> FElt:
    """Univariate evaluation sum b_i u^i via a power-table dot product."""
    n, dev = coeffs_mont.shape[-1], coeffs_mont.device
    upow = _powers_device(FR, fd.scalar_to_device(FR, u.v, dev), n)
    return FElt(fd.to_int(FR, fd.fsum(FR, fd.fmul(FR, coeffs_mont, upow),
                                      axis=-1)), FR)
