"""KZG prover key over BN254 (reference: poly/commitment/kzg.rs): the SRS
and the batch commit.

* The SRS is g * tau^i for a tau drawn from a deterministic seed, kept in
  Jacobian form [16, N] per coordinate.  `srs_setup` reads the committed
  `fixtures/srs/srs_<n>_<seed>.npz` when one of at least n points exists
  (any prefix of a larger SRS is the smaller SRS) and otherwise generates
  the points on the device: powers of tau, then a fixed-base windowed table
  gather and a log-depth tree of Jacobian adds (K6).  It never writes into
  `fixtures/`.
* commit = the bitplane batch MSM over the SRS prefix (curve/device.py).
"""
from __future__ import annotations

import random
import re
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from ..curve import device as cd
from ..curve.bn254 import G1Affine, G1Jacobian
from ..field import device as fd
from ..field.spec import fr_spec

FR = fr_spec()
SRS_SEED = 0x6A6F6C74
FIXTURE_DIR = Path(__file__).resolve().parents[2] / "fixtures" / "srs"
SRS_CHUNK = 1 << 18   # points per generation pass (bounds [16, 32, chunk])


@dataclass
class KZGProverKey:
    g1_jac: tuple  # (X, Y, Z) device limb tensors [16, N] -- g * tau^i
    n: int


def _fixed_base_table(base: G1Affine, c: int = 8, windows: int = 32):
    """Host table T[w][d] = base * (d << (c*w)); [windows, 2^c] affine."""
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
    canon = fd.from_mont_device(FR, torch.cat(chunks, dim=1)[:, :n])

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
    """The smallest committed SRS fixture of at least n points, if any."""
    if not FIXTURE_DIR.is_dir():
        return None
    pat = re.compile(rf"srs_(\d+)_{seed:x}\.npz$")
    sizes = {}
    for f in FIXTURE_DIR.iterdir():
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


def kzg_commit_batch(pk: KZGProverKey, polys: list) -> list[G1Affine]:
    """Batch commit: every polynomial's scalar bit-planes share one fold
    over the same SRS bases."""
    return cd.batch_msm_bitplane(pk.g1_jac, list(polys))
