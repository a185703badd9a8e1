"""BN254 G1 on the device: point ops and the bitplane batch commit.

Points are Jacobian coordinate triples of Fq limb tensors [16, N] (infinity
is Z = 0), the form the SRS is stored in.  The commit is the bitplane
("binary Pippenger") MSM of jolt_tpu/curve/device.py:543:

    sum_i s_i * P_i  =  sum_b 2^b * (sum_{i : bit b of s_i} P_i)

Each bit plane of each scalar vector is one channel; the masked sums of
all channels are folded on the device with the complete projective add
(K5), and the per-bit sums are Horner-combined on the host.  Any order of
group additions gives the same affine commitment, so the port keeps one
fold for every size: accumulators [16, T, K] (K channels, T lanes) take
the points T at a time, then a log-depth tree folds the T lanes.  T is
chosen so that one K5 launch covers about 2^20 point-adds.
"""
from __future__ import annotations

import torch

from ..field import arith
from ..field import device as fd
from ..field.spec import LIMB_BITS, fq_spec, fr_spec
from ..utils.math import next_power_of_two
from .bn254 import G1Affine, G1Jacobian, Q as Q_INT
from .kernels import jac_add, proj_cadd  # noqa: F401  (re-exported)

FQ = fq_spec()
FR = fr_spec()

MSM_CHANNEL_CHUNK = 64     # bit-plane channels per fold
FOLD_LANES = 1 << 20       # lanes x channels per K5 launch of the fold


def proj_from_jac(px: torch.Tensor, pz: torch.Tensor):
    """Jacobian (X, Y, Z) -> projective (X*Z : Y : Z^3); Y unchanged."""
    return fd.fmul(FQ, px, pz), fd.fmul(FQ, pz, fd.fmul(FQ, pz, pz))


def proj_tail_fold(acc):
    """Tree-reduce a projective accumulator [16, T, K] -> [16, K]."""
    X, Y, Z = acc
    while X.shape[1] > 1:
        h = X.shape[1] // 2
        X, Y, Z = proj_cadd((X[:, :h], Y[:, :h], Z[:, :h]),
                            (X[:, h:], Y[:, h:], Z[:, h:]))
    return X[:, 0], Y[:, 0], Z[:, 0]


def masked_fold(PX, PY, PZ, masks: torch.Tensor):
    """sum_{i : masks[k, i]} P_i for every channel k -> projective [16, K].

    PX/PY/PZ: projective [16, n]; masks: bool [K, n].  Masked-out points
    enter as the identity (0:1:0)."""
    K, n = masks.shape
    T = min(next_power_of_two(max(1, FOLD_LANES // K)), next_power_of_two(n))
    steps = -(-n // T)
    if steps * T != n:
        pad = steps * T - n
        masks = torch.cat([masks, masks.new_zeros((K, pad))], dim=1)
        PX, PY, PZ = (torch.cat([t, t.new_zeros((t.shape[0], pad))], dim=1)
                      for t in (PX, PY, PZ))
    one = arith.const_limbs(FQ, "r", PX.device)[:, None, None]
    zero = torch.zeros((fd.L, T, K), dtype=torch.int32, device=PX.device)
    acc = (zero, one.expand(fd.L, T, K).contiguous(), zero)
    mt = masks.T.contiguous()                                 # [n, K]
    for j in range(steps):
        sl = slice(j * T, (j + 1) * T)
        m = mt[sl][None]                                      # [1, T, K]
        pts = (torch.where(m, PX[:, sl, None], 0),
               torch.where(m, PY[:, sl, None], one),
               torch.where(m, PZ[:, sl, None], 0))
        acc = proj_cadd(acc, tuple(t.contiguous() for t in pts))
    return proj_tail_fold(acc)


def proj_to_host_jac(X, Y, Z) -> list[G1Jacobian]:
    """Projective (X:Y:Z) -> host Jacobians (X*Z, Y*Z^2, Z), no inversions."""
    xi = fd.device_to_ints(FQ, X).ravel()
    yi = fd.device_to_ints(FQ, Y).ravel()
    zi = fd.device_to_ints(FQ, Z).ravel()
    out = []
    for a, b, c in zip(xi, yi, zi):
        a, b, c = int(a), int(b), int(c)
        if c == 0:
            out.append(G1Jacobian.identity())
        else:
            out.append(G1Jacobian(a * c % Q_INT, b * c * c % Q_INT, c))
    return out


def _horner_bits(sums: list[G1Jacobian]) -> G1Jacobian:
    """sum_b 2^b * sums[b] via MSB-first Horner (host, ~bits point ops)."""
    acc = G1Jacobian.identity()
    for s in reversed(sums):
        acc = acc.double()
        acc = acc.add(s)
    return acc


def batch_msm_bitplane(points_jac, scalars_mont: list) -> list[G1Affine]:
    """MSMs of many scalar vectors over one base set (the batch commit).

    points_jac: (X, Y, Z) Montgomery Jacobian [16, N]; scalars_mont: list
    of Montgomery Fr tensors [16, n_j], n_j <= N.  Equal-length vectors are
    stacked; their canonical bits come from one REDC pass and one pull of
    the per-limb maxima (a scalar vector of b bits costs b channels)."""
    px, py, pz = points_jac
    by_len: dict[int, list[int]] = {}
    for j, s in enumerate(scalars_mont):
        by_len.setdefault(s.shape[-1], []).append(j)
    results: dict[int, G1Affine] = {}
    for n, idxs in by_len.items():
        if n > px.shape[-1]:
            raise ValueError(f"SRS of {px.shape[-1]} points is too short "
                             f"for a vector of {n}")
        canon = fd.from_mont_device(
            FR, torch.stack([scalars_mont[j] for j in idxs], dim=1))
        limb_max = canon.amax(dim=-1).cpu().tolist()         # [16][J]
        channels: list[tuple[int, int]] = []
        for slot in range(len(idxs)):
            msb = 0
            for i in range(fd.L):
                v = int(limb_max[i][slot])
                if v:
                    msb = LIMB_BITS * i + v.bit_length()
            channels += [(slot, b) for b in range(max(1, msb))]
        PX, PZ = proj_from_jac(px[:, :n], pz[:, :n])
        PY = py[:, :n]
        live = (pz[:, :n] != 0).any(dim=0)
        folds = []
        for lo in range(0, len(channels), MSM_CHANNEL_CHUNK):
            group = channels[lo:lo + MSM_CHANNEL_CHUNK]
            slots = torch.tensor([s for s, _ in group], device=canon.device)
            bits = torch.tensor([b for _, b in group], device=canon.device)
            sel = canon[bits // LIMB_BITS, slots, :]            # [K, n]
            masks = ((sel >> (bits % LIMB_BITS)[:, None]) & 1).bool()
            folds.append(masked_fold(PX, PY, PZ, masks & live[None]))
        # one pull for every chunk's channel sums
        sums_pts = proj_to_host_jac(*(torch.cat([f[i] for f in folds], dim=1)
                                      for i in range(3)))
        sums: dict[int, list[G1Jacobian]] = {j: [] for j in idxs}
        for (slot, _b), p in zip(channels, sums_pts):
            sums[idxs[slot]].append(p)
        for j in idxs:
            results[j] = _horner_bits(sums[j]).to_affine()
    return [results[j] for j in range(len(scalars_mont))]
