"""BN254 G1 on the device: point ops and the bitplane batch commit.

Points are Jacobian coordinate triples of Fq limb tensors [16, N] (infinity
is Z = 0), the form the SRS is stored in.  The commit is the bitplane
("binary Pippenger") MSM of jolt_tpu/curve/device.py:543:

    sum_i s_i * P_i  =  sum_b 2^b * (sum_{i : bit b of s_i} P_i)

Each bit plane of each scalar vector is one channel; the masked sums of
all channels are folded on the device with the complete projective add
(K5), and the per-bit sums are Horner-combined on the host.  Any order of
group additions gives the same affine commitment, so the port keeps one
fold for every size: the first T points are the accumulators [16, T, K]
(K channels, T lanes), the rest are added T at a time, then a log-depth
tree folds the T lanes.  T is
chosen so that one K5 launch covers about 2^20 point-adds.
"""
from __future__ import annotations

import torch

from ..field import arith
from ..field import device as fd
from ..field.spec import LIMB_BITS, fq_spec, fr_spec
from ..utils.math import next_power_of_two
from .bn254 import G1Affine, G1Jacobian, Q as Q_INT
from .kernels import jac_add, jac_double, proj_cadd  # noqa: F401  (re-exported)

FQ = fq_spec()
FR = fr_spec()

MSM_CHANNEL_CHUNK = 64     # bit-plane channels per fold, at least
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
    mt = masks.T.contiguous()                                 # [n, K]
    acc = None
    for j in range(steps):
        sl = slice(j * T, (j + 1) * T)
        m = mt[sl][None]                                      # [1, T, K]
        pts = tuple(t.contiguous() for t in (
            torch.where(m, PX[:, sl, None], 0),
            torch.where(m, PY[:, sl, None], one),
            torch.where(m, PZ[:, sl, None], 0)))
        acc = pts if acc is None else proj_cadd(acc, pts)
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


def batch_msm_bitplane(points_jac, scalars_mont: list, fold=None
                       ) -> list[G1Affine]:
    """MSMs of many scalar vectors over one base set (the batch commit).

    points_jac: (X, Y, Z) Montgomery Jacobian [16, N]; scalars_mont: list
    of Montgomery Fr tensors [16, n_j], n_j <= N.  Equal-length vectors are
    stacked; their canonical bits come from one REDC pass and one pull of
    the per-limb maxima (a scalar vector of b bits costs b channels).

    `fold` (default masked_fold) folds the masked points of one chunk of
    channels to projective sums [16, K]; on a mesh, commitment/kzg.py
    passes parallel/sharding.py's sharded_masked_fold."""
    fold = fold or masked_fold
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
        # short vectors fold more channels at once, so that one fold's K5
        # launches cover about FOLD_LANES point-adds, as at full length:
        # Zeromorph's opening commits quotients of 2^k points for every
        # k < ell, each of up to 254 bit planes, and HyperKZG's folds
        # shrink the same way; at 64 channels a 2^10-point quotient took
        # four folds of launches 1/16 of that size
        chunk = max(MSM_CHANNEL_CHUNK, FOLD_LANES // n)
        folds = []
        for lo in range(0, len(channels), chunk):
            group = channels[lo:lo + chunk]
            slots = torch.tensor([s for s, _ in group], device=canon.device)
            bits = torch.tensor([b for _, b in group], device=canon.device)
            sel = canon[bits // LIMB_BITS, slots, :]            # [K, n]
            masks = ((sel >> (bits % LIMB_BITS)[:, None]) & 1).bool()
            folds.append(fold(PX, PY, PZ, masks & live[None]))
        # one pull for every chunk's channel sums
        sums_pts = proj_to_host_jac(*(torch.cat([f[i] for f in folds], dim=1)
                                      for i in range(3)))
        sums: dict[int, list[G1Jacobian]] = {j: [] for j in idxs}
        for (slot, _b), p in zip(channels, sums_pts):
            sums[idxs[slot]].append(p)
        for j in idxs:
            results[j] = _horner_bits(sums[j]).to_affine()
    return [results[j] for j in range(len(scalars_mont))]


# ---------------------------------------------------------------------------
# device -> host points
# ---------------------------------------------------------------------------

def jacobian_to_host(X, Y, Z) -> list[G1Jacobian]:
    """Jacobian Montgomery limbs [16, ...] -> host Jacobians (flattened)."""
    xi = fd.device_to_ints(FQ, X).ravel()
    yi = fd.device_to_ints(FQ, Y).ravel()
    zi = fd.device_to_ints(FQ, Z).ravel()
    return [G1Jacobian(int(a), int(b), int(c)) for a, b, c in zip(xi, yi, zi)]


# ---------------------------------------------------------------------------
# the windowed MSM (jolt_tpu/curve/device.py:183-314, 666-684)
# ---------------------------------------------------------------------------
#
# Every point add is a Jacobian add (K6), every doubling a Jacobian doubling
# (K7).  Any order of group additions gives the same affine result, so the
# port keeps jolt_tpu's steps (c-bit digits, a sort by digit, a segmented
# Hillis-Steele scan whose segment tails are the buckets) and differs in
# three places:
#   * the rows of one commitment share their bases, so all rows and windows
#     are lanes of one call, cut into chunks of about MSM_LANES point lanes;
#   * the buckets are not scattered into 2^c dense slots: each lane's
#     segment tails are gathered into min(N, 2^c - 1) slots (rounded up to
#     a power of two), and sum_d d * B_d is taken bit plane by bit plane
#     (the sum of the slots whose digit has bit b set), so the work
#     follows N for short rows;
#   * the c * W bit-plane sums of a row are Horner-combined on the card
#     (one doubling and one add per bit, all rows at once) for CUDA tensors,
#     and on the host for CPU tensors, where one plain point op over any
#     number of lanes costs tens of milliseconds and a host op microseconds.

MSM_WINDOW_BITS = 8
MSM_LANES = 1 << 22      # (point, window, row) lanes per chunk of rows
# a window's digit lies inside one 16-bit limb
assert LIMB_BITS % MSM_WINDOW_BITS == 0


def scalar_max_windows(canonical_limbs: torch.Tensor) -> int:
    """Number of MSM_WINDOW_BITS-bit windows the largest scalar needs (at
    least 1), from canonical Fr limbs [16, ...]: one reduction and one host
    sync."""
    limb_max = canonical_limbs.reshape(fd.L, -1).amax(dim=1).tolist()
    msb = 0
    for i, v in enumerate(limb_max):
        if v:
            msb = LIMB_BITS * i + int(v).bit_length()
    return max(1, -(-msb // MSM_WINDOW_BITS))


def _gather_cols(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t [16, M] gathered at idx [...] -> [16, ...]."""
    return t[:, idx.reshape(-1)].reshape((fd.L,) + tuple(idx.shape))


def _msm_bit_sums(px, py, pz, canon, windows: int):
    """The bit-plane sums of a windowed MSM of R scalar rows over N shared
    Jacobian bases -> Jacobian [16, c * W, R]; entry j of row r is
    sum_{i : bit j of s_ri} P_i, so the row's MSM is sum_j 2^j entry_j.

    px/py/pz: [16, N] Fq Montgomery (infinity is Z = 0); canon: canonical
    Fr limbs [16, R, N]; windows: W, at least scalar_max_windows(canon).
    Digits 0 enter the scan as infinity."""
    c, W = MSM_WINDOW_BITS, windows
    per_limb = LIMB_BITS // c
    R, N = canon.shape[1], canon.shape[2]
    dev = px.device
    lanes = W * R
    digits = torch.stack([(canon[w // per_limb] >> (c * (w % per_limb)))
                          & ((1 << c) - 1) for w in range(W)]).long()
    sd, order = torch.sort(digits.reshape(lanes, N), dim=1)
    sd, order = sd.T.contiguous(), order.T.contiguous()      # [N, lanes]
    P = (_gather_cols(px, order), _gather_cols(py, order),
         torch.where(sd[None] != 0, _gather_cols(pz, order), 0))

    # segmented inclusive scan along the points: P_i += P_{i-d} where both
    # have the same digit
    d = 1
    while d < N:
        same = sd[d:] == sd[:-d]
        out = jac_add(tuple(t[:, d:] for t in P),
                      (P[0][:, :-d], P[1][:, :-d],
                       torch.where(same[None], P[2][:, :-d], 0)))
        P = tuple(torch.cat([t[:, :d], o], dim=1) for t, o in zip(P, out))
        d *= 2

    # each lane's segment tails (the buckets B_d, d != 0), gathered in
    # order into the first of K slots; a slot past them has digit 0
    tail = torch.ones_like(sd, dtype=torch.bool)
    tail[:-1] = sd[1:] != sd[:-1]
    tail &= sd != 0
    Kt = min(N, (1 << c) - 1)               # tails a lane can have
    pos = torch.sort((~tail).to(torch.uint8), dim=0,
                     stable=True).indices[:Kt]               # [Kt, lanes]
    has = torch.arange(Kt, device=dev)[:, None] < tail.sum(dim=0)
    K = next_power_of_two(Kt)
    dslot = torch.zeros((K, lanes), dtype=torch.long, device=dev)
    dslot[:Kt] = torch.where(has, sd.gather(0, pos), 0)
    B = []
    for t in P:
        b = t.new_zeros((fd.L, K, 1, lanes))
        b[:, :Kt, 0] = t.gather(1, pos[None].expand(fd.L, Kt, lanes))
        B.append(b)

    # bit planes: sum of the slots whose digit has bit b set, a tree over K
    bit = ((dslot[:, None, :] >> torch.arange(c, device=dev)[None, :, None])
           & 1).bool()                                       # [K, c, lanes]
    T = tuple(t.expand(fd.L, K, c, lanes).reshape(fd.L, K, c * lanes)
              .contiguous() for t in (B[0], B[1],
                                      torch.where(bit[None], B[2], 0)))
    while T[0].shape[1] > 1:
        h = T[0].shape[1] // 2
        T = jac_add(tuple(t[:, :h] for t in T), tuple(t[:, h:] for t in T))
    # [16, c, W, R] -> [16, W, c, R]: entry w * c + b is bit j = w * c + b
    return tuple(t.reshape(fd.L, c, W, R).transpose(1, 2)
                 .reshape(fd.L, W * c, R).contiguous() for t in T)


def _horner_device(S):
    """sum_j 2^j S_j over the bit axis of Jacobian [16, J, R], on the
    tensors' device (J doublings and J - 1 adds, all rows at once)."""
    J = S[0].shape[1]
    acc = tuple(t[:, J - 1] for t in S)
    for j in range(J - 2, -1, -1):
        acc = jac_add(jac_double(acc), tuple(t[:, j] for t in S))
    return acc


def _horner_host(S) -> list[G1Jacobian]:
    """sum_j 2^j S_j per row on the host, from Jacobian [16, J, R]."""
    J, R = S[0].shape[1], S[0].shape[2]
    pts = jacobian_to_host(*(t.transpose(1, 2) for t in S))   # row-major
    out = []
    for r in range(R):
        acc = G1Jacobian.identity()
        for p in reversed(pts[r * J:(r + 1) * J]):
            acc = acc.double().add(p)
        out.append(acc)
    return out


def msm(points_jac, scalars_mont: torch.Tensor) -> list[G1Affine]:
    """MSMs of R rows of Montgomery Fr scalars [16, R, N] over N shared
    Jacobian bases (X, Y, Z) [16, >= N] (infinity is Z = 0) -> R affine
    points.  The windows come from the largest scalar (one host sync), and
    the rows are cut into chunks of about MSM_LANES (point, window, row)
    lanes."""
    px, py, pz = points_jac
    R, N = scalars_mont.shape[1], scalars_mont.shape[2]
    if px.shape[-1] < N:
        raise ValueError(f"{px.shape[-1]} bases are too few for {N} scalars")
    px, py, pz = px[:, :N], py[:, :N], pz[:, :N]
    canon = fd.from_mont_device(FR, scalars_mont)
    W = scalar_max_windows(canon)
    rows = max(1, MSM_LANES // (W * N))
    parts = []
    for lo in range(0, R, rows):
        S = _msm_bit_sums(px, py, pz, canon[:, lo:lo + rows], W)
        parts.append(_horner_device(S) if px.is_cuda else _horner_host(S))
    if px.is_cuda:
        pts = jacobian_to_host(*(torch.cat([p[i] for p in parts], dim=1)
                                 for i in range(3)))
    else:
        pts = [p for part in parts for p in part]
    return [p.to_affine() for p in pts]
