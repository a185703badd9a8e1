"""Batched GKR grand products (Thaler'13 layered circuits).

Reference semantics: jolt-core/src/subprotocols/grand_product.rs --
interleaved [L0, R0, L1, R1, ...] layers, product-tree construction,
per-layer batched cubic sumcheck with least-significant-variable binding,
claim folding with a per-layer challenge, and verification that replays
eq(r_gp, rev(r_sumcheck)).

Layout (jolt_tpu's): a layer is a PAIR of batch-leading limb tensors
(l, r): int32[B, 16, s] holding the left/right polynomials in
BIT-REVERSED evaluation order, so every round's sibling pairs (2i, 2i+1)
sit at (i, i + s/2): the round kernels (K2 evals, K3 bind) read contiguous
halves and the bind outputs are the next round's layers.  Sums mod p do
not depend on order, so every transcript byte equals the reference's.

The port runs jolt_tpu's unmasked, shrinking rounds (`_prove_dense_layers`,
grand_product.py:739) with every layer and every round on the device, down
to pair size 2; the TPU-only mechanisms (masked fixed-shape rounds,
class-buffered trees, host tails) stay behind.  The toggled grand product
(Lasso's flag-gated read/write multisets, grand_product.rs:1049-1546) adds
its toggle layer below the dense layers, also on the device to the last
round: a toggle round is one K14 launch (its evaluations) and one K15
launch (its bind), field/kernels.py `toggle_evals` and `bind_halves`.

Fiat-Shamir (jolt_tpu's JOLT_TPU_DEVICE_FS and JOLT_TPU_CHAIN, with the
same meanings; both default on where the prover's tensors are on a CUDA
device and off on the CPU):
  - host: each round pulls its evaluations and uploads its challenge;
  - device (`_use_device_fs`): each layer's rounds run K2 -> K9 -> K3
    (a toggle round K14 -> K9 -> K15) with no host sync
    (subprotocols/fs_device.py), one pull per layer;
  - chained (`_use_chain`): a whole grand product also draws its batching
    coefficients, builds its eq tables and appends its claims on the
    device (K8), with one pull at the end and one host replay, which must
    reach the device chain's state byte for byte.
Every mode gives the same transcript and proof.

On a mesh (parallel/sharding.py; jolt_tpu's `mesh=`), the batch axis of
every pair layer is split: the batch is zero-padded to a multiple of the
mesh size, each shard builds and binds its circuits' trees (K4, K2, K3),
the round evaluations fold mod p on the first device, and the pad rows'
zero coefficients keep them out of every round; the claims and proof
entries cover the real circuits alone.  The toggled grand product's
toggle tensors are split on the hypercube instead.  The chained mode is
off there, as jolt_tpu's `_chain_ok` has it.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Sequence

import torch

from ..field import device as fd
from ..field import kernels as fk
from ..field.host import FElt
from ..field.spec import FieldSpec, fr_spec
from ..parallel import sharding as sh
from ..poly.mle import bitrev_indices, eq_evals_device_br
from ..poly.unipoly import CompressedUniPoly, UniPoly
from ..transcript import Transcript
from ..utils.profiling import span
from . import fs_device as fsd
from .sumcheck import SumcheckInstanceProof, VerificationError


@dataclass
class BatchedGrandProductLayerProof:
    proof: SumcheckInstanceProof
    left_claims: list[FElt]
    right_claims: list[FElt]


@dataclass
class BatchedGrandProductProof:
    layers: list[BatchedGrandProductLayerProof]
    quark: object | None = None  # QuarkGrandProductProof in the hybrid scheme


# ---------------------------------------------------------------------------
# device layers
# ---------------------------------------------------------------------------

def _env_switch(name: str):
    """An environment switch: None when unset, else on unless "0" or ""."""
    v = os.environ.get(name)
    return None if v is None else v not in ("0", "")


def _use_device_fs(device) -> bool:
    """Device-resident Fiat-Shamir for every sumcheck-shaped prover.
    JOLT_TPU_DEVICE_FS=1/0 overrides; the default is on for CUDA tensors
    (where it saves a host sync per round) and off on the CPU."""
    v = _env_switch("JOLT_TPU_DEVICE_FS")
    return torch.device(device).type == "cuda" if v is None else v


def _use_chain(device) -> bool:
    """Fully device-chained grand products (one state upload, one pull).
    JOLT_TPU_CHAIN=1/0 overrides; the default is on where device
    Fiat-Shamir is on by default, for CUDA tensors."""
    v = _env_switch("JOLT_TPU_CHAIN")
    if v is not None:
        return v
    return torch.device(device).type == "cuda" and _use_device_fs(device)


def _tree_level(spec: FieldSpec, layer: torch.Tensor) -> torch.Tensor:
    """One product-tree level over an INTERLEAVED [16, B, n] layer:
    out[i] = layer[2i] * layer[2i+1] (K1; the strided halves are copied
    into contiguous operands by its wrapper).  The Quarks construction's
    path only: the GKR prover keeps the bit-reversed pairs below."""
    return fd.fmul(spec, layer[..., 0::2], layer[..., 1::2])


def _interleaved_to_pair(spec: FieldSpec, leaves: torch.Tensor):
    """Interleaved leaves [16, B, n] -> bit-reversed batch-leading pair
    (l, r): [B, 16, n/2] each (views of one [B, 16, n] tensor).  The left
    poly occupies even interleaved indices: the first half after
    bit-reversal."""
    n = leaves.shape[-1]
    idx = torch.from_numpy(bitrev_indices(n)).to(leaves.device)
    arr = leaves.index_select(-1, idx).movedim(0, 1).contiguous()
    return arr[..., : n // 2], arr[..., n // 2:]


def _pair_tree_level(spec: FieldSpec, l: torch.Tensor, r: torch.Tensor):
    """Next tree level: l*r elementwise (K4), split into contiguous halves.
    The parent interleaved layer's bit-reversed array IS l*r; its
    left/right polys are its halves."""
    prod = fk.mont_mul_bl(spec, l, r)
    s = prod.shape[-1]
    return prod[..., : s // 2], prod[..., s // 2:]


def _pair_cubic_evals(spec: FieldSpec, l, r, eq, coeffs) -> torch.Tensor:
    """Cubic round-poly evaluations at t = 0, 2, 3 -> [16, 3] (K2; per
    shard and folded on a mesh)."""
    if sh.is_sharded(l):
        return sh.gp_round_evals(l.mesh, spec, l, r, eq, coeffs)
    return fk.gp_pair_evals(spec, l, r, eq, coeffs)


def _pair_bind(spec: FieldSpec, l, r, eq, r_chal):
    """Bind the bottom variable on contiguous halves (K3; per shard on a
    mesh)."""
    if sh.is_sharded(l):
        return sh.gp_round_bind(l.mesh, spec, l, r, eq, r_chal)
    return fk.gp_pair_bind(spec, l, r, eq, r_chal)


def _build_pair_tree(spec: FieldSpec, leaves: torch.Tensor) -> list:
    """Interleaved leaves [16, B, n] -> pair layers bottom-up (layers[0]
    the largest, layers[-1] of pair size 1)."""
    layers = [_interleaved_to_pair(spec, leaves)]
    while layers[-1][0].shape[-1] > 1:
        layers.append(_pair_tree_level(spec, *layers[-1]))
    return layers


def _build_sharded_tree(mesh, spec: FieldSpec, leaves: torch.Tensor) -> list:
    """Interleaved leaves [16, B, n] -> pair layers bottom-up whose batch
    axis is split over `mesh` (zero-padded to a multiple of its size):
    each shard builds its block's trees on its device."""
    trees = [_build_pair_tree(spec, part)
             for part in sh.shard_leaves(mesh, leaves)]
    real = leaves.shape[1]
    return [tuple(sh.Sharded(mesh, tuple(t[k][i] for t in trees), 0,
                             "block", real) for i in (0, 1))
            for k in range(len(trees[0]))]


def _pair_claims(spec: FieldSpec, top: tuple, real: int) -> list[FElt]:
    """The real circuits' products from the top pair layer."""
    lefts, rights = sh.batch_finals(top, real)
    return _felts(spec, fd.fmul(spec, lefts, rights))


def _felts(spec: FieldSpec, a: torch.Tensor) -> list[FElt]:
    return [FElt(int(v), spec) for v in fd.device_to_ints(spec, a).tolist()]


class BatchedDenseGrandProduct:
    """B independent grand products over 2^k leaves, proved jointly."""

    def __init__(self, layers: list[tuple], spec: FieldSpec,
                 real_batch: int | None = None, mesh=None):
        self.layers = layers  # [(l, r)] pairs, layers[0] = leaves, bit-rev
        self.spec = spec
        self.mesh = mesh
        # the batch before a mesh's zero padding: the claims and proof
        # entries cover the real circuits only
        self.real_batch = layers[0][0].shape[0] if real_batch is None \
            else real_batch

    @staticmethod
    def construct(leaves: torch.Tensor, spec: FieldSpec | None = None,
                  mesh=None) -> "BatchedDenseGrandProduct":
        """With `mesh`, the batch axis of every pair layer is split over
        it (zero-padded to its size, never replicated)."""
        spec = spec or fr_spec()
        if mesh is None:
            return BatchedDenseGrandProduct(_build_pair_tree(spec, leaves),
                                            spec)
        return BatchedDenseGrandProduct(
            _build_sharded_tree(mesh, spec, leaves), spec, leaves.shape[1],
            mesh)

    def num_layers(self) -> int:
        return len(self.layers)

    def claims(self) -> list[FElt]:
        return _pair_claims(self.spec, self.layers[-1], self.real_batch)

    def prove(self, transcript: Transcript
              ) -> tuple[BatchedGrandProductProof, list[FElt]]:
        claims = self.claims()
        if self.mesh is None and _use_chain(self.layers[0][0].device):
            B = self.layers[0][0].shape[0]
            ops = sum((1 << j) * (B * 7 + 4)
                      for j in range(len(self.layers) - 1))
            with span("BatchedDenseGP::chained", ops=ops):
                pend, (state, _, _, _) = _chain_prove_dense(
                    self.spec, self.layers, transcript)
                comp_ints, row_ints = _chain_pull(self.spec, pend)
                layer_proofs, r_grand_product, _, _ = _chain_replay_dense(
                    self.spec, pend, comp_ints, row_ints, claims, transcript)
                _assert_chain_state(transcript, state,
                                    "BatchedDenseGP::chained")
            return BatchedGrandProductProof(layer_proofs), r_grand_product
        layer_proofs, r_grand_product, _ = _prove_dense_layers(
            self.spec, self.layers, claims, [], transcript)
        return BatchedGrandProductProof(layer_proofs), r_grand_product


def _chain_prove_dense(spec: FieldSpec, layers: list, transcript: Transcript,
                       n_after: int = 0):
    """Every dense layer's challenge vector, eq table, rounds (K2 -> K9 ->
    K3) and claim appends on the device with no host sync; each layer is
    released as it is consumed.  A layer's claim appends, its r_layer and
    the next layer's challenge vector are one K8 launch; after the last
    layer, that launch draws the `n_after` challenges that follow it.
    Returns (pend, (state, rs, claims, after)): pend holds per layer
    (rounds k, its compressed polys [16, 3] each, its claim row [16, 2B])
    on the device; rs [16, k + 1] the next r_grand_product, claims [16, B]
    the folded claims and after [16, n_after] the challenges drawn after
    them."""
    n_layers = len(layers)
    B = layers[0][0].shape[0]
    dev = layers[0][0].device
    state = fsd.state_to_device(transcript, dev)
    top_l, top_r = layers[-1]
    claims_dev = fd.fmul(spec, top_l[..., 0].T, top_r[..., 0].T)  # [16, B]
    rs = fd.zeros(spec, (0,), dev)
    pend = []
    coeffs, state = fsd.challenge_vector_dev(spec, state, B)
    for li in range(n_layers - 1, -1, -1):
        l, r = layers[li]
        layers[li] = None
        k = n_layers - 1 - li                       # rounds of this layer
        prev = fsd.fold_claims_dev(spec, claims_dev, coeffs)
        eq = fsd.eq_masked_br(spec, rs, k)
        comps, rrounds = [], fd.zeros(spec, (k,), dev)
        for j in range(k):
            e023 = _pair_cubic_evals(spec, l, r, eq, coeffs)
            comp, rj, prev, state = fsd.fs_round(spec, e023, prev, state, 3,
                                                 True)
            l, r, eq = _pair_bind(spec, l, r, eq, rj)
            comps.append(comp)
            fsd.set_col(rrounds, rj, j)
        lefts, rights, inter = fsd.pair_finals_dev(spec, l, r)
        r_layer, coeffs, state = fsd.layer_events_dev(
            spec, state, inter, 2 * B, B if li else n_after)
        claims_dev = fsd.fold_lr_dev(spec, lefts, rights, r_layer)
        rs = fsd.rebuild_rs(rrounds, r_layer, k)
        pend.append((k, comps, inter))
    return pend, (state, rs, claims_dev, coeffs)


def _chain_pull(spec: FieldSpec, pend: list, extra_comps: list = (),
                extra_rows: list = ()):
    """One pull of every queued round poly and claim row: returns
    (comp_ints [n_polys][3], row_ints [n_rows][width])."""
    comps = [c for (_, cs, _) in pend for c in cs] + list(extra_comps)
    rows = [row for (_, _, row) in pend] + list(extra_rows)
    ints = fd.device_to_ints(spec, torch.cat(comps + rows, dim=1)).tolist()
    comp_ints = [ints[3 * i:3 * i + 3] for i in range(len(comps))]
    row_ints, pos = [], 3 * len(comps)
    for row in rows:
        row_ints.append(ints[pos:pos + row.shape[1]])
        pos += row.shape[1]
    return comp_ints, row_ints


def _chain_replay_dense(spec: FieldSpec, pend: list, comp_ints, row_ints,
                        claims: list[FElt], transcript: Transcript):
    """Replay the dense layers through the host transcript, building the
    proof; the caller checks the device chain's state against it.  Returns
    (layer_proofs, r_grand_product, claims, polys consumed)."""
    layer_proofs = []
    r_grand_product: list[FElt] = []
    idx = 0
    B = len(claims)
    for (k, _, _), inter in zip(pend, row_ints):
        transcript.challenge_vector(B)
        compressed, r_sumcheck = [], []
        for _ in range(k):
            cpoly = CompressedUniPoly(
                [FElt(int(v), spec) for v in comp_ints[idx]])
            idx += 1
            cpoly.append_to_transcript(transcript)
            r_sumcheck.append(transcript.challenge_scalar())
            compressed.append(cpoly)
        lefts = [FElt(int(inter[2 * b]), spec) for b in range(B)]
        rights = [FElt(int(inter[2 * b + 1]), spec) for b in range(B)]
        for lc, rc in zip(lefts, rights):
            transcript.append_scalar(lc)
            transcript.append_scalar(rc)
        r_layer = transcript.challenge_scalar()
        claims = [lc + r_layer * (rc - lc)
                  for lc, rc in zip(lefts, rights)]
        r_grand_product = list(reversed(r_sumcheck)) + [r_layer]
        layer_proofs.append(BatchedGrandProductLayerProof(
            SumcheckInstanceProof(compressed), lefts, rights))
    return layer_proofs, r_grand_product, claims, idx


def _assert_chain_state(transcript: Transcript, state: torch.Tensor,
                        protocol: str) -> None:
    """Raise RuntimeError unless the chained device transcript reached the
    host replay's state."""
    fsd.check_state(transcript, state, protocol)


def _prove_dense_layers(spec: FieldSpec, layers: list[tuple],
                        claims: list[FElt], r_grand_product: list[FElt],
                        transcript: Transcript):
    """Prove multiplication-gate layers top-down (grand_product.rs:199-251).

    `layers` are (l, r) bit-reversed pairs, bottom-up; each is released as
    it is consumed.  Returns (layer_proofs, r_grand_product, claims) after
    folding each layer's left/right claims with a fresh challenge."""
    layer_proofs: list[BatchedGrandProductLayerProof] = []
    for li in range(len(layers) - 1, -1, -1):
        l, r = layers[li]
        layers[li] = None
        # roofline accounting: per round at per-side size s, the cubic
        # evals cost h*(B*5+3) field muls and the bind h*(B*2+1), h = s/2
        # halving each round (grand_product.rs:335-396 mul counts)
        B = len(claims)
        s = (l.shards[0] if sh.is_sharded(l) else l).shape[-1]
        ops = sum((s >> (j + 1)) * (B * 7 + 4)
                  for j in range(len(r_grand_product)))
        with span("BatchedDenseGP::layer", ops=ops):
            dev = l.device
            coeffs = transcript.challenge_vector(len(claims))
            joint_claim = FElt(0, spec)
            for c, co in zip(claims, coeffs):
                joint_claim = joint_claim + c * co
            # a mesh's pad rows (past the B real circuits) get coefficient
            # 0: every round evaluation is the unpadded prover's
            n_pad = l.length - B if sh.is_sharded(l) else 0
            coeffs_dev = fd.ints_to_device(
                spec, [c.v for c in coeffs] + [0] * n_pad, dev)
            eq = eq_evals_device_br(spec, r_grand_product, dev)
            if sh.is_sharded(l):
                eq = sh.replicate(l.mesh, eq)

            r_sumcheck: list[FElt] = []
            compressed: list[CompressedUniPoly] = []
            previous_claim = joint_claim
            if r_grand_product and _use_device_fs(dev):
                # device Fiat-Shamir: the layer's rounds chain through the
                # device with no host sync; one pull, one host replay
                state = fsd.state_to_device(transcript, dev)
                prev = fd.scalar_to_device(spec, joint_claim.v, dev)
                comps = []
                for _ in range(len(r_grand_product)):
                    e023 = _pair_cubic_evals(spec, l, r, eq, coeffs_dev)
                    comp, rj, prev, state = fsd.fs_round(spec, e023, prev,
                                                         state, 3, True)
                    l, r, eq = _pair_bind(spec, l, r, eq, rj)
                    comps.append(comp)
                compressed, r_sumcheck = fsd.replay_and_check(
                    spec, fd.device_to_ints(spec, torch.stack(comps, dim=1))
                    .tolist(), transcript, state, CompressedUniPoly,
                    "BatchedDenseGP::layer")
            for _ in range(len(r_grand_product) - len(compressed)):
                e0, e2, e3 = _felts(spec, _pair_cubic_evals(spec, l, r, eq,
                                                            coeffs_dev))
                round_poly = UniPoly.from_evals([e0, previous_claim - e0,
                                                 e2, e3])
                cpoly = round_poly.compress()
                cpoly.append_to_transcript(transcript)
                r_j = transcript.challenge_scalar()
                r_sumcheck.append(r_j)
                l, r, eq = _pair_bind(
                    spec, l, r, eq, fd.scalar_to_device(spec, r_j.v, "cpu"))
                previous_claim = round_poly.evaluate(r_j)
                compressed.append(cpoly)

            finals = _felts(spec, torch.cat(sh.batch_finals((l, r), B),
                                            dim=1))
            left_claims, right_claims = finals[:B], finals[B:]
            for lc, rc in zip(left_claims, right_claims):
                transcript.append_scalar(lc)
                transcript.append_scalar(rc)

            r_grand_product = list(reversed(r_sumcheck))
            r_layer = transcript.challenge_scalar()
            claims = [lc + r_layer * (rc - lc)
                      for lc, rc in zip(left_claims, right_claims)]
            r_grand_product.append(r_layer)
            layer_proofs.append(BatchedGrandProductLayerProof(
                SumcheckInstanceProof(compressed), left_claims, right_claims))
    return layer_proofs, r_grand_product, claims


# ---------------------------------------------------------------------------
# toggled grand product (grand_product.rs:1049-1546)
# ---------------------------------------------------------------------------

def _bitrev_last(t: torch.Tensor) -> torch.Tensor:
    """Bit-reverse-permute the last (hypercube) axis."""
    idx = torch.from_numpy(bitrev_indices(t.shape[-1])).to(t.device)
    return t.index_select(-1, idx)


def _expand_flag_bits(spec: FieldSpec, bits: torch.Tensor) -> torch.Tensor:
    """[m, T] bool -> Montgomery 0/1 limb tensor [16, m, T]."""
    one = fd.ones(spec, (1,) * bits.dim(), bits.device)
    return torch.where(bits[None], one, 0).to(torch.int32)


def _toggle_values_bits(spec: FieldSpec, bits: torch.Tensor,
                        fingerprints: torch.Tensor) -> torch.Tensor:
    """Toggle-gate outputs flag * fp + 1 - flag from 0/1 flags [m, T]
    (memory b // 2 gates fingerprint b of [16, 2m, T]): where(bit, fp, 1)."""
    b2 = bits.repeat_interleave(2, dim=0)
    one = fd.ones(spec, (1,) * b2.dim(), fingerprints.device)
    return torch.where(b2[None], fingerprints, one)


def _toggle_cubic_evals(spec: FieldSpec, flags: torch.Tensor,
                        fingerprints: torch.Tensor, eq: torch.Tensor,
                        coeffs: torch.Tensor) -> torch.Tensor:
    """Toggle-layer round evaluations at t = 0, 2, 3 -> [16, 3]
    (grand_product.rs:1216-1360):

        sum_i eq_t(i) * sum_b coeff_b * (f_t(b, i) * fp_t(b, i) + 1 - f_t(b, i))

    flags [16, m, s], fingerprints [16, 2m, s] and eq [16, s] are
    bit-reversed along the hypercube, so sibling pairs are the contiguous
    halves; fingerprint b takes flag row b // 2 (one K14 launch,
    field/kernels.py `toggle_evals`)."""
    return fk.toggle_evals(spec, flags, fingerprints, eq, coeffs)


def _bind_one(spec: FieldSpec, t: torch.Tensor, r: torch.Tensor):
    """One tensor's top variable bound (K15), a shard's bind on a mesh."""
    return fk.bind_halves(spec, (t,), r)[0]


def _toggle_bind(spec: FieldSpec, flags, fingerprints, eq, r: torch.Tensor):
    """Bind the bottom variable of flags/fingerprints/eq: contiguous halves
    (bit-reversed), new = lo + r * (hi - lo): bind_top's pairs, all three
    in one K15 launch, or shard by shard on a mesh (cyclic layout)."""
    if sh.is_sharded(flags):
        return sh.bind_hypercube(spec, (flags, fingerprints, eq), r,
                                 _bind_one)
    return tuple(fk.bind_halves(spec, (flags, fingerprints, eq), r))


class ToggledBatchedGrandProduct:
    """Flag-gated grand product: the bottom layer computes flag * fp + 1 -
    flag.  The reference keeps sparse flag-index lists; here the flags are
    a dense 0/1 [m, T] bool tensor, expanded to Montgomery 0/1 limbs for
    the toggle rounds once the dense layers are proved (same transcript)."""

    def __init__(self, flag_bits: torch.Tensor, fingerprints: torch.Tensor,
                 spec: FieldSpec | None = None, mesh=None):
        """With `mesh`, the dense layers split on the batch axis and the
        toggle tensors (flags, fingerprints) on the hypercube axis T: the
        toggle rounds' work scales with T, not with the 2m batch."""
        self.spec = spec or fr_spec()
        self.mesh = mesh
        bits = flag_bits.to(device=fingerprints.device, dtype=torch.bool)
        values = _toggle_values_bits(self.spec, bits, fingerprints)
        self._flag_bits = _bitrev_last(bits)
        self.fingerprints = _bitrev_last(fingerprints)        # [16, 2m, T]
        self.real_batch = values.shape[1]
        if mesh is None:
            self.layers = _build_pair_tree(self.spec, values)
        else:
            self.layers = _build_sharded_tree(mesh, self.spec, values)
            self._flag_bits = sh.maybe_shard_hypercube(mesh, self._flag_bits)
            self.fingerprints = sh.maybe_shard_hypercube(mesh,
                                                         self.fingerprints)

    def claims(self) -> list[FElt]:
        return _pair_claims(self.spec, self.layers[-1], self.real_batch)

    def prove(self, transcript: Transcript
              ) -> tuple[BatchedGrandProductProof, list[FElt]]:
        spec = self.spec
        claims = self.claims()
        dev = self.fingerprints.device
        if self.mesh is None and _use_chain(dev):
            return self._prove_chained(transcript, claims)
        layer_proofs, r_grand_product, claims = _prove_dense_layers(
            spec, self.layers, claims, [], transcript)

        # toggle layer (grand_product.rs:1422-1474): log T rounds, no r_layer
        coeffs = transcript.challenge_vector(len(claims))
        previous_claim = FElt(0, spec)
        for c, co in zip(claims, coeffs):
            previous_claim = previous_claim + c * co
        coeffs_dev = fd.ints_to_device(spec, [c.v for c in coeffs], dev)
        eq = eq_evals_device_br(spec, r_grand_product, dev)
        fps = self.fingerprints
        if sh.is_sharded(fps):
            flags = self._flag_bits.map(lambda b: _expand_flag_bits(spec, b))
            eq = sh.shard_hypercube(self.mesh, eq)
        else:
            flags = _expand_flag_bits(spec, self._flag_bits)

        def toggle_evals(flags, fps, eq):
            return sh.round_evals(
                spec, lambda f, p, e, c: _toggle_cubic_evals(spec, f, p, e, c),
                (flags, fps, eq, coeffs_dev))

        r_sumcheck: list[FElt] = []
        compressed: list[CompressedUniPoly] = []
        if r_grand_product and _use_device_fs(dev):
            state = fsd.state_to_device(transcript, dev)
            prev = fd.scalar_to_device(spec, previous_claim.v, dev)
            comps = []
            for _ in range(len(r_grand_product)):
                e023 = toggle_evals(flags, fps, eq)
                comp, rj, prev, state = fsd.fs_round(spec, e023, prev, state,
                                                     3, True)
                flags, fps, eq = _toggle_bind(spec, flags, fps, eq, rj)
                comps.append(comp)
            compressed, r_sumcheck = fsd.replay_and_check(
                spec, fd.device_to_ints(spec, torch.stack(comps, dim=1))
                .tolist(), transcript, state, CompressedUniPoly,
                "ToggledGP::toggle")
        for _ in range(len(r_grand_product) - len(compressed)):
            e0, e2, e3 = _felts(spec, toggle_evals(flags, fps, eq))
            round_poly = UniPoly.from_evals([e0, previous_claim - e0, e2, e3])
            cpoly = round_poly.compress()
            cpoly.append_to_transcript(transcript)
            r_j = transcript.challenge_scalar()
            r_sumcheck.append(r_j)
            flags, fps, eq = _toggle_bind(
                spec, flags, fps, eq, fd.scalar_to_device(spec, r_j.v, dev))
            previous_claim = round_poly.evaluate(r_j)
            compressed.append(cpoly)

        finals = _felts(spec, torch.cat([sh.unshard(flags)[..., 0],
                                         sh.unshard(fps)[..., 0]], dim=1))
        m = flags.shape[1]
        flag_vals, fp_vals = finals[:m], finals[m:]
        left_claims = [flag_vals[b // 2] for b in range(len(fp_vals))]
        for lc, rc in zip(left_claims, fp_vals):
            transcript.append_scalar(lc)
            transcript.append_scalar(rc)
        layer_proofs.append(BatchedGrandProductLayerProof(
            SumcheckInstanceProof(compressed), left_claims, fp_vals))
        return BatchedGrandProductProof(layer_proofs), list(reversed(r_sumcheck))

    def _prove_chained(self, transcript: Transcript, claims: list[FElt]
                       ) -> tuple[BatchedGrandProductProof, list[FElt]]:
        """The dense layers and the toggle rounds enqueued on the device
        with no host sync; one pull and one host replay at the end."""
        spec = self.spec
        m = self.real_batch
        T = self.fingerprints.shape[-1]
        k_toggle = T.bit_length() - 1
        ops = (sum((1 << j) * (m * 7 + 4) for j in range(k_toggle - 1))
               + 2 * T * (m * 8 + 4))
        with span("ToggledGP::chained", ops=ops):
            # the last dense layer's K8 launch draws the toggle rounds'
            # challenge vector
            pend, (state, rs, claims_dev, coeffs) = _chain_prove_dense(
                spec, self.layers, transcript, n_after=m)
            # toggle rounds (grand_product.rs:1422-1474): log T rounds,
            # claims appended per (flag, fingerprint) pair, no r_layer
            prev = fsd.fold_claims_dev(spec, claims_dev, coeffs)
            eq = fsd.eq_masked_br(spec, rs, k_toggle)
            flags = _expand_flag_bits(spec, self._flag_bits)
            fps = self.fingerprints
            comps = []
            for _ in range(k_toggle):
                e023 = _toggle_cubic_evals(spec, flags, fps, eq, coeffs)
                comp, rj, prev, state = fsd.fs_round(spec, e023, prev, state,
                                                     3, True)
                flags, fps, eq = _toggle_bind(spec, flags, fps, eq, rj)
                comps.append(comp)
            inter = fsd.toggle_finals_dev(spec, flags, fps)
            state = fsd.append_scalars_dev(spec, state, inter, 2 * m)
            del flags, fps, eq

            comp_ints, row_ints = _chain_pull(spec, pend, comps, [inter])
            layer_proofs, _, _, idx = _chain_replay_dense(
                spec, pend, comp_ints, row_ints[:-1], claims, transcript)
            transcript.challenge_vector(m)
            compressed, r_sumcheck = [], []
            for row in comp_ints[idx:]:
                cpoly = CompressedUniPoly([FElt(int(v), spec) for v in row])
                cpoly.append_to_transcript(transcript)
                r_sumcheck.append(transcript.challenge_scalar())
                compressed.append(cpoly)
            row = row_ints[-1]
            left_claims = [FElt(int(row[2 * b]), spec) for b in range(m)]
            right_claims = [FElt(int(row[2 * b + 1]), spec)
                            for b in range(m)]
            for lc, rc in zip(left_claims, right_claims):
                transcript.append_scalar(lc)
                transcript.append_scalar(rc)
            _assert_chain_state(transcript, state, "ToggledGP::chained")
            layer_proofs.append(BatchedGrandProductLayerProof(
                SumcheckInstanceProof(compressed), left_claims, right_claims))
        return BatchedGrandProductProof(layer_proofs), list(reversed(r_sumcheck))


def toggled_verify_sumcheck_claim(layer_proof, coeffs, sumcheck_claim, eq_eval,
                                  claims, r_grand_product, transcript,
                                  layer_index: int, num_layers: int):
    """Toggled GP claim check (grand_product.rs:1486-1546): the last layer
    is the toggle layer, with no r_layer; the others are dense."""
    if layer_index != num_layers - 1:
        return default_verify_sumcheck_claim(
            layer_proof, coeffs, sumcheck_claim, eq_eval, claims,
            r_grand_product, transcript, layer_index, num_layers)
    one = FElt(1, sumcheck_claim.spec)
    gates = [fl * fp + one - fl for fl, fp in zip(layer_proof.left_claims,
                                                 layer_proof.right_claims)]
    expected = FElt(0, sumcheck_claim.spec)
    for co, g in zip(coeffs, gates):
        expected = expected + co * eq_eval * g
    if expected != sumcheck_claim:
        raise VerificationError("toggle layer claim mismatch")
    return gates, r_grand_product


# ---------------------------------------------------------------------------
# verifier (host)
# ---------------------------------------------------------------------------

def default_verify_sumcheck_claim(layer_proof: BatchedGrandProductLayerProof,
                                  coeffs: list[FElt], sumcheck_claim: FElt,
                                  eq_eval: FElt, claims: list[FElt],
                                  r_grand_product: list[FElt],
                                  transcript: Transcript,
                                  layer_index: int = 0, num_layers: int = 0
                                  ) -> tuple[list[FElt], list[FElt]]:
    """Multiplication-gate layer claim check (grand_product.rs:89-122)."""
    spec = sumcheck_claim.spec
    expected = FElt(0, spec)
    for co, lc, rc in zip(coeffs, layer_proof.left_claims,
                          layer_proof.right_claims):
        expected = expected + co * lc * rc * eq_eval
    if expected != sumcheck_claim:
        raise VerificationError("grand product layer claim mismatch")

    r_layer = transcript.challenge_scalar()
    new_claims = [lc + r_layer * (rc - lc)
                  for lc, rc in zip(layer_proof.left_claims,
                                    layer_proof.right_claims)]
    return new_claims, r_grand_product + [r_layer]


def verify_grand_product(proof: BatchedGrandProductProof,
                         claims: Sequence[FElt],
                         transcript: Transcript,
                         r_start: Sequence[FElt] = (),
                         verify_sumcheck_claim: Callable = default_verify_sumcheck_claim,
                         ) -> tuple[list[FElt], list[FElt]]:
    """Layer-by-layer verification (grand_product.rs:122-182).

    Returns (final claims = leaf-MLE evaluations, r_grand_product)."""
    claims_to_verify = list(claims)
    r_grand_product = list(r_start)
    fixed_at_start = len(r_start)
    spec = claims_to_verify[0].spec
    one = FElt(1, spec)

    for layer_index, layer_proof in enumerate(proof.layers):
        coeffs = transcript.challenge_vector(len(claims_to_verify))
        joint_claim = FElt(0, spec)
        for c, co in zip(claims_to_verify, coeffs):
            joint_claim = joint_claim + c * co

        sumcheck_claim, r_sumcheck = layer_proof.proof.verify(
            joint_claim, layer_index + fixed_at_start, 3, transcript)
        if len(claims_to_verify) != len(layer_proof.left_claims):
            raise VerificationError("grand product layer has the wrong batch")

        for lc, rc in zip(layer_proof.left_claims, layer_proof.right_claims):
            transcript.append_scalar(lc)
            transcript.append_scalar(rc)

        if len(r_grand_product) != len(r_sumcheck):
            raise VerificationError("grand product layer has the wrong rounds")
        eq_eval = one
        for r_gp, r_sc in zip(r_grand_product, reversed(r_sumcheck)):
            eq_eval = eq_eval * (r_gp * r_sc + (one - r_gp) * (one - r_sc))

        r_grand_product = list(reversed(r_sumcheck))
        claims_to_verify, r_grand_product = verify_sumcheck_claim(
            layer_proof, coeffs, sumcheck_claim, eq_eval, claims_to_verify,
            r_grand_product, transcript, layer_index, len(proof.layers))

    return claims_to_verify, r_grand_product
