"""Carrying state between jolt_tpu and the port, through numpy.

jolt_tpu keeps field elements as uint32[16, ...] limb arrays; the port as
int32 tensors holding the same values below 2^16.  Converting is a dtype
cast.  The tests use these to feed both packages the same SRS and inputs,
and the commitment schemes' proofs and commitments as bytes (below) to
hand one package's proof to the other's verifier.
"""
from __future__ import annotations

import numpy as np
import torch

from .commitment.hyrax import (BatchedHyraxOpeningProof, HyraxCommitment,
                               HyraxOpeningProof)
from .commitment.kzg import KZGProverKey
from .commitment.zeromorph import ZeromorphCommitment, ZeromorphProof
from .curve.bn254 import G1Affine
from .field.host import FElt
from .field.spec import fr_spec


def limbs_from_numpy(a, device="cpu") -> torch.Tensor:
    """jolt_tpu's uint32[16, ...] limbs (any array-like) -> int32 tensor."""
    arr = np.asarray(a)
    if arr.size and int(arr.max()) >= 1 << 16:
        raise ValueError("limb values must be below 2^16")
    return torch.from_numpy(np.ascontiguousarray(arr).astype(np.int32)).to(
        device)


def limbs_to_numpy(t: torch.Tensor) -> np.ndarray:
    """The port's int32 limbs -> jolt_tpu's uint32[16, ...] layout."""
    return t.detach().cpu().numpy().astype(np.uint32)


def fs_state_from_jax(words, n_rounds, device="cpu") -> torch.Tensor:
    """jolt_tpu's device transcript state (the state's LE uint32[8] words
    and its uint32 count, as numpy or array-likes) -> the port's int64 [9]
    state tensor (subprotocols/fs_device.py)."""
    w = np.asarray(words, dtype=np.uint32).reshape(8).astype(np.int64)
    n = int(np.asarray(n_rounds, dtype=np.uint32))
    return torch.tensor([*w.tolist(), n], dtype=torch.int64, device=device)


def prover_key_from_numpy(X, Y, Z, device="cpu") -> KZGProverKey:
    """jolt_tpu's KZGProverKey.g1_jac (X, Y, Z) as numpy -> the port's key."""
    pts = tuple(limbs_from_numpy(t, device) for t in (X, Y, Z))
    return KZGProverKey(pts, pts[0].shape[-1])


# ---------------------------------------------------------------------------
# commitment-scheme state as plain numbers: a G1 point is 64 bytes, x || y
# big-endian (zeros at infinity, which is not on the curve); a scalar is 32
# bytes big-endian.  The `*_to_numpy` functions read only .x, .y,
# .is_infinity and .v, so they take jolt_tpu's objects as well as the
# port's.
# ---------------------------------------------------------------------------

def points_to_numpy(points) -> np.ndarray:
    """Affine G1 points -> uint8 [k, 64]."""
    out = np.zeros((len(points), 64), dtype=np.uint8)
    for i, p in enumerate(points):
        if not p.is_infinity:
            out[i] = np.frombuffer(int(p.x).to_bytes(32, "big")
                                   + int(p.y).to_bytes(32, "big"), np.uint8)
    return out


def points_from_numpy(a) -> list[G1Affine]:
    """uint8 [k, 64] -> the port's affine G1 points."""
    out = []
    for row in np.asarray(a, dtype=np.uint8).reshape(-1, 64):
        b = row.tobytes()
        x, y = int.from_bytes(b[:32], "big"), int.from_bytes(b[32:], "big")
        out.append(G1Affine.identity() if x == y == 0 else G1Affine(x, y))
    return out


def scalars_to_numpy(scalars) -> np.ndarray:
    """Field elements (.v) or ints -> uint8 [k, 32]."""
    vals = [int(getattr(s, "v", s)) for s in scalars]
    return np.frombuffer(b"".join(v.to_bytes(32, "big") for v in vals),
                         np.uint8).reshape(len(vals), 32)


def scalars_from_numpy(a) -> list[int]:
    return [int.from_bytes(row.tobytes(), "big")
            for row in np.asarray(a, dtype=np.uint8).reshape(-1, 32)]


def zeromorph_proof_to_numpy(proof) -> dict:
    """A ZeromorphProof (either package's) -> {pi, q_hat_com, q_k_com}."""
    return {"pi": points_to_numpy([proof.pi]),
            "q_hat_com": points_to_numpy([proof.q_hat_com]),
            "q_k_com": points_to_numpy(proof.q_k_com)}


def zeromorph_proof_from_numpy(pi, q_hat_com, q_k_com) -> ZeromorphProof:
    return ZeromorphProof(points_from_numpy(pi)[0],
                          points_from_numpy(q_hat_com)[0],
                          points_from_numpy(q_k_com))


def zeromorph_commitment_from_numpy(a) -> ZeromorphCommitment:
    return ZeromorphCommitment(points_from_numpy(a)[0])


def hyrax_commitment_from_numpy(rows) -> HyraxCommitment:
    return HyraxCommitment(points_from_numpy(rows))


def hyrax_proof_from_numpy(vmp) -> HyraxOpeningProof:
    return HyraxOpeningProof([FElt(v, fr_spec())
                              for v in scalars_from_numpy(vmp)])


def batched_hyrax_proof_from_numpy(vmp, ratio: int
                                   ) -> BatchedHyraxOpeningProof:
    return BatchedHyraxOpeningProof(hyrax_proof_from_numpy(vmp), int(ratio))
