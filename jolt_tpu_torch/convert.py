"""Carrying state between jolt_tpu and the port, through numpy.

jolt_tpu keeps field elements as uint32[16, ...] limb arrays; the port as
int32 tensors holding the same values below 2^16.  Converting is a dtype
cast.  The tests use these to feed both packages the same SRS and inputs.
"""
from __future__ import annotations

import numpy as np
import torch

from .commitment.kzg import KZGProverKey


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


def prover_key_from_numpy(X, Y, Z, device="cpu") -> KZGProverKey:
    """jolt_tpu's KZGProverKey.g1_jac (X, Y, Z) as numpy -> the port's key."""
    pts = tuple(limbs_from_numpy(t, device) for t in (X, Y, Z))
    return KZGProverKey(pts, pts[0].shape[-1])
