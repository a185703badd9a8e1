"""BN254 field arithmetic over limb tensors in PyTorch.

A field array of logical shape `s` is an int32 tensor of shape ``(16,) + s``
holding 16-bit little-endian limbs in Montgomery form (R = 2^256), limbs
first -- jolt_tpu/field/device.py's layout, so converting between the two
packages is a dtype cast (see convert.py).

`fmul` is the Montgomery product: on a CUDA tensor it launches the
hand-written kernel (kernels.mont_mul), on a CPU tensor it runs its plain
version.  Add, subtract and sum are plain tensor code (arith.py).
"""
from __future__ import annotations

import numpy as np
import torch

from . import arith, kernels
from .spec import FieldSpec, LIMB_BITS, LIMB_MASK, NUM_LIMBS

L = NUM_LIMBS
W = LIMB_BITS


def fadd(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return arith.add(spec, a, b)


def fsub(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return arith.sub(spec, a, b)


def fneg(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return fsub(spec, torch.zeros_like(a), a)


def fmul(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product (a * b * R^{-1}) mod p, both operands Montgomery."""
    return kernels.mont_mul(spec, a, b)


def fsum(spec: FieldSpec, a: torch.Tensor, axis: int) -> torch.Tensor:
    """Modular sum along a logical axis (see arith.sum_limbs)."""
    return arith.sum_limbs(spec, a, axis, fmul)


def _const(spec: FieldSpec, name: str, like: torch.Tensor) -> torch.Tensor:
    """A constant of `spec` as [16, 1, ...] to broadcast against `like`."""
    return arith.const_limbs(spec, name, like.device).reshape(
        (L,) + (1,) * (like.dim() - 1))


def from_mont_device(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Montgomery -> canonical residue: REDC(a) = a * 1 * R^{-1}."""
    return fmul(spec, a, _const(spec, "one", a))


def to_mont_device(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Canonical residue limbs -> Montgomery form (times R^2, REDC)."""
    return fmul(spec, a, _const(spec, "r2", a))


def col(t: torch.Tensor, i: int, axis: int = 1) -> torch.Tensor:
    return t.select(axis, i)


# ---------------------------------------------------------------------------
# host <-> device conversion
# ---------------------------------------------------------------------------

def pack_ints(values, shape=None) -> np.ndarray:
    """Python ints in [0, 2^256) -> canonical limb array int64[16, *shape]."""
    arr = np.asarray(values, dtype=object)
    if shape is None:
        shape = arr.shape
    flat = [int(v) for v in arr.ravel().tolist()]
    buf = b"".join(v.to_bytes(32, "little") for v in flat)
    limbs = np.frombuffer(buf, dtype="<u2").reshape(len(flat), L).T
    return np.ascontiguousarray(limbs, dtype=np.int64).reshape(
        (L,) + tuple(shape))


def unpack_ints(limbs) -> np.ndarray:
    """Canonical limb array [16, *shape] -> numpy object array of ints."""
    limbs = np.asarray(limbs)
    shape = limbs.shape[1:]
    cols = np.ascontiguousarray(limbs.reshape(L, -1).T.astype("<u2"))
    out = np.empty(cols.shape[0], dtype=object)
    for j in range(cols.shape[0]):
        out[j] = int.from_bytes(cols[j].tobytes(), "little")
    return out.reshape(shape) if shape else out


def u64_to_mont_device(spec: FieldSpec, vals, device) -> torch.Tensor:
    """u64 host values -> Montgomery limb tensor: 8 bytes per value go up,
    the limbs are cut and converted on the device."""
    v = np.ascontiguousarray(np.asarray(vals, dtype=np.uint64))
    words = np.stack([v & np.uint64(0xFFFFFFFF), v >> np.uint64(32)])
    words = torch.from_numpy(words.astype(np.int64)).to(device)
    limbs = torch.zeros((L,) + v.shape, dtype=torch.int32, device=device)
    limbs[0] = words[0] & LIMB_MASK
    limbs[1] = words[0] >> W
    limbs[2] = words[1] & LIMB_MASK
    limbs[3] = words[1] >> W
    return to_mont_device(spec, limbs)


def scalar_to_device(spec: FieldSpec, x: int, device) -> torch.Tensor:
    """Single host int -> Montgomery limb vector int32[16]."""
    limbs = pack_ints([spec.to_mont(x % spec.p)])[:, 0]
    return torch.from_numpy(limbs.astype(np.int32)).to(device)


def ints_to_device(spec: FieldSpec, values, device, shape=None
                   ) -> torch.Tensor:
    """Host ints -> device Montgomery limbs (conversion done on device)."""
    arr = np.asarray(values, dtype=object)
    if shape is None:
        shape = arr.shape
    canonical = pack_ints([int(v) % spec.p for v in arr.ravel().tolist()],
                          shape=shape)
    return to_mont_device(
        spec, torch.from_numpy(canonical.astype(np.int32)).to(device))


def device_to_ints(spec: FieldSpec, a: torch.Tensor) -> np.ndarray:
    """Device Montgomery limbs -> host numpy object array of canonical ints."""
    return unpack_ints(from_mont_device(spec, a).cpu().numpy())


def to_int(spec: FieldSpec, a: torch.Tensor) -> int:
    """Device Montgomery limb vector [16] -> single canonical host int."""
    return int(np.asarray(device_to_ints(spec, a)).item())


def zeros(spec: FieldSpec, shape, device) -> torch.Tensor:
    return torch.zeros((L,) + tuple(shape), dtype=torch.int32, device=device)


def ones(spec: FieldSpec, shape, device) -> torch.Tensor:
    one = arith.const_limbs(spec, "r", torch.device(device))
    return one.reshape((L,) + (1,) * len(shape)).expand(
        (L,) + tuple(shape)).contiguous()
