"""The multi-device prover: tensors split over a mesh of devices
(jolt_tpu/parallel/sharding.py).

One process drives every device of the mesh (jolt_tpu's single-controller
model; no torch.distributed).  A sharded tensor is its per-device pieces
plus the layout that gathers them back.  Three scaling axes:

* **Grand products**: the BATCH axis.  A Jolt memory-checking grand
  product batches tens of independent circuits; each device owns a block
  of them, builds their product trees, and binds them locally (K2, K3 and
  K4 per shard).  Only the tiny [16, 3] round evaluations cross devices:
  gathered to the mesh's first device and folded MODULARLY (`fd.fadd`; a
  plain add of limb tensors is not addition mod p).  Batches are
  zero-padded to a multiple of the mesh size; the pad rows get zero
  batching coefficients, so no round sum sees them.
* **Sumchecks**: the HYPERCUBE axis.  Each round's evaluations are per
  shard plus one modular fold; the binds stay local.  Which layout keeps a
  bind's pairs on one shard depends on the binding order:
    - top binding (`bind_top`, pairs (i, i + n/2)) takes the CYCLIC
      layout: shard j holds the indices = j mod D, so i and i + n/2 lie on
      one shard while n/2 is a multiple of D, and the shard's own top bind
      is the global one;
    - bottom binding (`bind_bot`, pairs (2i, 2i + 1)) takes the BLOCK
      layout: shard j holds [j n/D, (j + 1) n/D).
  Once n < 2D a shard holds fewer than a pair, and the tensors are
  gathered to the first device and go on unsharded (jolt_tpu's tensors
  degrade to replication there).  The transcript depends only on the
  folded sums, so every layout gives the same bytes.
* **MSM**: the POINT axis.  Each shard folds its slice of the points (the
  bitplane fold's K5, the window MSM's K6 scans); the [16, K] per-shard
  partials are gathered and folded as a tree of Jacobian adds (K6).

The transcript stays on the first device (or the host), as in jolt_tpu:
device Fiat-Shamir's K9 takes the folded evaluations there, and each shard
gets the round challenge as a 64-byte copy, not a host sync.

A *virtual* mesh puts every shard on one device (`make_mesh(4,
device="cpu")` or `device="cuda:0"`): the counterpart of jolt_tpu's
`--xla_force_host_platform_device_count` CPU mesh, which its tests use.
Its shards are views or copies on that device, and every step runs once
per shard, as it would on a real mesh.
"""
from __future__ import annotations

import sys
from dataclasses import dataclass

import torch

from .._device import resolve_device
from ..curve import device as cd
from ..field import device as fd
from ..field import kernels as fk
from ..field.spec import FieldSpec, fr_spec

LAYOUTS = ("block", "cyclic", "replicated")


class Mesh:
    """An ordered tuple of devices with an axis name.  Every device is of
    one type; a device may repeat (a virtual mesh)."""

    def __init__(self, devices, axis: str = "hc"):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        types = {d.type for d in self.devices}
        if len(types) != 1:
            raise ValueError(f"a mesh mixes device types {sorted(types)}: "
                             "its shards would meet in one kernel launch")
        if types == {"cuda"}:
            if not torch.cuda.is_available():
                raise RuntimeError("a CUDA mesh needs a CUDA device, and "
                                   "none is available")
            for d in self.devices:
                if d.index is None or d.index >= torch.cuda.device_count():
                    raise ValueError(f"mesh device {d} is not available "
                                     f"({torch.cuda.device_count()} cards)")
        elif types != {"cpu"}:
            raise ValueError(f"unsupported mesh devices {sorted(types)}")
        self.axis = axis

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def first(self) -> torch.device:
        return self.devices[0]

    @property
    def virtual(self) -> bool:
        """Every shard on one device."""
        return len(set(self.devices)) == 1

    def __repr__(self) -> str:
        kind = "virtual " if self.virtual and self.size > 1 else ""
        return f"Mesh({kind}{[str(d) for d in self.devices]}, {self.axis!r})"


def check_first(mesh: Mesh, device) -> None:
    """Raise unless `device` (a prover's tensors' device) is the mesh's
    first device, where the transcript and the folds live."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev != mesh.first:
        raise ValueError(f"{mesh} does not start on the prover's device "
                         f"{dev}")


def make_mesh(n_devices: int | None = None, axis: str = "hc",
              device=None) -> Mesh:
    """The first `n_devices` CUDA devices (all of them by default).  With
    one `device`, a virtual mesh of `n_devices` shards on it.  Raises
    where the devices are not there: nothing slides to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device is available; "
                               "pass device='cpu' for a virtual mesh on the "
                               "CPU")
        count = torch.cuda.device_count()
        n = count if n_devices is None else n_devices
        if not 1 <= n <= count:
            raise ValueError(f"make_mesh: {n} devices asked for, {count} "
                             "available")
        return Mesh([torch.device("cuda", i) for i in range(n)], axis)
    if n_devices is None or n_devices < 1:
        raise ValueError("make_mesh: a virtual mesh needs n_devices >= 1")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh([dev] * n_devices, axis)


@dataclass(frozen=True)
class Sharded:
    """A tensor split over a mesh along `dim`: the per-shard tensors, each
    on its shard's device, in the `layout` that gathers them back
    ("block", "cyclic", or "replicated": every shard holds the whole).
    `real` is the extent along `dim` before zero padding."""

    mesh: Mesh
    shards: tuple
    dim: int
    layout: str
    real: int

    def __post_init__(self):
        if self.layout not in LAYOUTS:
            raise ValueError(f"unknown layout {self.layout!r}")
        if len(self.shards) != self.mesh.size:
            raise ValueError(f"{len(self.shards)} shards on a mesh of "
                             f"{self.mesh.size}")
        for t, d in zip(self.shards, self.mesh.devices):
            if t.device != d:
                raise ValueError(f"a shard on {t.device} where the mesh "
                                 f"puts it on {d}")

    @property
    def local(self) -> int:
        """One shard's extent along `dim`."""
        return self.shards[0].shape[self.dim]

    @property
    def length(self) -> int:
        """The global extent along `dim` (pad rows included)."""
        if self.layout == "replicated":
            return self.local
        return self.local * self.mesh.size

    @property
    def device(self) -> torch.device:
        return self.mesh.first

    def gather(self) -> torch.Tensor:
        """The whole tensor on the mesh's first device."""
        first = self.mesh.first
        if self.layout == "replicated":
            return self.shards[0]
        parts = [t.to(first) for t in self.shards]
        if self.layout == "block":
            return torch.cat(parts, dim=self.dim)
        # cyclic: global index k D + j is shard j's index k
        return torch.stack(parts, dim=-1).flatten(-2)

    def map(self, fn) -> "Sharded":
        """fn applied to every shard (local work: the layout is kept)."""
        return Sharded(self.mesh, tuple(fn(t) for t in self.shards),
                       self.dim, self.layout, self.real)


def is_sharded(x) -> bool:
    return isinstance(x, Sharded)


def _place(mesh: Mesh, arr: torch.Tensor, dim: int, layout: str,
           real: int | None = None) -> Sharded:
    D = mesh.size
    n = arr.shape[dim]
    if layout == "replicated":
        shards = [arr.to(d) for d in mesh.devices]
    else:
        if n % D:
            raise ValueError(f"axis of {n} does not split over {D} shards")
        if layout == "block":
            parts = arr.chunk(D, dim=dim)
        else:
            if dim not in (-1, arr.dim() - 1):
                raise ValueError("a cyclic layout splits the last axis")
            parts = [arr[..., j::D] for j in range(D)]
        shards = [p.to(d).contiguous() for p, d in zip(parts, mesh.devices)]
    return Sharded(mesh, tuple(shards), dim, layout,
                   n if real is None else real)


def shard_hypercube(mesh: Mesh, arr: torch.Tensor,
                    layout: str = "cyclic") -> Sharded:
    """A [16, ..., n] limb tensor with its hypercube (last) axis split:
    cyclic for top binding, block for bottom binding."""
    return _place(mesh, arr, -1, layout)


def shard_batch(mesh: Mesh, arr: torch.Tensor,
                real: int | None = None) -> Sharded:
    """A batch-leading [B, 16, s] pair tensor with B split in blocks (B a
    multiple of the mesh size: `pad_batch_to` first)."""
    return _place(mesh, arr, 0, "block", real)


def replicate(mesh: Mesh, arr: torch.Tensor) -> Sharded:
    """The whole tensor on every shard (eq of a batch-sharded GP round)."""
    return _place(mesh, arr, -1, "replicated")


# ---------------------------------------------------------------------------
# batch axis: grand products
# ---------------------------------------------------------------------------

def pad_batch_to(arr: torch.Tensor, n_dev: int, dim: int = 0
                 ) -> torch.Tensor:
    """Zero rows on the batch axis `dim` up to a multiple of n_dev.

    0 is a valid field element, so the pad rows flow through the product
    and bind kernels unchanged; the provers give them zero batching
    COEFFICIENTS, which zeroes their part of every round evaluation."""
    B = arr.shape[dim]
    Bp = -(-B // n_dev) * n_dev
    if Bp == B:
        return arr
    shape = list(arr.shape)
    shape[dim] = Bp - B
    return torch.cat([arr, arr.new_zeros(shape)], dim=dim)


def maybe_shard_pair(mesh: Mesh, pair: tuple,
                     real: int | None = None) -> tuple:
    """A (l, r) pair layer [B, 16, s] split on the batch axis, the batch
    zero-padded to the mesh size: never replicated in silence."""
    l, r = pair
    real = l.shape[0] if real is None else real
    D = mesh.size
    return (shard_batch(mesh, pad_batch_to(l, D), real),
            shard_batch(mesh, pad_batch_to(r, D), real))


def shard_gp_pair_layers(mesh: Mesh, layers: list,
                         real: int | None = None) -> list:
    """A dense GP's pair layers, each split on the batch axis."""
    return [maybe_shard_pair(mesh, pair, real) for pair in layers]


def shard_leaves(mesh: Mesh, leaves: torch.Tensor) -> list:
    """Interleaved GP leaves [16, B, n], zero-padded on the batch to the
    mesh size, as one [16, B/D, n] block per shard on its device (each
    shard then builds its circuits' product trees)."""
    D = mesh.size
    padded = pad_batch_to(leaves, D, dim=1)
    return [p.to(d) for p, d in zip(padded.chunk(D, dim=1), mesh.devices)]


def fold_evals(mesh: Mesh, spec: FieldSpec, parts) -> torch.Tensor:
    """Per-shard round evaluations [16, k] -> their sum mod p [16, k] on
    the mesh's first device: D - 1 modular adds, which for a few shards
    issue fewer small ops than one `fd.fsum` (its wide reduction is five
    conditional subtractions and a product)."""
    first = mesh.first
    acc = parts[0].to(first)
    for p in parts[1:]:
        acc = fd.fadd(spec, acc, p.to(first))
    return acc


def to_shards(mesh: Mesh, t: torch.Tensor) -> list:
    """A small tensor (a round challenge) copied to every shard's device."""
    return [t.to(d, non_blocking=True) for d in mesh.devices]


def gp_round_evals(mesh: Mesh, spec: FieldSpec, l: Sharded, r: Sharded,
                   eq: Sharded, coeffs: torch.Tensor) -> torch.Tensor:
    """A batch-sharded GKR round's evaluations at t = 0, 2, 3 -> [16, 3]
    on the first device: K2 on each shard's circuits with its slice of
    the coefficients [16, B] (pad rows 0), folded mod p."""
    b = l.local
    parts = [fk.gp_pair_evals(spec, l.shards[j], r.shards[j], eq.shards[j],
                              coeffs[:, j * b:(j + 1) * b].to(d))
             for j, d in enumerate(mesh.devices)]
    return fold_evals(mesh, spec, parts)


def gp_round_bind(mesh: Mesh, spec: FieldSpec, l: Sharded, r: Sharded,
                  eq: Sharded, r_chal: torch.Tensor):
    """Bind every shard's pair layers and eq copy to the round challenge
    (K3 per shard) -> (l', r', eq')."""
    # a host challenge goes to K3 by value; a device one is copied over
    rcs = [r_chal] * mesh.size if r_chal.device.type == "cpu" \
        else to_shards(mesh, r_chal)
    outs = [fk.gp_pair_bind(spec, l.shards[j], r.shards[j], eq.shards[j], rc)
            for j, rc in enumerate(rcs)]
    return tuple(Sharded(mesh, tuple(o[i] for o in outs), x.dim, x.layout,
                         x.real) for i, x in enumerate((l, r, eq)))


def sharded_gp_round(mesh: Mesh, spec: FieldSpec, l: Sharded, r: Sharded,
                     eq, coeffs: torch.Tensor, r_chal: torch.Tensor):
    """One full sharded GKR round over bit-reversed pair layers.

    l, r: [B, 16, s] split on the batch axis; eq: [16, s] (a tensor, or a
    replicated Sharded); coeffs: [16, B] on the first device (pad rows 0);
    r_chal: [16], the round challenge (in the protocol it follows from the
    evaluations through the transcript; here it is given, to run the
    dataflow in one step).  Returns (evals [16, 3] on the first device,
    bound l and r, bound eq replicated)."""
    if not is_sharded(eq):
        eq = replicate(mesh, eq)
    evals = gp_round_evals(mesh, spec, l, r, eq, coeffs)
    return (evals, *gp_round_bind(mesh, spec, l, r, eq, r_chal))


def batch_finals(pair: tuple, real: int) -> tuple:
    """A bound pair layer's per-circuit values (l[b, :, 0], r[b, :, 0])
    over the real circuits, as [16, real] each on the first device."""
    out = []
    for x in pair:
        if is_sharded(x):
            x = torch.cat([t[..., 0].to(x.mesh.first) for t in x.shards])
        else:
            x = x[..., 0]
        out.append(x[:real].T)
    return tuple(out)


# ---------------------------------------------------------------------------
# hypercube axis: sumchecks
# ---------------------------------------------------------------------------

BIND_LAYOUT = {"top": "cyclic", "bot": "block"}


def round_evals(spec: FieldSpec, fn, tensors) -> torch.Tensor:
    """fn(*tensors) -> [16, k], per shard and folded mod p where the
    tensors are sharded (the mesh's first device), else fn itself.  A
    tensor that is not sharded goes whole to every shard's device."""
    sh = [t for t in tensors if is_sharded(t)]
    if not sh:
        return fn(*tensors)
    mesh = sh[0].mesh
    parts = [fn(*[t.shards[j] if is_sharded(t) else t.to(d)
                  for t in tensors])
             for j, d in enumerate(mesh.devices)]
    return fold_evals(mesh, spec, parts)


def bind_hypercube(spec: FieldSpec, tensors, r: torch.Tensor, bind_fn,
                   order: str = "top"):
    """Bind every tensor's hypercube axis with bind_fn(spec, t, r), shard
    by shard where it is sharded (its layout must keep `order`'s pairs
    local), then gather the sharded ones once fewer than two entries are
    left on a shard.  Returns a tuple."""
    sh = [t for t in tensors if is_sharded(t)]
    if not sh:
        return tuple(bind_fn(spec, t, r) for t in tensors)
    mesh = sh[0].mesh
    rs = to_shards(mesh, r)
    out = []
    for t in tensors:
        if not is_sharded(t):
            out.append(bind_fn(spec, t, r))
            continue
        if t.layout != BIND_LAYOUT[order]:
            raise ValueError(f"a {t.layout} layout does not keep {order} "
                             f"binding's pairs on one shard")
        b = Sharded(mesh, tuple(bind_fn(spec, s, rj)
                                for s, rj in zip(t.shards, rs)),
                    t.dim, t.layout, t.real // 2)
        out.append(b.gather() if b.local < 2 else b)
    return tuple(out)


def unshard(t):
    """A sharded tensor gathered to the first device; a tensor as it is."""
    return t.gather() if is_sharded(t) else t


def maybe_shard_hypercube(mesh: Mesh | None, arr: torch.Tensor,
                          order: str = "top"):
    """ONE MLE limb tensor [16, ..., n] split on its hypercube (last) axis
    in the layout `order`'s binding keeps local; the tensor itself when
    mesh is None; replicated, LOUDLY, when n does not split into at least
    two entries a shard (it stays whole on the first device)."""
    if mesh is None:
        return arr
    return shard_sumcheck_polys(mesh, [arr], order)[0]


def shard_sumcheck_polys(mesh: Mesh, polys, order: str = "top") -> tuple:
    """Sumcheck MLE limb tensors [16, ..., n] with the HYPERCUBE axis n
    split across the mesh, cyclic for top binding and block for bottom
    binding (`order`).  Round evaluations run per shard and fold mod p;
    binds stay local until n < 2 D, when the tensors are gathered.
    Tensors too small to split (n < 2 D, or n not a multiple of D) stay
    whole on the first device, and that is logged to stderr."""
    D = mesh.size
    out = []
    for p in polys:
        n = p.shape[-1]
        if n % D == 0 and n >= 2 * D:
            out.append(shard_hypercube(mesh, p, BIND_LAYOUT[order]))
        else:
            print(f"[sharding] hypercube axis {n} does not split over mesh "
                  f"size {D}; replicating", file=sys.stderr)
            out.append(p.to(mesh.first))
    return tuple(out)


# ---------------------------------------------------------------------------
# point axis: MSMs
# ---------------------------------------------------------------------------

def proj_to_jac(X, Y, Z):
    """Projective (X : Y : Z) -> Jacobian (X Z, Y Z^2, Z) on the device;
    the identity (0 : 1 : 0) becomes Z = 0, Jacobian infinity."""
    FQ = cd.FQ
    return (fd.fmul(FQ, X, Z), fd.fmul(FQ, Y, fd.fmul(FQ, Z, Z)), Z)


def fold_points(mesh: Mesh, parts) -> tuple:
    """Per-shard Jacobian partials (X, Y, Z) [16, ...] -> their sum on the
    first device, a tree of Jacobian adds (K6) over the shard axis."""
    first = mesh.first
    g = tuple(torch.stack([p[i].to(first) for p in parts], dim=-1)
              for i in range(3))
    while g[0].shape[-1] > 1:
        D = g[0].shape[-1]
        h = D // 2
        s = cd.jac_add(tuple(t[..., :h].contiguous() for t in g),
                       tuple(t[..., h:2 * h].contiguous() for t in g))
        if D % 2:
            s = tuple(torch.cat([a, t[..., 2 * h:]], dim=-1)
                      for a, t in zip(s, g))
        g = s
    return tuple(t[..., 0].contiguous() for t in g)


def jac_to_proj(X, Y, Z):
    """Jacobian (X, Y, Z) -> projective (X Z : Y : Z^3) on the device, the
    form curve/device.py masked_fold returns; Z = 0 stays the identity."""
    FQ = cd.FQ
    return (fd.fmul(FQ, X, Z), Y, fd.fmul(FQ, Z, fd.fmul(FQ, Z, Z)))


def points_split(mesh: Mesh | None, n: int) -> bool:
    """Whether an MSM over n points splits over the mesh: n a multiple of
    the mesh size (jolt_tpu's rule), with more than one shard."""
    return mesh is not None and mesh.size > 1 and n % mesh.size == 0


def sharded_masked_fold(mesh: Mesh, PX, PY, PZ, masks: torch.Tensor):
    """The bitplane fold (curve/device.py masked_fold, the production
    commit path) with the point axis split in blocks: each shard folds its
    slice (K5), and the [16, K] partials fold across shards with K6.  The
    `fold` that commitment/kzg.py kzg_commit_batch gives batch_msm_bitplane
    on a mesh.  Returns projective (X, Y, Z) [16, K] on the first device,
    as masked_fold does; a point count that does not split over the mesh
    folds whole there (jolt_tpu leaves such tensors unsharded)."""
    n = PX.shape[-1]
    if not points_split(mesh, n):
        return cd.masked_fold(PX, PY, PZ, masks)
    b = n // mesh.size
    parts = []
    for j, d in enumerate(mesh.devices):
        sl = slice(j * b, (j + 1) * b)
        px, py, pz = (t[:, sl].to(d) for t in (PX, PY, PZ))
        parts.append(proj_to_jac(*cd.masked_fold(px, py, pz,
                                                 masks[:, sl].to(d))))
    return jac_to_proj(*fold_points(mesh, parts))


def sharded_msm_windows(mesh: Mesh, points_jac, scalar_limbs: torch.Tensor,
                        n_windows: int | None = None):
    """A windowed MSM's bit-plane sums over a sharded point/scalar set.

    Each shard sorts ITS points by digit and sums its buckets (K6 scans,
    curve/device.py _msm_bit_sums); the per-shard sums are gathered and
    folded with Jacobian adds.  points_jac: (X, Y, Z) [16, N];
    scalar_limbs: CANONICAL Fr limbs [16, N] or [16, R, N], split in
    blocks of N / D.  n_windows must be a global bound (the same on every
    shard).  Returns Jacobian (X, Y, Z) [16, c W, R] on the first device:
    entry j of row r is the sum of the points whose scalar has bit j set
    (jolt_tpu returns the [L, W] window totals; the port's windowed MSM
    takes sum_d d B_d bit plane by bit plane)."""
    canon = scalar_limbs if scalar_limbs.dim() == 3 else scalar_limbs[:, None]
    N = canon.shape[-1]
    if N % mesh.size:
        raise ValueError(f"{N} points do not split over {mesh.size} shards")
    W = n_windows or cd.scalar_max_windows(canon)
    b = N // mesh.size
    parts = []
    for j, d in enumerate(mesh.devices):
        sl = slice(j * b, (j + 1) * b)
        px, py, pz = (t[:, sl].to(d).contiguous() for t in points_jac)
        parts.append(cd._msm_bit_sums(px, py, pz, canon[..., sl].to(d), W))
    return fold_points(mesh, parts)


def sharded_msm(mesh: Mesh, points_jac, scalars_mont: torch.Tensor,
                spec_fr: FieldSpec | None = None):
    """A full sharded windowed MSM -> host G1Affine: bit-plane sums per
    shard, folded across shards (K6), then Horner over the bits (K7 and
    K6 on the card, the host on the CPU)."""
    spec_fr = spec_fr or fr_spec()
    N = scalars_mont.shape[-1]
    pts = tuple(t[:, :N] for t in points_jac)
    canon = fd.from_mont_device(spec_fr, scalars_mont.to(mesh.first))
    S = sharded_msm_windows(mesh, pts, canon)
    if mesh.first.type == "cuda":
        acc = cd.jacobian_to_host(*cd._horner_device(S))[0]
    else:
        acc = cd._horner_host(S)[0]
    return acc.to_affine()
