"""Device-resident Fiat-Shamir: the sumcheck round's transcript block and
the glue that keeps a whole grand product on the device
(jolt_tpu/subprotocols/fs_device.py).

A host-transcript round pulls its evaluations, interpolates and hashes on
the host, and uploads the challenge: a sync in the middle of every round.
With device Fiat-Shamir the round stays on the device: the evaluations go
to `fs_round` (K9, csrc/keccak.cu: interpolation through a precomputed
inverse Vandermonde matrix, the transcript events, the challenge, the next
claim by Horner), whose challenge feeds the bind directly.  The host pulls
the compressed round polynomials once per layer or sumcheck and replays
its own transcript with them (`replay_and_check`): that rebuilds the
challenges as host field elements and checks the device hash chain byte
for byte.  The grand products' chained mode also draws their batching
coefficients, builds their eq tables and appends their claims on the
device (K8, utils/keccak_device.py: one launch per layer for its claims,
r_layer and the next layer's coefficients), with one pull per grand
product.

The transcript state is keccak_device's int64 [9] tensor.  Counts (rounds,
batch sizes) are host ints.  Each function with a kernel runs its plain
version on CPU tensors: `fs_round_plain` is field ops (field/arith.py) and
the plain Keccak, so the CPU path never launches anything.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import _native as nat
from ..field import arith
from ..field import device as fd
from ..field.host import FElt
from ..field.spec import FieldSpec
from ..utils import keccak_device as kd

L = fd.L

FS_ROUND = nat.CudaKernel(
    "fs_round", "keccak", "jt_fs_round",
    [nat.vptr, nat.i64, nat.i64, nat.vptr, nat.vptr, nat.vptr, nat.vptr,
     nat.vptr, nat.vptr, nat.vptr, nat.i64, nat.i64, nat.u32p, nat.u32p,
     nat.vptr],
    "jolt_tpu/subprotocols/fs_device.py:134 fs_round_jit (a jax.jit "
    "program; no pallas_call)", "fs_round_kernel", 128)


@functools.lru_cache(maxsize=None)
def vinv_mont(spec: FieldSpec, npts: int) -> tuple:
    """Inverse Vandermonde for nodes 0..npts-1 as Montgomery ints (host).

    Interpolation through these nodes is what UniPoly.from_evals computes
    by Lagrange's formula: the same unique polynomial."""
    p = spec.p
    n = npts
    V = [[pow(x, j, p) for j in range(n)] for x in range(n)]
    aug = [row[:] + [int(i == r) for i in range(n)]
           for r, row in enumerate(V)]
    for c in range(n):
        piv = next(r for r in range(c, n) if aug[r][c] % p)
        aug[c], aug[piv] = aug[piv], aug[c]
        inv = pow(aug[c][c], -1, p)
        aug[c] = [v * inv % p for v in aug[c]]
        for r in range(n):
            if r != c and aug[r][c]:
                f = aug[r][c]
                aug[r] = [(v - f * w) % p for v, w in zip(aug[r], aug[c])]
    return tuple(tuple(spec.to_mont(aug[r][n + c]) for c in range(n))
                 for r in range(n))


_VINV: dict = {}


def _vinv_limbs(spec: FieldSpec, npts: int, device) -> torch.Tensor:
    """vinv_mont as int32 limbs [16, npts, npts] on `device`, uploaded once."""
    key = (spec, npts, torch.device(device))
    if key not in _VINV:
        flat = [v for row in vinv_mont(spec, npts) for v in row]
        _VINV[key] = torch.from_numpy(fd.pack_ints(flat).astype(np.int32)
                                      ).reshape(L, npts, npts).to(device)
    return _VINV[key]


@functools.lru_cache(maxsize=None)
def transcript_const_words():
    return (kd.message_payload_words(b"UniPoly_begin"),
            kd.message_payload_words(b"UniPoly_end"))


@functools.lru_cache(maxsize=None)
def _label_words():
    """The two labels' 16 words as K9 takes them (a host array)."""
    begin_w, end_w = transcript_const_words()
    return nat.words([*begin_w, *end_w])


def interpolate(spec: FieldSpec, evals: torch.Tensor) -> torch.Tensor:
    """Coefficients [16, n] (low to high) of the unique degree-(n-1)
    polynomial through (t, evals[:, t]), t = 0..n-1 (plain)."""
    n = evals.shape[1]
    terms = arith.mont_mul(spec, _vinv_limbs(spec, n, evals.device),
                           evals[:, None, :])
    return arith.sum_limbs(spec, terms, -1)


def horner(spec: FieldSpec, coeffs: torch.Tensor, x: torch.Tensor
           ) -> torch.Tensor:
    """sum_j coeffs[:, j] x^j (plain)."""
    acc = coeffs[:, -1]
    for j in range(coeffs.shape[1] - 2, -1, -1):
        acc = arith.add(spec, coeffs[:, j], arith.mont_mul(spec, x, acc))
    return acc


def fs_append_round(spec: FieldSpec, coeffs: torch.Tensor,
                    state: torch.Tensor):
    """Append the compressed round polynomial (every coefficient but the
    linear one, between the UniPoly labels) and draw the round challenge
    (plain).  Returns (compressed [16, d], rj [16], state')."""
    begin_w, end_w = (torch.from_numpy(w).to(state.device)
                      for w in transcript_const_words())
    comp = torch.cat([coeffs[:, :1], coeffs[:, 2:]], dim=1)
    state = kd.transcript_event(state, begin_w)
    state, _ = kd.transcript_events_plain(spec, state, comp,
                                          [(kd.APPEND, comp.shape[1])])
    state = kd.transcript_event(state, end_w)
    state, rj = kd.transcript_events_plain(spec, state, None,
                                           [(kd.CHALLENGE, 1)])
    return comp.int(), rj[:, 0], state


def state_to_device(transcript, device) -> torch.Tensor:
    """A host Transcript's state and count as the device state int64 [9]."""
    words = np.frombuffer(transcript.state, dtype="<u4").astype(np.int64)
    return torch.tensor(list(words) + [transcript.n_rounds],
                        dtype=torch.int64).to(device)


def k9_smem_bytes(degree: int) -> int:
    """K9's dynamic shared memory at `degree` (csrc/keccak.cu
    k9_smem_bytes): (d + 1)^2 products and d + 1 coefficients of 32 bytes,
    then d + 2 messages of 32 bytes."""
    return ((degree + 1) ** 2 + (degree + 1)) * 32 + (degree + 2) * 32


_MAX_SMEM: dict = {}


def _max_smem(dev: torch.device) -> int:
    """The shared memory one K9 block may take on `dev` (its opt-in
    limit), read once per device."""
    if dev not in _MAX_SMEM:
        fn = nat.library("keccak").jt_fs_round_max_smem
        fn.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
        fn.restype = ctypes.c_int
        out = ctypes.c_longlong(0)
        with torch.cuda.device(dev):
            rc = fn(ctypes.byref(out))
        if rc:
            raise RuntimeError(f"fs_round: CUDA error {rc} reading {dev}'s "
                               "shared memory limit")
        _MAX_SMEM[dev] = out.value
    return _MAX_SMEM[dev]


def _check_round(evals: torch.Tensor, degree: int, use_hint: bool) -> None:
    if degree < 1:
        raise ValueError(f"fs_round: degree {degree} (at least 1)")
    n = evals.shape[1] if evals.dim() == 2 else -1
    if evals.dim() != 2 or evals.shape[0] != L or not (
            n == degree + 1 or (use_hint and n == degree)):
        raise ValueError(f"fs_round: evals {tuple(evals.shape)} at degree "
                         f"{degree} (hint {use_hint})")


def fs_round_plain(spec: FieldSpec, evals: torch.Tensor, prev: torch.Tensor,
                   state: torch.Tensor, degree: int, use_hint: bool):
    """One round's transcript block: evals [16, d+1] at t = 0..d (with the
    hint, column 1 is replaced by prev - e_0, and it may be left out:
    [16, d] at t = 0, 2..d).  Returns (compressed [16, d], rj [16],
    prev' = the round polynomial at rj, state')."""
    _check_round(evals, degree, use_hint)
    cols = evals
    if evals.shape[1] == degree:
        cols = torch.cat([evals[:, :1], evals[:, :1], evals[:, 1:]], dim=1)
    if use_hint:
        e1 = arith.sub(spec, prev, cols[:, 0])
        cols = torch.cat([cols[:, :1], e1[:, None], cols[:, 2:]], dim=1)
    coeffs = interpolate(spec, cols)
    comp, rj, state = fs_append_round(spec, coeffs, state)
    return comp, rj, horner(spec, coeffs, rj), state


def fs_round(spec: FieldSpec, evals: torch.Tensor, prev: torch.Tensor,
             state: torch.Tensor, degree: int, use_hint: bool):
    """fs_round_plain's function: K9 on CUDA tensors, the plain version on
    CPU ones.  `prev` is the previous claim [16] (read only with the
    hint)."""
    _check_round(evals, degree, use_hint)
    kd._check_state("fs_round", state)
    if all(t.device.type == "cpu" for t in (evals, prev, state)):
        return fs_round_plain(spec, evals, prev, state, degree, use_hint)
    nat.require_cuda("fs_round", evals, prev)
    if state.device != evals.device:
        raise ValueError("fs_round: tensors on several devices")
    dev = evals.device
    if k9_smem_bytes(degree) > _max_smem(dev):
        raise ValueError(
            f"fs_round: degree {degree} needs {k9_smem_bytes(degree)} bytes "
            f"of shared memory, more than a block takes on {dev} "
            f"({_max_smem(dev)})")
    evals = evals.contiguous()
    prev = prev.reshape(L).contiguous()
    comp = torch.empty((L, degree), dtype=torch.int32, device=dev)
    rj = torch.empty(L, dtype=torch.int32, device=dev)
    prev_out = torch.empty(L, dtype=torch.int32, device=dev)
    state_out = torch.empty(9, dtype=torch.int64, device=dev)
    FS_ROUND.launch(
        nat.ptr(evals), evals.stride(0), evals.shape[1], nat.ptr(prev),
        nat.ptr(_vinv_limbs(spec, degree + 1, dev)), nat.ptr(state),
        nat.ptr(state_out), nat.ptr(comp), nat.ptr(rj), nat.ptr(prev_out),
        degree, int(use_hint), _label_words(), kd.field_words(spec),
        nat.stream(comp), device=comp.device)
    return comp, rj, prev_out, state_out


# ---------------------------------------------------------------------------
# device-chained protocol glue
# ---------------------------------------------------------------------------

def challenge_vector_dev(spec: FieldSpec, state: torch.Tensor, count: int):
    """Draw `count` sequential challenges: (coeffs [16, count] Montgomery,
    state')."""
    state, chals = kd.transcript_events(spec, state, None,
                                        [(kd.CHALLENGE, count)])
    return chals, state


def append_scalars_dev(spec: FieldSpec, state: torch.Tensor,
                       scalars: torch.Tensor, count: int) -> torch.Tensor:
    """Append scalars[:, i] for i < count as scalar events -> state'."""
    state, _ = kd.transcript_events(spec, state, scalars,
                                    [(kd.APPEND, count)])
    return state


def layer_events_dev(spec: FieldSpec, state: torch.Tensor,
                     claims: torch.Tensor, count: int, n_next: int):
    """A chained GKR layer's closing events in one K8 launch: append
    claims[:, i] for i < count, draw r_layer, then draw the next layer's
    n_next batching coefficients (none: an empty segment).  Returns
    (r_layer [16], coefficients [16, n_next], state')."""
    state, chals = kd.transcript_events(
        spec, state, claims, [(kd.APPEND, count), (kd.CHALLENGE, 1),
                              (kd.CHALLENGE, n_next)])
    return chals[:, 0], chals[:, 1:], state


def eq_masked_br(spec: FieldSpec, rs: torch.Tensor, k: int) -> torch.Tensor:
    """The bit-reversed eq table of the first k challenge slots of rs
    [16, K]: out[p] = prod_{j<k} (bit_j(p) ? r_j : 1 - r_j), p < 2^k.
    jolt_tpu pads this to 2^K with zeros for its fixed-shape rounds; the
    port's shrinking rounds take the 2^k active entries alone.  Values as
    poly/mle.py eq_evals_device_br."""
    table = fd.ones(spec, (1,), rs.device)
    for j in range(k):
        hi = fd.fmul(spec, table, rs[:, j:j + 1])
        table = torch.cat([fd.fsub(spec, table, hi), hi], dim=-1)
    return table


def fold_claims_dev(spec: FieldSpec, claims: torch.Tensor,
                    coeffs: torch.Tensor) -> torch.Tensor:
    """The joint claim sum_b coeffs[:, b] claims[:, b] -> [16]."""
    return fd.fsum(spec, fd.fmul(spec, claims, coeffs), axis=0)


def fold_lr_dev(spec: FieldSpec, lefts: torch.Tensor, rights: torch.Tensor,
                r_layer: torch.Tensor) -> torch.Tensor:
    """claims' = lc + r_layer (rc - lc), columnwise [16, B]."""
    return fd.fadd(spec, lefts, fd.fmul(spec, r_layer[:, None],
                                        fd.fsub(spec, rights, lefts)))


def set_col(buf: torch.Tensor, v: torch.Tensor, j: int) -> torch.Tensor:
    """buf[:, j] = v, in place; returns buf."""
    buf[:, j] = v
    return buf


def rebuild_rs(rrounds: torch.Tensor, r_layer: torch.Tensor, k: int
               ) -> torch.Tensor:
    """The next layer's r_grand_product slots [16, k + 1]: out[:, j] =
    rrounds[:, k-1-j] for j < k (the round challenges in emission order,
    reversed), r_layer at j = k."""
    return torch.cat([rrounds[:, :k].flip(1), r_layer[:, None]], dim=1)


def pair_finals_dev(spec: FieldSpec, l: torch.Tensor, r: torch.Tensor):
    """Bound pair layers [B, 16, 1] -> (lefts [16, B], rights [16, B],
    interleaved [16, 2B] = lc0, rc0, lc1, rc1, ...)."""
    lefts, rights = l[..., 0].T, r[..., 0].T
    inter = torch.stack([lefts, rights], dim=2).reshape(L, -1)
    return lefts, rights, inter


def toggle_finals_dev(spec: FieldSpec, flags: torch.Tensor,
                      fps: torch.Tensor) -> torch.Tensor:
    """Bound toggle tensors (flags [16, m, 1], fps [16, 2m, 1]) -> the
    interleaved claim row [16, 4m] = flag0, fp0, flag0, fp1, flag1, fp2, ...
    (the left claim of fingerprint b is flag b // 2,
    grand_product.rs:1422-1474)."""
    lefts = flags[..., 0].repeat_interleave(2, dim=1)
    return torch.stack([lefts, fps[..., 0]], dim=2).reshape(L, -1)


def state_bytes(state: torch.Tensor) -> tuple[bytes, int]:
    """A device state [9] -> (the 32 state bytes, the count), pulled."""
    s = state.cpu().numpy()
    return s[:8].astype("<u4").tobytes(), int(s[8])


def check_state(transcript, state: torch.Tensor, protocol: str) -> None:
    """Raise unless the device chain reached the host transcript's state
    and count."""
    got = state_bytes(state)
    if got != (transcript.state, transcript.n_rounds):
        raise RuntimeError(
            f"{protocol}: the device Fiat-Shamir chain diverged from the "
            f"host transcript (device count {got[1]}, host "
            f"{transcript.n_rounds})")


def replay_and_check(spec: FieldSpec, comp_ints, transcript, state_dev,
                     make_cpoly, protocol: str):
    """Replay `comp_ints` [rounds][d] through the host transcript and
    return (compressed polys, challenges); raises RuntimeError, naming
    `protocol`, unless the device chain equals the host's byte for byte."""
    compressed, challenges = [], []
    for row in comp_ints:
        cpoly = make_cpoly([FElt(int(v), spec) for v in row])
        cpoly.append_to_transcript(transcript)
        challenges.append(transcript.challenge_scalar())
        compressed.append(cpoly)
    check_state(transcript, state_dev, protocol)
    return compressed, challenges
