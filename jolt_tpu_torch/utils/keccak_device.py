"""Keccak-256 transcript events on the device: the Fiat-Shamir chain kept
beside the prover's tensors (jolt_tpu/utils/keccak_device.py).

Every transcript event is keccak256(state(32) || zeros(28) ||
n_rounds_BE(4) || payload) (transcript.py; transcript.rs:53-62).  Hashing
on the device lets a whole sumcheck run its rounds with no host sync: the
host pulls the round polynomials once at the end and replays its own
transcript, which must reach the same state byte for byte.

The device transcript state is one int64 tensor [9]: the 32-byte state as
its eight little-endian uint32 words (digest byte k = word[k // 4] >> 8 (k
% 4)), then the event count n_rounds.  Words are held in int64 so that the
plain versions below stay within torch's signed integers; each is below
2^32.

`keccak_f_plain` / `transcript_events_plain` are plain PyTorch (lanes as
lo/hi uint32 halves, masked to 32 bits after every shift).  The kernel K8
(`transcript_events_kernel`, csrc/keccak.cu) runs a list of events in one
block: all threads put the appended scalars in canonical form, one warp
hashes the events in order (a Keccak-f whose state is spread over the
warp's lanes), and all threads put the challenges in Montgomery form;
`transcript_events` launches it on CUDA tensors and runs the plain
version on CPU tensors.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _native as nat
from ..field import arith
from ..field.spec import FieldSpec, NUM_LIMBS

L = NUM_LIMBS
M32 = 0xFFFFFFFF

_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

_ROT_TABLE = [[0, 36, 3, 41, 18], [1, 44, 10, 45, 2], [62, 6, 43, 15, 61],
              [28, 55, 25, 21, 56], [27, 20, 39, 8, 14]]

# K8's event list: segments of (kind, count), run in order.  APPEND takes
# the next `count` columns of the scalars tensor as 32-byte payloads; a
# CHALLENGE event hashes an empty payload and its digest becomes the next
# challenge column (csrc/keccak.cu MAX_SEGS).
APPEND, CHALLENGE = 0, 1
MAX_SEGS = 16
SMEM_EVENTS = 512     # events whose words fit K8's shared memory
#   (csrc/keccak.cu K8_SMEM_EVENTS); a longer list gets a scratch tensor

TRANSCRIPT_EVENTS = nat.CudaKernel(
    "transcript_events", "keccak", "jt_transcript_events",
    [nat.vptr, nat.vptr, nat.vptr, nat.i64, nat.i64, nat.vptr, nat.i64,
     nat.vptr, nat.i64, nat.u32p, nat.u32p, nat.u32p, nat.vptr],
    "jolt_tpu/utils/keccak_device.py:157 transcript_event (a jax.jit "
    "program; no pallas_call)", "transcript_events_kernel", 256)


@functools.lru_cache(maxsize=8)
def _tables(device: torch.device):
    """Index tables of one Keccak-f round over the state's 1,600 bits
    (bit z of lane (x, y) at 64 (x + 5y) + z), on `device`:

      theta  [2 * 320]: the column parities C[x-1, z] and C[x+1, z-1];
      rho_pi [1600]:    B[y, 2x+3y, z] = A[x, y, z - rot(x, y)];
      chi    [2 * 1600]: the lanes x+1 and x+2 of each bit's row;
      iota   [24, 1600]: the round constants' bits."""
    i = np.arange(320)
    x, z = i // 64, i % 64
    theta = np.stack([((x - 1) % 5) * 64 + z, ((x + 1) % 5) * 64 + (z - 1) % 64])
    rho_pi = np.zeros(1600, np.int64)
    for x in range(5):
        for y in range(5):
            dst = y + 5 * ((2 * x + 3 * y) % 5)
            for z in range(64):
                rho_pi[64 * dst + z] = 64 * (x + 5 * y) + (z - _ROT_TABLE[x][y]) % 64
    b = np.arange(1600)
    lane, z = b // 64, b % 64
    x, y = lane % 5, lane // 5
    chi = np.stack([64 * ((x + k) % 5 + 5 * y) + z for k in (1, 2)])
    iota = np.zeros((24, 1600), np.int64)
    for rnd, rc in enumerate(_RC):
        iota[rnd, :64] = [(rc >> k) & 1 for k in range(64)]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(device)
    return (t(theta).reshape(-1), t(rho_pi), t(chi).reshape(-1),
            t(iota).unbind(0))


def keccak_f_plain(words: torch.Tensor) -> torch.Tensor:
    """Keccak-f[1600] on the state as 50 LE uint32 words in int64 (lane i
    = words 2i + 2^32 words 2i+1, lane (x, y) = i = x + 5y).  Runs on the
    state's bits, one 0/1 int64 per bit: XOR is a sum mod 2, and each
    step is a gather of precomputed indices, a few tensor ops per round."""
    theta, rho_pi, chi, iota = _tables(words.device)
    shifts = torch.arange(32, device=words.device)
    a = ((words[:, None] >> shifts) & 1).reshape(1600)
    for rnd in range(24):
        c = a.view(5, 320).sum(0)                       # column parities
        d = c.index_select(0, theta).view(2, 320).sum(0)  # C[x-1]^rotl1 C[x+1]
        a = (a.view(5, 320) + d).view(1600).index_select(0, rho_pi) & 1
        g = a.index_select(0, chi).view(2, 1600)        # theta, rho, pi above
        a = a ^ ((g[0] ^ 1) & g[1]) ^ iota[rnd]         # chi, iota
    return (a.view(50, 32) << shifts).sum(1)


def keccak256_words(msg_words: torch.Tensor, msg_len_bytes: int
                    ) -> torch.Tensor:
    """keccak256 of a one-block message given as LE uint32 words (int64,
    msg_len_bytes a multiple of 4, at most 132) -> the digest's eight LE
    words (int64 [8])."""
    assert msg_len_bytes % 4 == 0 and msg_len_bytes <= 132
    nw = msg_len_bytes // 4
    words = torch.zeros(50, dtype=torch.int64, device=msg_words.device)
    words[:nw] = msg_words[:nw]
    words[nw] |= 0x01                      # pad: 0x01 at byte msg_len ...
    words[33] |= 0x80000000                # ... and 0x80 at byte 135
    return keccak_f_plain(words)[:8]


def bswap32(w: torch.Tensor) -> torch.Tensor:
    """Byte-swap uint32 words held in int64 (LE <-> BE views)."""
    return (((w & 0xFF) << 24) | ((w & 0xFF00) << 8)
            | ((w >> 8) & 0xFF00) | ((w >> 24) & 0xFF))


def transcript_event(state: torch.Tensor, payload_words: torch.Tensor
                     ) -> torch.Tensor:
    """One transcript update: keccak256(state || 0^28 || n_rounds_BE ||
    payload) with n_rounds = state[8]; payload_words: LE uint32 words
    (int64) of the payload bytes.  Returns the new state [9] (count + 1)."""
    prefix = torch.cat([state[:8], state.new_zeros(7),
                        bswap32(state[8:9])])
    msg = torch.cat([prefix, payload_words.to(torch.int64)])
    digest = keccak256_words(msg, 4 * msg.shape[0])
    return torch.cat([digest, state[8:9] + 1])


def message_payload_words(msg: bytes) -> np.ndarray:
    """A <= 32-byte label as the zero-padded 32-byte payload's LE words."""
    data = msg + b"\x00" * (32 - len(msg))
    return np.frombuffer(data, dtype="<u4").astype(np.int64)


def scalar_be_words(spec: FieldSpec, mont: torch.Tensor) -> torch.Tensor:
    """Montgomery limbs [16, ...] -> each scalar's 32-byte big-endian
    payload as LE uint32 words int64 [8, ...] (transcript.rs:97-105 byte
    order)."""
    one = arith.const_limbs(spec, "one", mont.device).reshape(
        (L,) + (1,) * (mont.dim() - 1))
    canon = arith.mont_mul(spec, mont, one).long()       # canonical limbs
    le_words = canon[0::2] | (canon[1::2] << 16)         # value's LE words
    return bswap32(le_words.flip(0))


def words_to_mont(spec: FieldSpec, words: torch.Tensor) -> torch.Tensor:
    """Digest LE words int64 [8, ...] -> Montgomery limbs [16, ...] of each
    digest read big-endian, mod p (transcript.rs:146-153).  A digest may be
    anything below 2^256 (up to 5.3 p for BN254 Fr); R^2 * v * R^-1 is
    below R p, so one Montgomery product reduces it exactly."""
    s = bswap32(words.flip(0))                           # value's LE words
    limbs = torch.stack([s & 0xFFFF, s >> 16], dim=1).reshape(
        (L,) + tuple(words.shape[1:]))
    r2 = arith.const_limbs(spec, "r2", words.device).reshape(
        (L,) + (1,) * (words.dim() - 1))
    return arith.mont_mul(spec, r2, limbs)


@functools.lru_cache(maxsize=None)
def field_words(spec: FieldSpec):
    """The constants K8 and K9 take by value: FieldSpec.words32() (p and
    -p^-1 mod 2^32), then R^2 mod p as eight LE words (a host array, built
    once per field: the kernels only read it)."""
    return nat.words(spec.words32()
                     + [(spec.r2 >> (32 * k)) & M32 for k in range(8)])


def _check_segments(segments, m: int) -> tuple[int, int]:
    """(appends, challenges) of an event list, which must fit K8."""
    if not 1 <= len(segments) <= MAX_SEGS:
        raise ValueError(f"transcript_events: {len(segments)} segments "
                         f"(1..{MAX_SEGS})")
    n_app = n_chal = 0
    for kind, count in segments:
        if kind not in (APPEND, CHALLENGE) or count < 0:
            raise ValueError(f"transcript_events: bad segment {(kind, count)}")
        if kind == APPEND:
            n_app += count
        else:
            n_chal += count
    if n_app > m:
        raise ValueError(f"transcript_events: {n_app} appends of {m} scalars")
    return n_app, n_chal


def transcript_events_plain(spec: FieldSpec, state: torch.Tensor,
                            scalars: torch.Tensor | None, segments
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Run `segments` (see APPEND, CHALLENGE) from `state` [9]: returns
    (state' [9], challenges [16, n] in Montgomery form).  The payloads are
    converted together before the chain and the challenges after it."""
    n_app, n_chal = _check_segments(segments, 0 if scalars is None
                                    else scalars.shape[1])
    payloads = scalar_be_words(spec, scalars[:, :n_app]) if n_app else None
    empty = state.new_zeros(0)
    col, digests = 0, []
    for kind, count in segments:
        for _ in range(count):
            if kind == APPEND:
                state = transcript_event(state, payloads[:, col])
                col += 1
            else:
                state = transcript_event(state, empty)
                digests.append(state[:8])
    if not digests:
        return state, torch.zeros((L, 0), dtype=torch.int32,
                                  device=state.device)
    return state, words_to_mont(spec, torch.stack(digests, dim=1))


def _check_state(name: str, state: torch.Tensor) -> None:
    if state.shape != (9,) or state.dtype != torch.int64:
        raise ValueError(f"{name}: expected an int64 [9] transcript state, "
                         f"got {state.dtype} {tuple(state.shape)}")


def transcript_events(spec: FieldSpec, state: torch.Tensor,
                      scalars: torch.Tensor | None, segments
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The event list `segments` from `state` (K8 on a CUDA state, the
    plain version on a CPU one): (state' [9], challenges [16, n])."""
    _check_state("transcript_events", state)
    segments = [(int(k), int(c)) for k, c in segments]
    m = 0 if scalars is None else scalars.shape[1]
    n_app, n_chal = _check_segments(segments, m)
    if state.device.type == "cpu" and (scalars is None
                                       or scalars.device.type == "cpu"):
        return transcript_events_plain(spec, state, scalars, segments)
    if state.device.type != "cuda":
        raise ValueError(f"transcript_events: expected CUDA tensors, got "
                         f"{state.device}")
    if scalars is not None:
        nat.require_cuda("transcript_events", scalars)
        if scalars.dim() != 2 or scalars.shape[0] != L:
            raise ValueError("transcript_events: scalars must be [16, M]")
        if scalars.device != state.device:
            raise ValueError("transcript_events: tensors on several devices")
    out_state = torch.empty(9, dtype=torch.int64, device=state.device)
    chals = torch.empty((L, n_chal), dtype=torch.int32, device=state.device)
    scratch = (torch.empty(8 * (n_app + n_chal), dtype=torch.int32,
                           device=state.device)
               if n_app + n_chal > SMEM_EVENTS else None)
    pad = [(0, 0)] * (MAX_SEGS - len(segments))
    kinds = nat.words(k for k, _ in segments + pad)
    counts = nat.words(c for _, c in segments + pad)
    sc = scalars if scalars is not None else chals
    TRANSCRIPT_EVENTS.launch(
        nat.ptr(state), nat.ptr(out_state), nat.ptr(sc),
        sc.stride(0) if scalars is not None else 0,
        sc.stride(1) if scalars is not None else 0, nat.ptr(chals),
        max(n_chal, 1), None if scratch is None else nat.ptr(scratch),
        len(segments), kinds, counts, field_words(spec),
        nat.stream(out_state), device=out_state.device)
    return out_state, chals
