"""Keccak-256 (original 0x01 padding, as used by Ethereum -- NOT SHA3-256).

The reference's Fiat-Shamir transcript hashes with sha3::Keccak256
(jolt-core/src/utils/transcript.rs:4).  hashlib only ships SHA3 (0x06
padding).  `keccak256` runs the port's native Keccak-f[1600]
(native/keccak.cpp, built by g++ at first use; a failed build raises);
`keccak256_py`, the same in pure Python with the rho/pi lane moves
precomputed into one table, stays as its oracle.
"""
from __future__ import annotations

from .. import native

_ROT = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]

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

_MASK = (1 << 64) - 1

# rho + pi as one table: lane x + 5y moves to y + 5((2x + 3y) mod 5),
# rotated left by _ROT[x][y]
_MOVES = [(x + 5 * y, y + 5 * ((2 * x + 3 * y) % 5), _ROT[x][y])
          for x in range(5) for y in range(5)]


def _keccak_f(state: list[int]) -> None:
    """In-place Keccak-f[1600] on a 5x5 lane state (state[x + 5*y])."""
    b = [0] * 25
    for rc in _RC:
        # theta
        c = [state[x] ^ state[x + 5] ^ state[x + 10] ^ state[x + 15]
             ^ state[x + 20] for x in range(5)]
        d = [c[(x - 1) % 5] ^ (((c[(x + 1) % 5] << 1)
                                | (c[(x + 1) % 5] >> 63)) & _MASK)
             for x in range(5)]
        for i in range(25):
            state[i] ^= d[i % 5]
        # rho + pi
        for src, dst, rot in _MOVES:
            v = state[src]
            b[dst] = ((v << rot) | (v >> (64 - rot))) & _MASK if rot else v
        # chi
        for y in range(0, 25, 5):
            b0, b1, b2, b3, b4 = b[y], b[y + 1], b[y + 2], b[y + 3], b[y + 4]
            state[y] = b0 ^ (~b1 & b2)
            state[y + 1] = b1 ^ (~b2 & b3)
            state[y + 2] = b2 ^ (~b3 & b4)
            state[y + 3] = b3 ^ (~b4 & b0)
            state[y + 4] = b4 ^ (~b0 & b1)
        # iota
        state[0] ^= rc


_RATE = 136  # bytes, for 256-bit output


def keccak256(data: bytes) -> bytes:
    return native.keccak256(bytes(data))


def keccak256_py(data: bytes) -> bytes:
    state = [0] * 25
    # absorb with original Keccak padding 0x01 ... 0x80
    padded = bytearray(data)
    pad_len = _RATE - (len(padded) % _RATE)
    padded += b"\x01" + b"\x00" * (pad_len - 2) + b"\x80" if pad_len >= 2 \
        else b"\x81"
    for off in range(0, len(padded), _RATE):
        block = padded[off:off + _RATE]
        for i in range(_RATE // 8):
            state[i] ^= int.from_bytes(block[8 * i:8 * i + 8], "little")
        _keccak_f(state)
    return b"".join(state[i].to_bytes(8, "little") for i in range(4))
