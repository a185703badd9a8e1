"""Keccak256 Fiat-Shamir transcript, EVM-compatible.

Byte-exact re-implementation of the reference transcript
(jolt-core/src/utils/transcript.rs:8-210):

  state      = keccak256(label right-padded to 32 bytes)
  each event = keccak256(state || 28 zero bytes || n_rounds u32 BE || payload)
  payloads:
    message   msg right-padded with zeros to 32 bytes (transcript.rs:64-77)
    bytes     raw                                      (transcript.rs:79-83)
    u64       24 zero bytes || x BE                    (transcript.rs:85-91)
    scalar    32-byte big-endian canonical residue     (transcript.rs:97-105)
    point     x BE (32) || y BE (32); infinity = 64 zero bytes (115-136)
    vectors   "begin_append_vector" ... "end_append_vector" framing (107-113)
  challenge  = hash with empty payload; scalar = BE bytes mod p (146-153)

`state_history` + `compare_to` replicate the reference's transcript-diffing
test oracle (transcript.rs:196-209).
"""
from __future__ import annotations

from typing import Iterable, Sequence

from .field.host import FElt
from .field.spec import FieldSpec, fr_spec
from .utils.keccak import keccak256


class Transcript:
    def __init__(self, label: bytes):
        assert len(label) <= 32
        self.state = keccak256(label + b"\x00" * (32 - len(label)))
        self.n_rounds = 0
        self.state_history: list[bytes] = [self.state]
        self.expected_state_history: list[bytes] | None = None

    # -- internals -----------------------------------------------------------
    def _prefix(self) -> bytes:
        return self.state + b"\x00" * 28 + self.n_rounds.to_bytes(4, "big")

    def _update(self, new_state: bytes) -> None:
        self.state = new_state
        self.n_rounds += 1
        if self.expected_state_history is not None:
            exp = self.expected_state_history[self.n_rounds]
            assert new_state == exp, (
                f"Fiat-Shamir transcript mismatch at round {self.n_rounds}")
        self.state_history.append(new_state)

    def compare_to(self, other: "Transcript") -> None:
        self.expected_state_history = other.state_history

    # -- appends ---------------------------------------------------------------
    def append_message(self, msg: bytes) -> None:
        assert len(msg) <= 32
        self._update(keccak256(self._prefix() + msg + b"\x00" * (32 - len(msg))))

    append_protocol_name = append_message

    def append_bytes(self, data: bytes) -> None:
        self._update(keccak256(self._prefix() + data))

    def append_u64(self, x: int) -> None:
        self._update(keccak256(self._prefix() + b"\x00" * 24 + int(x).to_bytes(8, "big")))

    def append_scalar(self, scalar: FElt | int, spec: FieldSpec | None = None) -> None:
        v = scalar.v if isinstance(scalar, FElt) else int(scalar) % (spec or fr_spec()).p
        self.append_bytes(v.to_bytes(32, "big"))

    def append_scalars(self, scalars: Iterable[FElt | int],
                       spec: FieldSpec | None = None) -> None:
        self.append_message(b"begin_append_vector")
        for s in scalars:
            self.append_scalar(s, spec)
        self.append_message(b"end_append_vector")

    def append_point(self, point) -> None:
        """point: an affine G1 point with int .x/.y and .is_infinity, or None
        for the point at infinity."""
        if point is None or getattr(point, "is_infinity", False):
            self.append_bytes(b"\x00" * 64)
            return
        self.append_bytes(int(point.x).to_bytes(32, "big")
                          + int(point.y).to_bytes(32, "big"))

    def append_points(self, points: Sequence) -> None:
        self.append_message(b"begin_append_vector")
        for p in points:
            self.append_point(p)
        self.append_message(b"end_append_vector")

    # -- challenges --------------------------------------------------------
    def _challenge_bytes32(self) -> bytes:
        rand = keccak256(self._prefix())
        self._update(rand)
        return rand

    def challenge_scalar(self, spec: FieldSpec | None = None) -> FElt:
        spec = spec or fr_spec()
        rand = self._challenge_bytes32()
        # The reference reverses to LE then reduces mod the order
        # (transcript.rs:146-153): value = BE interpretation of the hash.
        return FElt(int.from_bytes(rand, "big"), spec)

    def challenge_vector(self, n: int, spec: FieldSpec | None = None) -> list[FElt]:
        return [self.challenge_scalar(spec) for _ in range(n)]

    def challenge_scalar_powers(self, n: int, spec: FieldSpec | None = None) -> list[FElt]:
        q = self.challenge_scalar(spec)
        powers = [FElt(1, q.spec)]
        for _ in range(1, n):
            powers.append(powers[-1] * q)
        return powers
