"""Jolt instruction interface (reference: jolt/instruction/mod.rs:17-71).

An instruction defines:
  * `to_indices_vec`: how its operands chunk into C subtable lookup indices
  * `subtables`: which subtables it reads, and at which chunk dimensions
  * `combine_lookups`: the collation polynomial g reassembling subtable
    outputs into the instruction output -- written generically over
    FElt (host) / DevF (device), so the same code serves the verifier's
    claim check and the prover's sumcheck
  * `lookup_entry_vec`: native u64 semantics (witness-generation oracle)

Witness generation is vectorized: `to_indices_vec` maps whole operand
arrays (numpy u64) to [C, N] index arrays.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from ..subtables.base import LassoSubtable


class SubtableIndices:
    """Which chunk dimensions (0..C) a subtable participates in."""

    def __init__(self, indices):
        self.indices = sorted(set(indices))

    @staticmethod
    def single(i: int) -> "SubtableIndices":
        return SubtableIndices([i])

    def __iter__(self):
        return iter(self.indices)

    def __len__(self):
        return len(self.indices)

    def __contains__(self, i):
        return i in self.indices


class JoltInstruction:
    name: str = "instruction"
    word_size: int = 32

    def combine_lookups(self, vals: Sequence, C: int, M: int):
        raise NotImplementedError

    def slice_values(self, vals: Sequence, C: int, M: int) -> list:
        """Split flat subtable-major values per subtable (mod.rs
        slice_values)."""
        out = []
        offset = 0
        for _, indices in self.subtables(C, M):
            out.append(list(vals[offset:offset + len(indices)]))
            offset += len(indices)
        assert offset == len(vals)
        return out

    def g_poly_degree(self, C: int) -> int:
        raise NotImplementedError

    def subtables(self, C: int, M: int
                  ) -> list[tuple[LassoSubtable, SubtableIndices]]:
        raise NotImplementedError

    @classmethod
    def to_indices_vec(cls, x: np.ndarray, y: np.ndarray, C: int,
                       log_M: int) -> np.ndarray:
        raise NotImplementedError

    @classmethod
    def lookup_entry_vec(cls, x: np.ndarray, y: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}()"
