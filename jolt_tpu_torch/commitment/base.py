"""Commitment batch types (reference: commitment_scheme.rs:13-120).

Batch types mirror the reference's `BatchType`: they select MSM strategies
in the reference without changing what is committed.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass


class BatchType(enum.Enum):
    BIG = "big"
    SMALL = "small"
    SURGE_READ_WRITE = "surge_read_write"
    SURGE_INIT_FINAL = "surge_init_final"
    GRAND_PRODUCT = "grand_product"


@dataclass(frozen=True)
class CommitShape:
    """A polynomial length and batch type a scheme is set up for."""
    input_length: int
    batch_type: BatchType
