"""Small integer math helpers (reference: jolt-core/src/utils/math.rs)."""
from __future__ import annotations


def log2_strict(n: int) -> int:
    assert n > 0 and (n & (n - 1)) == 0, f"{n} is not a power of two"
    return n.bit_length() - 1


def next_power_of_two(n: int) -> int:
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()
