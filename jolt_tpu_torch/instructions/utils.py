"""Vectorized operand-chunking helpers (reference: utils/instruction_utils.rs).

The helpers map numpy u64 operand arrays [N] -> index arrays [C, N]; chunk
0 is the MOST significant (big-endian chunk order, instruction_utils.rs:62-70).
"""
from __future__ import annotations

import numpy as np


def _u(x) -> np.ndarray:
    return np.asarray(x, dtype=np.uint64)


def chunk_operand_vec(x, C: int, chunk_len: int) -> np.ndarray:
    """[N] -> [C, N]: chunk_len-bit chunks, most significant first."""
    x = _u(x)
    mask = np.uint64((1 << chunk_len) - 1)
    out = np.zeros((C, x.size), dtype=np.uint64)
    for i in range(C):
        shift = (C - i - 1) * chunk_len
        out[i] = ((x >> np.uint64(shift)) if shift < 64 else np.zeros_like(x)) & mask
    return out


def chunk_and_concatenate_operands_vec(x, y, C: int, log_M: int) -> np.ndarray:
    """Per-chunk (x_chunk || y_chunk) indices [C, N] (instruction_utils.rs:~100)."""
    b = log_M // 2
    cx = chunk_operand_vec(x, C, b)
    cy = chunk_operand_vec(y, C, b)
    return (cx << np.uint64(b)) | cy


def add_and_chunk_operands_vec(x, y, C: int, log_M: int) -> np.ndarray:
    """Chunks of (x + y); for 32-bit words the sum fits u64 exactly
    (instruction_utils.rs:172+)."""
    with np.errstate(over="ignore"):
        z = _u(x) + _u(y)
    return chunk_operand_vec(z, C, log_M)


def multiply_and_chunk_operands_vec(x, y, C: int, log_M: int) -> np.ndarray:
    """Chunks of (x * y); 32-bit operand products fit u64 exactly."""
    with np.errstate(over="ignore"):
        z = _u(x) * _u(y)
    return chunk_operand_vec(z, C, log_M)


def chunk_and_concatenate_for_shift_vec(x, y, C: int, log_M: int) -> np.ndarray:
    """Shift instructions: x chunked over log_M/2-bit chunks, each
    concatenated with y's LOWEST log_M/2-bit chunk
    (instruction_utils.rs chunk_and_concatenate_for_shift)."""
    b = log_M // 2
    cx = chunk_operand_vec(x, C, b)
    y_low = _u(y) & np.uint64((1 << b) - 1)
    return (cx << np.uint64(b)) | y_low[None, :]


def concatenate_lookups(vals, C: int, operand_bits: int):
    """sum_i 2^{operand_bits * i} * vals[C-1-i] (instruction_utils.rs:31-42).

    Generic over FElt / DevF.
    """
    assert len(vals) == C
    result = None
    for i in range(C):
        term = vals[C - i - 1] * (1 << (operand_bits * i))
        result = term if result is None else result + term
    return result
