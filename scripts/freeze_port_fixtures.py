#!/usr/bin/env python3
"""Freeze jolt_tpu's fib(3) proof transcripts for the port's CPU tests.

    JAX_PLATFORMS=cpu python scripts/freeze_port_fixtures.py

Proves fibonacci(3) on the mini VM (ADD, BNE over TruncateOverflow(32),
Identity, Eq; C = 4, M = 2^8, 32-byte I/O) with jolt_tpu on the CPU in
three cases and writes one `fixtures/port/fib3_<case>.npz` each:

    mock      the mock PCS
    hyperkzg  HyperKZG over a 2^8-point SRS (seed 0x6A6F6C74)
    parity    the mock PCS with JOLT_REFERENCE_PARITY=1 (the reference's
              SHA3 vk_digest)

Each file holds the transcript's `state_history` (uint8 [events + 1, 32])
and the read/write and init/final commitments in transcript byte order:
HyperKZG points as x || y big-endian (uint8 [k, 64], zeros at infinity),
mock commitments as their evaluations (uint8 [sum of lengths, 32]
big-endian, with int64 lengths [k]).  tests/test_torch_vm.py compares the
port's proofs with these files; a live run of `prove_case` is the slow
variant of that test.  The prove takes minutes of XLA compiles per case.
"""
from __future__ import annotations

import os
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
OUT_DIR = ROOT / "fixtures" / "port"
CASES = ("mock", "hyperkzg", "parity")
FIB_N = 3
M_MINI = 1 << 8
SRS_LEN = 1 << 8


def history_array(state_history) -> np.ndarray:
    return np.frombuffer(b"".join(state_history), dtype=np.uint8).reshape(
        len(state_history), 32)


def commitment_arrays(prefix: str, commitments) -> dict:
    """HyperKZG points (objects with .point) or mock evaluations (.evals)
    -> arrays, keyed `<prefix>_points` or `<prefix>_evals`/`_lens`."""
    if hasattr(commitments[0], "point"):
        rows = [b"\x00" * 64 if c.point.is_infinity else
                int(c.point.x).to_bytes(32, "big")
                + int(c.point.y).to_bytes(32, "big") for c in commitments]
        return {f"{prefix}_points": np.frombuffer(
            b"".join(rows), dtype=np.uint8).reshape(len(rows), 64)}
    lens = np.array([len(c.evals) for c in commitments], dtype=np.int64)
    flat = b"".join(int(e.v).to_bytes(32, "big")
                    for c in commitments for e in c.evals)
    return {f"{prefix}_evals": np.frombuffer(flat, dtype=np.uint8).reshape(
                -1, 32), f"{prefix}_lens": lens}


def proof_arrays(transcript, commitments) -> dict:
    out = {"state_history": history_array(transcript.state_history)}
    out.update(commitment_arrays("rw", commitments["read_write"]))
    out.update(commitment_arrays("if", commitments["init_final"]))
    return out


def prove_case(case: str) -> dict:
    """jolt_tpu's fib(3) proof of one case, as the arrays above."""
    from jolt_tpu.commitment import MockCommitmentScheme
    from jolt_tpu.commitment.hyperkzg import HyperKZG
    from jolt_tpu.field import fr_spec
    from jolt_tpu.instructions import AddInstruction, BneInstruction
    from jolt_tpu.subtables.rv32i import (EqSubtable, IdentitySubtable,
                                          TruncateOverflowSubtable)
    from jolt_tpu.vm.host import fibonacci_program, trace_program
    from jolt_tpu.vm.rv32i_vm import mini_vm

    old = os.environ.pop("JOLT_REFERENCE_PARITY", None)
    if case == "parity":
        os.environ["JOLT_REFERENCE_PARITY"] = "1"
    try:
        spec = fr_spec()
        vm = mini_vm([AddInstruction, BneInstruction],
                     [TruncateOverflowSubtable(32), IdentitySubtable(),
                      EqSubtable()], M_mini=M_MINI, spec=spec)
        steps, io, rows = trace_program(fibonacci_program(FIB_N), vm,
                                        max_input_size=32, max_output_size=32,
                                        native=False)
        pcs = HyperKZG.setup(SRS_LEN) if case == "hyperkzg" \
            else MockCommitmentScheme(spec)
        pre = vm.preprocess(rows, pcs)
        proof, commitments, transcript, acc = vm.prove(io, steps, pre)
        vm.verify(pre, proof, commitments, debug_transcript=transcript,
                  debug_accumulator=acc)
        return proof_arrays(transcript, commitments)
    finally:
        os.environ.pop("JOLT_REFERENCE_PARITY", None)
        if old is not None:
            os.environ["JOLT_REFERENCE_PARITY"] = old


def main() -> None:
    import jax
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, str(ROOT))
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    for case in CASES:
        arrays = prove_case(case)
        path = OUT_DIR / f"fib3_{case}.npz"
        np.savez_compressed(path, **arrays)
        print(f"{path.relative_to(ROOT)}: "
              f"{arrays['state_history'].shape[0]} transcript states",
              flush=True)


if __name__ == "__main__":
    main()
