"""Command-line entry points of the port.

    python -m jolt_tpu_torch.cli surge-bench --nv 20 [--nv-hi 24]
        [--prover-runs 10] [--verifier-runs 50] [--device cuda|cpu]

`surge-bench` is the fork's headline benchmark (bench.rs:109-210), as
jolt_tpu's `cli.py surge-bench` runs it: Surge XOR lookups with C = 4,
M = 2^16 and a real HyperKZG SRS sized for the largest nv; random operands
from numpy's default_rng(0); `--prover-runs` averaged prove times and
`--verifier-runs` averaged verify times.  One JSON line per nv, with the
JAX CLI's keys and the device's name.  `proof_size_bytes` is null until
the proof serializer is ported.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ._device import resolve_device
from .commitment.hyperkzg import HyperKZG
from .field.spec import fr_spec
from .instructions import XorInstruction
from .lasso import SurgePreprocessing, surge_prove, surge_verify

SURGE_C = 4
SURGE_M = 1 << 16


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"


def surge_inputs(rng: np.random.Generator, nv: int):
    """x, y operands of one nv rung, as cli.py:289-293 draws them."""
    n = 1 << nv
    x = rng.integers(0, 1 << 32, size=n, dtype=np.uint64)
    y = rng.integers(0, 1 << 32, size=n, dtype=np.uint64)
    return x, y


def surge_setup(max_nv: int, device=None):
    """(preprocessing, pcs) for Surge XOR at C = 4, M = 2^16 with an SRS of
    max(2^max_nv, M) points, on `device` (default: the CUDA card)."""
    dev = resolve_device(device)
    pre = SurgePreprocessing(XorInstruction, SURGE_C, SURGE_M, fr_spec(), dev)
    pcs = HyperKZG.setup(max(1 << max_nv, SURGE_M), device=dev)
    _sync(dev)
    return pre, pcs


def surge_bench(nv_list, prover_runs: int = 10, verifier_runs: int = 50,
                device=None):
    """Yield one result dict per nv (prove and verify averages, seconds)."""
    dev = resolve_device(device)
    pre, pcs = surge_setup(max(nv_list), dev)
    rng = np.random.default_rng(0)
    for nv in nv_list:
        x, y = surge_inputs(rng, nv)
        total = 0.0
        proof = transcript = None
        for _ in range(max(1, prover_runs)):
            t0 = time.perf_counter()
            proof, transcript, _ = surge_prove(pre, pcs, x, y)
            _sync(dev)
            total += time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(max(1, verifier_runs)):
            surge_verify(pre, proof, debug_transcript=transcript)
        verify_avg = (time.perf_counter() - t0) / max(1, verifier_runs)
        yield {
            "surge_xor_nv": nv,
            "prover_runs": prover_runs,
            "prove_seconds_avg": total / max(1, prover_runs),
            "proof_size_bytes": None,
            "verifier_runs": verifier_runs,
            "verify_seconds_avg": verify_avg,
            "device": device_name(dev),
        }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m jolt_tpu_torch.cli")
    sub = ap.add_subparsers(dest="cmd", required=True)
    sb = sub.add_parser("surge-bench", help="Surge XOR lookups, C=4, M=2^16")
    sb.add_argument("--nv", type=int, default=20)
    sb.add_argument("--nv-hi", type=int, default=None)
    sb.add_argument("--prover-runs", type=int, default=10)
    sb.add_argument("--verifier-runs", type=int, default=50)
    sb.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    nv_list = list(range(args.nv, (args.nv_hi or args.nv) + 1))
    for row in surge_bench(nv_list, args.prover_runs, args.verifier_runs,
                           args.device):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
