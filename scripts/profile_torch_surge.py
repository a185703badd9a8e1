#!/usr/bin/env python3
"""Where the time of one Surge XOR prove goes, in the PyTorch/CUDA port.

    python3 scripts/profile_torch_surge.py [--nv 20]      # on a CUDA card

Sets up as `python -m jolt_tpu_torch.cli surge-bench` does (C = 4,
M = 2^16, operands from default_rng(0)), runs one warm-up prove, then:

  1. one prove under torch.profiler (CPU and CUDA activities): wall time,
     the time the card spent in kernels (the union of their intervals),
     its idle share, and device time by kernel name;
  2. one prove under cProfile: host time by function (cumulative), which
     names the protocol phases (witness, commit, primary sumcheck, memory
     checking) and the host work inside them (transcript, limb carries).

Prints the card's name and power limit first.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import cProfile
import io
import pstats
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _union_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nv", type=int, default=20)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("profile_torch_surge: no CUDA card")
    sys.path.insert(0, str(ROOT))
    from jolt_tpu_torch import _native as nat
    from jolt_tpu_torch import cli
    from jolt_tpu_torch.lasso import surge_prove

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    nat.build()
    pre, pcs = cli.surge_setup(args.nv)
    x, y = cli.surge_inputs(np.random.default_rng(0), args.nv)

    def prove():
        t0 = time.perf_counter()
        surge_prove(pre, pcs, x, y)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    print(f"warm-up prove nv={args.nv}: {prove():.3f} s", flush=True)
    print(f"unprofiled prove nv={args.nv}: {prove():.3f} s", flush=True)

    # 1. the card's view
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_s = prove()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_s = _union_us((e.time_range.start, e.time_range.end)
                       for e in kernels) / 1e6
    by_name: dict[str, list[float]] = {}
    for e in kernels:
        rec = by_name.setdefault(e.name, [0.0, 0])
        rec[0] += (e.time_range.end - e.time_range.start) / 1e3
        rec[1] += 1
    print(f"profiled prove nv={args.nv}: wall_s={wall_s:.3f} "
          f"device_busy_s={busy_s:.3f} device_idle_share="
          f"{1 - busy_s / wall_s:.3f} device_ops={len(kernels)} [{card}]")
    print("device time by kernel (ms, launches):")
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:20]:
        print(f"  {ms:10.2f} {n:7d}  {name[:110]}")

    # 2. the host's view
    pr = cProfile.Profile()
    pr.enable()
    wall_s = prove()
    pr.disable()
    out = io.StringIO()
    stats = pstats.Stats(pr, stream=out)
    stats.sort_stats("cumulative").print_stats(40)
    print(f"cProfile prove nv={args.nv}: wall_s={wall_s:.3f} (with the "
          f"profiler's own cost)")
    print(out.getvalue())


if __name__ == "__main__":
    main()
