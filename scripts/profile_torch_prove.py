#!/usr/bin/env python3
"""Where the time of one prove goes, in the PyTorch/CUDA port.

    python3 scripts/profile_torch_prove.py [--nv 20]           # Surge XOR
    python3 scripts/profile_torch_prove.py --workload fib      # Jolt VM

on a CUDA card.  `surge` sets up as `python -m jolt_tpu_torch.cli
surge-bench` does (C = 4, M = 2^16, operands from default_rng(0)); `fib`
as chip_smoke.py's phase 6 (fibonacci(13000) on the mini VM, T = 2^16,
C = 4, M = 2^16, HyperKZG).  One warm-up prove and one unprofiled prove,
then:

  1. one prove under torch.profiler (CPU and CUDA activities): wall time,
     the time the card spent in kernels (the union of their intervals),
     its idle share, device time by kernel name, and the summed device
     time and launches of each of the port's kernels (K1-K7);
  2. one prove under cProfile: host time by function (cumulative), which
     names the protocol phases (witness, commit, sumchecks, memory
     checking, openings) and the host work inside them (transcript, limb
     carries).

With --unprofiled-only it stops after the unprofiled prove: the prove
seconds alone, for comparing checkouts in turns in one call (copy this
script into the other checkout's scripts/).

With --replay-k2, the profile is K2's alone, in seconds rather than the
full profile's minutes: the inputs of every K2 call of one prove are kept
on the card, and the calls are replayed twice under torch.profiler; it
prints K2's summed device time per prove and how it splits over the
launch plans (`gp_evals_plan`) the calls took.

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


def port_kernels(nat) -> dict[str, tuple[str, str]]:
    """{label: (demangled, mangled) function name} of each CUDA function
    of the port (K1 and K4 share one), as the profiler may name it."""
    fns: dict[str, list] = {}
    for k in nat.KERNELS:
        fns.setdefault(k.function, [k.mangled, []])[1].append(k.name)
    return {f"{'+'.join(names)} {fn}": (fn, mangled)
            for fn, (mangled, names) in fns.items()}


def replay_k2(prove, card: str, tag: str) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile
    from jolt_tpu_torch.field import kernels as fk
    calls, wrapper = [], fk.gp_pair_evals

    def keep(*a):
        calls.append(tuple(x.clone() if isinstance(x, torch.Tensor) else x
                           for x in a))
        return wrapper(*a)

    fk.gp_pair_evals = keep             # where the prover looks it up
    try:
        prove()
    finally:
        fk.gp_pair_evals = wrapper
    plans = [fk.gp_evals_plan(a[1].shape[0], a[1].shape[2] // 2)
             for a in calls]
    for rep in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for a in calls:
                wrapper(*a)
            torch.cuda.synchronize()
        evs = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and fk.GP_PAIR_EVALS.function in e.name),
                     key=lambda e: e.time_range.start)
        if len(evs) != len(calls):
            sys.exit(f"replay: {len(evs)} K2 kernels for {len(calls)} calls")
        by_plan: dict[int, list] = {}
        for e, (groups, _) in zip(evs, plans):
            rec = by_plan.setdefault(groups, [0.0, 0])
            rec[0] += (e.time_range.end - e.time_range.start) / 1e3
            rec[1] += 1
        total = sum(ms for ms, _ in by_plan.values())
        print(f"K2 replay {rep} of one prove {tag}: {total:.3f} ms device "
              f"time in {len(evs)} launches [{card}]", flush=True)
        for groups, (ms, n) in sorted(by_plan.items()):
            print(f"  groups={groups}: {ms:.3f} ms in {n} launches",
                  flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", choices=("surge", "fib"), default="surge")
    ap.add_argument("--nv", type=int, default=20, help="Surge: log2 lookups")
    ap.add_argument("--fib-n", type=int, default=13000)
    ap.add_argument("--unprofiled-only", action="store_true",
                    help="stop after the unprofiled prove (above)")
    ap.add_argument("--replay-k2", action="store_true",
                    help="profile K2's calls of one prove alone (above)")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("profile_torch_prove: no CUDA card")
    sys.path.insert(0, str(ROOT))
    from jolt_tpu_torch import _native as nat
    from jolt_tpu_torch import cli
    from jolt_tpu_torch.commitment.hyperkzg import HyperKZG
    from jolt_tpu_torch.lasso import surge_prove
    from jolt_tpu_torch.vm.host import fibonacci_program, trace_program

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    nat.build()
    if args.workload == "surge":
        tag = f"surge nv={args.nv}"
        pre, pcs = cli.surge_setup(args.nv)
        x, y = cli.surge_inputs(np.random.default_rng(0), args.nv)
        run = lambda: surge_prove(pre, pcs, x, y)  # noqa: E731
    else:
        vm = cli.fib_vm(1 << 16)
        steps, io_, rows = trace_program(fibonacci_program(args.fib_n), vm,
                                         max_input_size=32,
                                         max_output_size=32)
        tag = f"fib({args.fib_n}) steps={len(steps)}"
        pre = vm.preprocess(rows, HyperKZG.setup(
            vm.required_srs_len(io_, steps, rows)))
        run = lambda: vm.prove(io_, steps, pre)  # noqa: E731

    def prove():
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    print(f"warm-up prove {tag}: {prove():.3f} s", flush=True)
    if args.replay_k2:
        replay_k2(prove, card, tag)
        return
    print(f"unprofiled prove {tag}: {prove():.3f} s [{card}]", flush=True)
    if args.unprofiled_only:
        return

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
    print(f"profiled prove {tag}: wall_s={wall_s:.3f} "
          f"device_busy_s={busy_s:.3f} device_idle_share="
          f"{1 - busy_s / wall_s:.3f} device_ops={len(kernels)} [{card}]")
    print("device time by kernel (ms, launches):")
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:20]:
        print(f"  {ms:10.2f} {n:7d}  {name[:110]}")
    print(f"the port's kernels, device time per prove {tag} [{card}]:")
    for label, pats in port_kernels(nat).items():
        hits = [v for k, v in by_name.items() if any(p in k for p in pats)]
        print(f"  {label}: {sum(ms for ms, _ in hits):.2f} ms in "
              f"{sum(n for _, n in hits)} launches")

    # 2. the host's view
    pr = cProfile.Profile()
    pr.enable()
    wall_s = prove()
    pr.disable()
    out = io.StringIO()
    stats = pstats.Stats(pr, stream=out)
    stats.sort_stats("cumulative").print_stats(60)
    print(f"cProfile prove {tag}: wall_s={wall_s:.3f} (with the "
          f"profiler's own cost)")
    print(out.getvalue())


if __name__ == "__main__":
    main()
