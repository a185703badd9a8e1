#!/usr/bin/env python3
"""Where the time of one prove (or one commit) goes, in the PyTorch/CUDA
port.

    python3 scripts/profile_torch_prove.py [--nv 20]           # Surge XOR
    python3 scripts/profile_torch_prove.py --workload fib      # Jolt VM
    python3 scripts/profile_torch_prove.py --workload sha2     # full VM
    python3 scripts/profile_torch_prove.py --workload sha3     # the SDK
    python3 scripts/profile_torch_prove.py --workload hyrax --logn 24
        # one commit of pcs-bench's polynomial (also hyperkzg, zeromorph)

on a CUDA card.  `surge` sets up as `python -m jolt_tpu_torch.cli
surge-bench` does (C = 4, M = 2^16, operands from default_rng(0)); `fib`
proves fibonacci(13000) on the mini VM (T = 2^16, C = 4, M = 2^16,
HyperKZG; chip_smoke.py's phase 6 proves fibonacci(3275) at T = 2^14);
`sha2` as chip_smoke.py's phase 8 (sha2-chain(13) on
rv32i_vm(), the input 0x05 x 32, T = 2^16, C = 4, M = 2^16, HyperKZG);
`sha3` as its phase 10: sha3-chain(2) written to ELF bytes and proved
through sdk.build_provable (HyperKZG), so each prove also traces the
guest with the native tracer (44,479 steps, T = 2^16); `hyperkzg`,
`zeromorph` and `hyrax` commit `python -m jolt_tpu_torch.cli pcs-bench`'s
2^logn polynomial after that command's setup, and "prove" below reads
"commit".
One warm-up prove and one unprofiled prove, then:

  1. one prove under torch.profiler (CPU and CUDA activities): wall time,
     the time the card spent in kernels (the union of their intervals),
     its idle share, device time by kernel name, and the summed device
     time and launches of each of the port's kernels (K1-K11, the
     primary round and K14-K17); with --spans, that prove runs with the
     profiling spans on (utils/profiling.py: each syncs the card on
     entry and exit, so a span's kernels run inside its interval), and
     each span's calls, wall ms and device ms (the union of the kernel
     intervals inside its intervals) are printed;
  2. one prove under cProfile: host time by function (cumulative), which
     names the protocol phases (witness, commit, sumchecks, memory
     checking, openings) and the host work inside them (transcript, limb
     carries), and the Keccak-256 hashes of the transcript: their count
     and cumulative seconds.

With --unprofiled-only it stops after the unprofiled prove: the prove
seconds alone, for comparing checkouts in turns in one call.

`--root DIR` imports jolt_tpu_torch from another checkout (default: this
one), with this checkout's SRS fixtures and chip_smoke.py, so that two
checkouts run by the same script in one call compare by one method.

With --span-cost PAIRS it measures what the profiling spans
(jolt_tpu_torch/utils/profiling.py) cost instead: the seconds of one
enabled, empty span on the idle card (10,000 of them, each with its two
`torch.cuda.synchronize()` calls and its profiler range), the spans one
prove opens, and PAIRS pairs of proves in turns with the spans off and on
(off, on, on, off, ...), each prove's seconds and the means.

With --count-ops it counts instead, in one prove after the warm-up, the
ATen ops dispatched to PyTorch (views included: each a host-issued call,
most of them a device op; a torch.utils._python_dispatch mode counts
them) and the port's kernel launches (`_native.launch_counts`): a count
that does not need the profiler's read-back of every device event, which
takes tens of minutes for a prove of millions of ops.

With --replay-k2, the profile is K2's alone, in seconds rather than the
full profile's minutes: the inputs of every K2 call of one prove are kept
on the card, and the calls are replayed twice under torch.profiler; it
prints K2's summed device time per prove and how it splits over the
launch plans (`gp_evals_plan`) the calls took.

With --replay-k11, the same for K11 (`field_sum`): every call of one
prove is kept on the card with its strides (chip_smoke.py's
`strided_copy`, so the replay takes the same layout and plan) and
replayed twice under torch.profiler; it prints K11's summed
device time per prove and, by (rows, n) bucket (rows sums of n terms),
the calls, their device ms, the sum of their bounds (the larger of
bytes and operations, chip_smoke.py's `call_bounds`) and that sum with
one launch a call (`launch_floor_ms`, as chip_smoke.py's phase 2); then
one JSON line of the buckets.

Prints the card's name and power limit first.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import cProfile
import io
import os
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


def span_device_ms(prof, kernels, names, card: str, tag: str) -> None:
    """Each span's calls, wall ms and device ms in the profiled prove:
    the union of the kernel intervals clipped to its intervals (its
    record_function ranges on the host; the spans sync the card on entry
    and exit)."""
    import torch
    ranges: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CPU and e.name in names:
            ranges.setdefault(e.name, []).append((e.time_range.start,
                                                  e.time_range.end))
    ks = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    print(f"spans of the profiled prove {tag}: calls, wall ms, device ms "
          f"[{card}]:")
    for name, rs in sorted(ranges.items(), key=lambda kv: kv[0]):
        wall = sum(e - s for s, e in rs) / 1e3
        dev = sum(_union_us((max(a, s), min(b, e)) for a, b in ks
                            if a < e and b > s) for s, e in rs) / 1e3
        print(f"  {name}: {len(rs)} calls, {wall:.2f} ms wall, {dev:.3f} "
              f"ms on the card")


def keep_calls(prove, fk, wrapper_name: str, copy) -> list:
    """Every call of wrapper `fk.<wrapper_name>` in one prove, its inputs
    copied by `copy`."""
    import torch
    calls, wrapper = [], getattr(fk, wrapper_name)

    def keep(*a):
        calls.append(copy(a))
        return wrapper(*a)

    setattr(fk, wrapper_name, keep)     # where the prover looks it up
    try:
        prove()
    finally:
        setattr(fk, wrapper_name, wrapper)
    torch.cuda.synchronize()
    return calls


def replay(calls: list, wrapper, kernel) -> list[list[float]]:
    """`calls` of `wrapper` replayed twice under torch.profiler: each
    replay's device ms of `kernel` a call, in call order."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    reps = []
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for a in calls:
                wrapper(*a)
            torch.cuda.synchronize()
        evs = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and kernel.function in e.name),
                     key=lambda e: e.time_range.start)
        if len(evs) != len(calls):
            sys.exit(f"replay: {len(evs)} {kernel.name} kernels for "
                     f"{len(calls)} calls")
        reps.append([(e.time_range.end - e.time_range.start) / 1e3
                     for e in evs])
    return reps


def replay_k2(prove, card: str, tag: str) -> None:
    import torch
    from jolt_tpu_torch.field import kernels as fk
    calls = keep_calls(prove, fk, "gp_pair_evals",
                       lambda a: tuple(x.clone() if isinstance(
                           x, torch.Tensor) else x for x in a))
    plans = [fk.gp_evals_plan(a[1].shape[0], a[1].shape[2] // 2)
             for a in calls]
    reps = replay(calls, fk.gp_pair_evals, fk.GP_PAIR_EVALS)
    for rep, times in enumerate(reps):
        by_plan: dict[int, list] = {}
        for ms, (groups, _) in zip(times, plans):
            rec = by_plan.setdefault(groups, [0.0, 0])
            rec[0] += ms
            rec[1] += 1
        print(f"K2 replay {rep} of one prove {tag}: {sum(times):.3f} ms "
              f"device time in {len(times)} launches [{card}]", flush=True)
        for groups, (ms, n) in sorted(by_plan.items()):
            print(f"  groups={groups}: {ms:.3f} ms in {n} launches",
                  flush=True)


def replay_k11(prove, card: str, tag: str) -> None:
    import importlib.util
    import json
    from jolt_tpu_torch.field import kernels as fk
    spec_ = importlib.util.spec_from_file_location("chip_smoke",
                                                   ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(smoke)
    calls = keep_calls(prove, fk, "field_sum",
                       lambda a: (a[0], smoke.strided_copy(a[1]), a[2]))
    launch_ms = smoke.launch_floor_ms()
    imad_rate = smoke.SMS * smoke.IMAD_PER_CLK_SM * smoke.max_sm_clock_hz()
    held = sum(a.untyped_storage().nbytes() for _, a, _ in calls) / 1e9
    print(f"K11: {len(calls)} calls kept ({held:.2f} GB); one launch "
          f"{launch_ms:.4f} ms [{card}]", flush=True)
    bounds = [max(smoke.call_bounds("field_sum", args, imad_rate)[2:])
              for args in calls]
    keys = [smoke.sum_shape(a, axis) for _, a, axis in calls]
    reps = replay(calls, fk.field_sum, fk.FIELD_SUM)
    for rep, times in enumerate(reps):
        buckets: dict[tuple[int, int], list] = {}
        for key, ms, bound in zip(keys, times, bounds):
            rec = buckets.setdefault(key, [0, 0.0, 0.0, 0.0])
            rec[0] += 1
            rec[1] += ms
            rec[2] += bound
            rec[3] += bound + launch_ms
        print(f"K11 replay {rep} of one prove {tag}: {sum(times):.3f} ms "
              f"device time in {len(times)} launches; bound "
              f"{sum(bounds):.3f} ms, with one launch a call "
              f"{sum(bounds) + len(bounds) * launch_ms:.3f} ms [{card}]",
              flush=True)
        for (rows, n), (c, ms, b, bl) in sorted(buckets.items()):
            print(f"  rows={rows} n={n}: {c} calls, {ms:.4f} ms, bound "
                  f"{b:.4f} ms, with one launch a call {bl:.4f} ms",
                  flush=True)
    print(json.dumps({"k11_buckets": [
        {"rows": rows, "n": n, "calls": c, "device_ms": ms, "bound_ms": b,
         "bound_launch_ms": bl}
        for (rows, n), (c, ms, b, bl) in sorted(buckets.items())],
        "launch_ms": launch_ms, "card": card}), flush=True)


def count_ops(prove, nat, card: str, tag: str) -> None:
    """ATen ops dispatched and kernel launches in one prove."""
    import json
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.ops += 1
            return func(*args, **(kwargs or {}))

    nat.reset_launch_counts()
    with Count():
        secs = prove()
    launches = nat.launch_counts()
    print(f"count-ops prove {tag}: {Count.ops} dispatched ATen ops (views "
          f"included), {sum(launches.values())} kernel launches "
          f"{json.dumps(launches)}; {secs:.3f} s with the counter on "
          f"[{card}]", flush=True)


def span_cost(prove, pairs: int, card: str, tag: str) -> None:
    """The spans' cost: an empty span's seconds, and proves in turns with
    the spans off and on."""
    import torch
    from jolt_tpu_torch.utils import profiling

    n = 10_000
    profiling.reset()
    profiling.enable()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        with profiling.span("empty"):
            pass
    empty_s = (time.perf_counter() - t0) / n
    profiling.enable(False)
    secs = {False: [], True: []}
    order = [i % 4 in (1, 2) for i in range(2 * pairs)]   # off on on off
    spans = 0
    for on in order:
        profiling.reset()
        profiling.enable(on)
        secs[on].append(prove())
        profiling.enable(False)
        if on:
            spans = sum(calls for _, calls, _, _ in profiling.cumulative())
        print(f"span-cost prove {tag} spans {'on' if on else 'off'}: "
              f"{secs[on][-1]:.3f} s", flush=True)
    off = sum(secs[False]) / len(secs[False])
    on_ = sum(secs[True]) / len(secs[True])
    print(f"span-cost {tag}: an empty enabled span {1e6 * empty_s:.2f} us "
          f"on the idle card; {spans} spans per prove, so "
          f"{1e3 * spans * empty_s:.3f} ms of spans per prove; proves in "
          f"turns (off, on, on, off, ...): off {secs[False]} mean {off:.3f} "
          f"s, on {secs[True]} mean {on_:.3f} s, on - off {on_ - off:+.3f} "
          f"s ({100 * (on_ - off) / off:+.2f} %) [{card}]", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", choices=("surge", "fib", "sha2", "sha3",
                                           "hyperkzg", "zeromorph", "hyrax"),
                    default="surge")
    ap.add_argument("--logn", type=int, default=24,
                    help="commitment schemes: log2 evaluations")
    ap.add_argument("--nv", type=int, default=20, help="Surge: log2 lookups")
    ap.add_argument("--fib-n", type=int, default=13000)
    ap.add_argument("--sha2-iters", type=int, default=13)
    ap.add_argument("--sha3-iters", type=int, default=2)
    ap.add_argument("--unprofiled-only", action="store_true",
                    help="stop after the unprofiled prove (above)")
    ap.add_argument("--span-cost", type=int, default=0, metavar="PAIRS",
                    help="proves in turns with the spans off and on (above)")
    ap.add_argument("--count-ops", action="store_true",
                    help="count dispatched ops and launches (above)")
    ap.add_argument("--replay-k2", action="store_true",
                    help="profile K2's calls of one prove alone (above)")
    ap.add_argument("--replay-k11", action="store_true",
                    help="profile K11's calls of one prove alone (above)")
    ap.add_argument("--spans", action="store_true",
                    help="the profiled prove with the spans on: each "
                    "span's device ms (above)")
    ap.add_argument("--root", type=Path, default=ROOT,
                    help="checkout whose jolt_tpu_torch is run")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("profile_torch_prove: no CUDA card")
    os.environ.setdefault("JOLT_TPU_SRS_CACHE_DIR",
                          str(ROOT / "fixtures" / "srs"))
    sys.path.insert(0, str(args.root.resolve()))
    from jolt_tpu_torch import _native as nat
    from jolt_tpu_torch import cli, sdk
    from jolt_tpu_torch.commitment.hyperkzg import HyperKZG
    from jolt_tpu_torch.lasso import surge_prove
    from jolt_tpu_torch.tracer.elf_write import elf_image
    from jolt_tpu_torch.vm.guests import sha2_chain_program, sha3_chain_program
    from jolt_tpu_torch.vm.host import fibonacci_program, trace_program
    from jolt_tpu_torch.vm.rv32i_vm import rv32i_vm

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
    elif args.workload in cli.PCS:
        tag = f"{args.workload} commit 2^{args.logn}"
        pcs = cli.PCS[args.workload].setup(1 << args.logn)
        poly = cli.pcs_poly(1 << args.logn, torch.device("cuda"))
        run = lambda: pcs.commit(poly)  # noqa: E731
    elif args.workload == "sha3":
        sdk_prove, _ = sdk.build_provable(
            elf_image(sha3_chain_program(args.sha3_iters)), pcs="hyperkzg")
        tag = f"sha3-chain({args.sha3_iters}) via the SDK"
        run = lambda: sdk_prove(cli.SHA2_INPUT)  # noqa: E731
    else:
        if args.workload == "fib":
            vm = cli.fib_vm(1 << 16)
            steps, io_, rows = trace_program(fibonacci_program(args.fib_n),
                                             vm, max_input_size=32,
                                             max_output_size=32)
            tag = f"fib({args.fib_n}) steps={len(steps)}"
        else:
            vm = rv32i_vm()
            steps, io_, rows = trace_program(
                sha2_chain_program(args.sha2_iters), vm,
                inputs=cli.SHA2_INPUT)
            tag = f"sha2-chain({args.sha2_iters}) steps={len(steps)}"
        pre = vm.preprocess(rows, HyperKZG.setup(
            vm.required_srs_len(io_, steps, rows)))
        run = lambda: vm.prove(io_, steps, pre)  # noqa: E731

    def prove():
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    print(f"warm-up prove {tag}: {prove():.3f} s", flush=True)
    if args.span_cost:
        span_cost(prove, args.span_cost, card, tag)
        return
    if args.replay_k2:
        replay_k2(prove, card, tag)
        return
    if args.replay_k11:
        replay_k11(prove, card, tag)
        return
    if args.count_ops:
        count_ops(prove, nat, card, tag)
        return
    print(f"unprofiled prove {tag}: {prove():.3f} s [{card}]", flush=True)
    if args.unprofiled_only:
        return

    # 1. the card's view
    from torch.profiler import ProfilerActivity, profile
    from jolt_tpu_torch.utils import profiling
    profiling.reset()
    profiling.enable(args.spans)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall_s = prove()
    finally:
        profiling.enable(False)
    # a span's record_function range also shows on the device's timeline
    # (a GPU user annotation of its name): not a kernel
    spans = {name for name, *_ in profiling.cumulative()}
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.name not in spans]
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
    if args.spans:
        span_device_ms(prof, kernels, spans, card, tag)

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
    for (path, _, fn), (_, calls, _, cum, _) in stats.stats.items():
        if fn == "keccak256" and "jolt_tpu_torch" in path:
            rel = Path(path).relative_to(args.root.resolve())
            print(f"keccak256 ({rel}): {calls} calls, {cum:.3f} s "
                  f"cumulative of the {wall_s:.3f} s prove [{card}]")


if __name__ == "__main__":
    main()
