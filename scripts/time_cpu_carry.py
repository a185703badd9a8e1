"""Time the two CPU routes of field/arith.py's carry and borrow.

`carry` and `sub_borrow` run limb by limb (three ops a limb) or in
whole-tensor passes (a few ops a pass, one host check a pass); on the CPU
a tensor of up to `arith.CARRY_PARALLEL_MAX` lanes takes the passes.  This
script times both routes at lane counts on either side of that threshold,
on one torch thread (as the tests run), for:

- carry of a Montgomery product's schoolbook columns [33, n] (each column
  below 16 * 2^32: the carries run over three limbs or so);
- carry and borrow at their worst, where one carry or borrow runs through
  all 16 limbs (16 passes);
- the callers: `mont_mul`, `add` and `sub` on random field elements, with
  the threshold forced to 0 (limbs) or past n (passes).

Prints one line per lane count with the median microseconds of each route
and the ratio limbs / passes (above 1: the passes are faster).

    python scripts/time_cpu_carry.py [--reps 30] [--max-log2 16]
"""
from __future__ import annotations

import argparse
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from jolt_tpu_torch.field import arith  # noqa: E402
from jolt_tpu_torch.field.spec import fr_spec  # noqa: E402

L, W, MASK = arith.L, arith.W, arith.MASK


def _median_us(fn, reps: int) -> float:
    fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts) * 1e6


def _forced(threshold: int, fn):
    def run():
        old = arith.CARRY_PARALLEL_MAX
        arith.CARRY_PARALLEL_MAX = threshold
        try:
            fn()
        finally:
            arith.CARRY_PARALLEL_MAX = old
    return run


def _field(rng, spec, n) -> torch.Tensor:
    vals = [int(v) % spec.p for v in rng.integers(0, 1 << 62, n)]
    vals = [(v << 192) % spec.p for v in vals]
    limbs = [[(v >> (W * i)) & MASK for i in range(L)] for v in vals]
    return torch.tensor(np.array(limbs, dtype=np.int64).T.copy())


def cases(n: int, rng, spec):
    a, b = _field(rng, spec, n), _field(rng, spec, n)
    cols = torch.zeros((2 * L + 1, n), dtype=torch.int64)
    for i in range(L):
        cols[i:i + L] += a[i] * b
    worst = torch.full((L, n), MASK, dtype=torch.int64)
    worst[0] += 1                        # 0xFFFF..FFFF + 1: 16 passes
    under = torch.zeros((L, n), dtype=torch.int64)
    under[0] = -1                        # 0 - 1: a borrow through 16 limbs
    return {
        "carry_cols": (lambda: arith._carry_limbs(cols),
                       lambda: arith._carry_passes(cols)),
        "carry_worst": (lambda: arith._carry_limbs(worst),
                        lambda: arith._carry_passes(worst)),
        "borrow_worst": (lambda: arith._borrow_limbs(under),
                         lambda: arith._borrow_passes(under)),
        "mont_mul": (_forced(0, lambda: arith.mont_mul(spec, a, b)),
                     _forced(1 << 62, lambda: arith.mont_mul(spec, a, b))),
        "add": (_forced(0, lambda: arith.add(spec, a, b)),
                _forced(1 << 62, lambda: arith.add(spec, a, b))),
        "sub": (_forced(0, lambda: arith.sub(spec, a, b)),
                _forced(1 << 62, lambda: arith.sub(spec, a, b))),
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--max-log2", type=int, default=16)
    args = ap.parse_args()
    torch.set_num_threads(1)
    spec = fr_spec()
    rng = np.random.default_rng(0)
    print(f"torch {torch.__version__}, 1 thread; CARRY_PARALLEL_MAX = "
          f"{arith.CARRY_PARALLEL_MAX}; median us, limbs / passes")
    sizes = sorted({1 << k for k in range(0, args.max_log2 + 1, 2)}
                   | {arith.CARRY_PARALLEL_MAX // 2, arith.CARRY_PARALLEL_MAX,
                      2 * arith.CARRY_PARALLEL_MAX})
    for n in sizes:
        row = []
        for name, (limbs, passes) in cases(n, rng, spec).items():
            tl = _median_us(limbs, args.reps)
            tp = _median_us(passes, args.reps)
            row.append(f"{name} {tl:.1f}/{tp:.1f} ({tl / tp:.2f}x)")
        print(f"n = {n:>6}: " + "; ".join(row), flush=True)


if __name__ == "__main__":
    main()
