#!/usr/bin/env python3
"""Time the port's kernels, one checkout at a time, by one method.

    python3 scripts/time_kernels.py [--root DIR]

on a CUDA card.  Imports jolt_tpu_torch from DIR (default: this
checkout), builds its kernel libraries, and times each kernel wrapper with
chip_smoke.py's `event_ms` (CUDA events around 10 calls, one call left
running) on random reduced inputs made from seed 0: at the shapes of
chip_smoke.py's phase 2 and at each kernel's largest call of the fib
T = 2^16 prove.  The wrappers' signatures are the same in every checkout
of the port, so two checkouts timed in turns on one card (A, B, B, A)
compare by the same clock and the same method.

Prints the card's name and power limit, a line per shape, and last a
JSON line {"root": DIR, "card": ..., "ms": {shape: ms}}.  Imports
nothing of JAX.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path, default=ROOT,
                    help="checkout whose jolt_tpu_torch is timed")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("time_kernels: no CUDA card")
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    sys.path.insert(0, str(args.root.resolve()))
    from jolt_tpu_torch import _native as nat
    from jolt_tpu_torch.curve import kernels as ck
    from jolt_tpu_torch.field import device as fd
    from jolt_tpu_torch.field import kernels as fk
    from jolt_tpu_torch.field.spec import fq_spec, fr_spec

    card = smoke.card_line()
    print(card, flush=True)
    nat.build()
    dev = torch.device("cuda")
    FR, FQ = fr_spec(), fq_spec()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def fe(spec, *shape):
        t = torch.randint(0, 1 << 16, (16,) + shape, generator=gen,
                          device=dev, dtype=torch.int32)
        t[15] = torch.randint(0, int(spec.p_limbs[15]), shape, generator=gen,
                              device=dev, dtype=torch.int32)
        return t

    def layers(B, s):
        """l, r: the halves of one [B, 16, 2s] layer, as the GP holds them."""
        pair = fe(FR, B, 2 * s).movedim(0, 1).contiguous()
        return pair[..., :s], pair[..., s:]

    rc = fd.scalar_to_device(FR, 0x1234567 ** 9, "cpu")
    ms = {}

    def row(label, fn):
        ms[label] = smoke.event_ms(fn, 10)
        print(f"{label}: {ms[label]:.4f} ms", flush=True)

    a = fe(FR, 4, 1 << 20)
    b = fe(FR, 1, 1)
    row("K1 [16,4,2^20] x [16,1,1] Fr", lambda: fk.mont_mul(FR, a, b))
    a = fe(FR, 116, 1 << 16)
    row("K1 [16,116,2^16] x [16,1,1] Fr", lambda: fk.mont_mul(FR, a, b))
    a, b = fe(FQ, 1 << 20), fe(FQ, 1 << 20)
    row("K1 [16,2^20] x [16,2^20] Fq", lambda: fk.mont_mul(FQ, a, b))
    del a, b
    for B, s in ((8, 1 << 19), (43, 1 << 15), (64, 1 << 15)):
        l, r = layers(B, s)
        eq, c = fe(FR, s), fe(FR, B)
        tag = f"[{B},16,2^{s.bit_length() - 1}]"
        if B != 64:
            row(f"K4 {tag} x 2", lambda: fk.mont_mul_bl(FR, l, r))
        row(f"K2 l,r {tag}",
            lambda: fk.gp_pair_evals(FR, l, r, eq, c))
        if B != 64:
            row(f"K3 l,r {tag}", lambda: fk.gp_pair_bind(FR, l, r, eq, rc))
        del l, r, eq, c
    for shape in ((16384, 64), (1 << 15, 58)):
        p1 = tuple(fe(FQ, *shape) for _ in range(3))
        p2 = tuple(fe(FQ, *shape) for _ in range(3))
        row(f"K5 [16,{shape[0]},{shape[1]}] x 6",
            lambda: ck.proj_cadd(p1, p2))
    p1 = tuple(fe(FQ, 16, 1 << 18) for _ in range(3))
    p2 = tuple(fe(FQ, 16, 1 << 18) for _ in range(3))
    row("K6 [16,16,2^18] x 6", lambda: ck.jac_add(p1, p2))
    p1 = tuple(fe(FQ, 1 << 20) for _ in range(3))
    row("K7 [16,2^20] x 3", lambda: ck.jac_double(p1))
    print(json.dumps({"root": str(args.root), "card": card, "ms": ms}))


if __name__ == "__main__":
    main()
