#!/usr/bin/env python3
"""Time the port's kernels, one checkout at a time, by one method.

    python3 scripts/time_kernels.py [--root DIR] [--only fs|round|sum|rounds]

on a CUDA card.  Imports jolt_tpu_torch from DIR (default: this
checkout), builds its kernel libraries, and times each kernel wrapper with
chip_smoke.py's `event_ms` (CUDA events around 10 calls) on random
reduced inputs made from seed 0: at the shapes of
chip_smoke.py's phase 2, at each kernel's largest call of the fib
T = 2^16 prove, and K2-K4 at the sha2-chain prove's GP batches (B = 81
and 110; a checkout whose K2 refuses them prints so); then the device
Fiat-Shamir kernels at the main path's shapes: K8 drawing 110 challenges,
appending 220 claims, a chained GKR layer's merged list (220 appends, 1
challenge, 110 challenges) and 1,000 appends, and K9 at d = 2 and 3 with
the hint and d = 8 without.  K8 and K9 are timed twice: on the card alone
(`event_ms` holds the card while the host enqueues) and with the host's
enqueue time in the way (`hold=False`, the earlier method).  `--only
fs` times K8 and K9 alone.  `--only round` times one primary-sumcheck
round of rv32i_vm() (29 instructions, 55 memories, degree 8) at h =
2^15, 2^12, 2 and 1: the checkout's `primary_round` (one launch), or in
a checkout without it `_primary_round_evals` (9 collation launches, 9
finisher launches and 32 K10 launches a round); 5 rounds a timing, so
that the card's hold outlasts the host's enqueue of the older round's 50
launches.  `--only sum` builds the field programs' library alone, prints
K11's registers and spills (ptxas) and times K11 (`field_sum`) at
chip_smoke.py's phase-2 shapes: [16, 2^23] and [16, 2^20] along -1, the
leading axis of [16, 110, 2^15], [16, 55, 1] and [16, 3] along -1.
`--only rounds` times the toggled grand product's round and the opening reduction's, with its RLC, by the
checkout's functions at the sha2-chain prove's shapes (rv32i_vm(), T =
2^16): `grand_product._toggle_cubic_evals` and `_toggle_bind` at the
first toggle round (flags [16, 55, 2^16] Montgomery 0/1, fingerprints
[16, 110, 2^16], the challenge on the card), all 16 toggle rounds (evals
and bind, down to s = 2) by the host clock to a sync, `opening_proof.
rlc_polys` at the first append (85 columns of [16, 55, 2^16], [16, 29,
2^16] and a [16, 2^16], read in place where the checkout does) and at
HyperKZG's (16 polynomials of 2^16 .. 2, padded to 2^16), and the
reduction sumcheck (`prove_batch_opening_reduction`, 16 rounds with
device Fiat-Shamir over 4 openings of 2^16 and one of 2^10, its pull and
host replay included) by the host clock; each row with the launches of
one call.  The
wrappers' signatures are the same in every checkout of
the port, so two checkouts timed in turns on one card (A, B, B, A)
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
SUM_SHAPES = (("[16,2^23] along -1", (1 << 23,), -1),   # K11, phase 2's
              ("[16,2^20] along -1", (1 << 20,), -1),
              ("[16,110,2^15] along 0", (110, 1 << 15), 0),
              ("[16,55,1] along -1", (55, 1), -1),
              ("[16,3] along -1", (3,), -1))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path, default=ROOT,
                    help="checkout whose jolt_tpu_torch is timed")
    ap.add_argument("--only", choices=("all", "fs", "round", "sum",
                                       "rounds"),
                    default="all", help="fs: K8 and K9 alone; round: the "
                    "primary round; sum: K11; rounds: the toggle and "
                    "reduction rounds and the RLC")
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
    from jolt_tpu_torch.subprotocols import fs_device as fsd
    from jolt_tpu_torch.utils import keccak_device as kd

    card = smoke.card_line()
    print(card, flush=True)
    if args.only == "sum":
        reports = nat.build(["field_ops"], ptxas_verbose=True)
        for fn, use in smoke.ptxas_usage(reports).items():
            if fk.FIELD_SUM.mangled in fn:
                print(f"K11 {fn}: {json.dumps(use)}", flush=True)
    else:
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

    if args.only == "rounds":
        sumcheck_rows(ms, smoke, fe, FR, dev)
        print(json.dumps({"root": str(args.root), "card": card, "ms": ms}))
        return
    if args.only == "round":
        round_rows(ms, smoke, fe, FR, dev)
        print(json.dumps({"root": str(args.root), "card": card, "ms": ms}))
        return
    if args.only == "sum":
        for label, shape, axis in SUM_SHAPES:
            a = fe(FR, *shape)
            row(f"K11 {label}", lambda: fk.field_sum(FR, a, axis))
            del a
        print(json.dumps({"root": str(args.root), "card": card, "ms": ms}))
        return
    if args.only == "all":
        k1_to_k7_rows(FR, FQ, fe, layers, rc, row, fk, ck)
    state = torch.randint(0, 1 << 32, (9,), generator=gen, device=dev,
                          dtype=torch.int64)
    claims = fe(FR, 1000)
    fs_rows = [
        ("K8 110 challenges", None, [(kd.CHALLENGE, 110)]),
        ("K8 220 appends", claims[:, :220], [(kd.APPEND, 220)]),
        ("K8 220 appends, 1 challenge, 110 challenges", claims[:, :220],
         [(kd.APPEND, 220), (kd.CHALLENGE, 1), (kd.CHALLENGE, 110)]),
        ("K8 1000 appends", claims, [(kd.APPEND, 1000)])]
    for label, sc, segs in fs_rows:
        fs_row(ms, label, smoke, lambda: kd.transcript_events(
            FR, state, sc, segs))
    prev = fe(FR, 1)[:, 0]
    for d, hint, n in ((2, True, 2), (3, True, 3), (8, False, 9)):
        evals = fe(FR, n)
        fs_row(ms, f"K9 d = {d}, evals [16,{n}]" + (", hint" if hint
                                                    else ""), smoke,
               lambda: fsd.fs_round(FR, evals, prev, state, d, hint))
    print(json.dumps({"root": str(args.root), "card": card, "ms": ms}))


def round_rows(ms, smoke, fe, FR, dev):
    """One primary round of rv32i_vm() at h = 2^15, 2^12, 2 and 1, by the
    checkout's round function, with its launches per round."""
    import torch
    from jolt_tpu_torch import _native as nat
    from jolt_tpu_torch.instructions import RV32I_INSTRUCTIONS
    from jolt_tpu_torch.vm import instruction_lookups as il
    from jolt_tpu_torch.vm.rv32i_vm import RV32I_SUBTABLES
    pre = il.InstructionLookupsPreprocessing(
        RV32I_INSTRUCTIONS, RV32I_SUBTABLES, 4, 1 << 16, dev, FR)
    fn = getattr(il, "primary_round", None) or il._primary_round_evals
    for h in (1 << 15, 1 << 12, 2, 1):
        ts = (fe(FR, 2 * h), fe(FR, 2 * h), fe(FR, 29, 2 * h),
              fe(FR, 55, 2 * h))
        fn(pre, *ts)
        torch.cuda.synchronize()
        before = sum(nat.launch_counts().values())
        fn(pre, *ts)
        launches = sum(nat.launch_counts().values()) - before
        label = f"round h = 2^{h.bit_length() - 1} ({fn.__name__})"
        ms[label] = smoke.event_ms(lambda: fn(pre, *ts), 5, warm=True)
        print(f"{label}: {ms[label]:.4f} ms, {launches} launches a round",
              flush=True)


def sumcheck_rows(ms, smoke, fe, FR, dev):
    """The toggle round, the reduction sumcheck and the RLC at the sha2
    prove's shapes, by the checkout's functions (see the docstring)."""
    import random
    import time
    import torch
    from jolt_tpu_torch import _native as nat
    from jolt_tpu_torch.field import device as fd
    from jolt_tpu_torch.field.host import FElt
    from jolt_tpu_torch.poly import opening_proof as op
    from jolt_tpu_torch.subprotocols import grand_product as gp
    from jolt_tpu_torch.transcript import Transcript

    def launches(fn):
        before = sum(nat.launch_counts().values())
        fn()
        torch.cuda.synchronize()
        return sum(nat.launch_counts().values()) - before

    def timed(label, fn, host=False, reps=5):
        n = launches(fn)
        if host:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
                torch.cuda.synchronize()
            ms[label] = (time.perf_counter() - t0) / reps * 1e3
        else:
            ms[label] = smoke.event_ms(fn, 10, warm=True)
        how = "host clock to a sync" if host else "on the card"
        print(f"{label}: {ms[label]:.4f} ms ({how}), {n} launches a call",
              flush=True)

    T, m = 1 << 16, 55
    rng = random.Random(16)
    one = fd.scalar_to_device(FR, 1, dev).reshape(16, 1, 1)
    flags = torch.where(torch.rand(m, T, device=dev)[None] < 0.5, one,
                        0).to(torch.int32)
    fps, eq, coeffs = fe(FR, 2 * m, T), fe(FR, T), fe(FR, 2 * m)
    rj = fe(FR, 1)[:, 0]
    timed("toggle evals, first round (s = 2^16)",
          lambda: gp._toggle_cubic_evals(FR, flags, fps, eq, coeffs))
    timed("toggle bind, first round",
          lambda: gp._toggle_bind(FR, flags, fps, eq, rj))

    def toggle_rounds():
        f, p, e = flags, fps, eq
        while f.shape[-1] > 1:
            gp._toggle_cubic_evals(FR, f, p, e, coeffs)
            f, p, e = gp._toggle_bind(FR, f, p, e, rj)

    timed("toggle rounds, all 16 (evals and binds)", toggle_rounds,
          host=True)
    E, F_, out = fe(FR, 55, T), fe(FR, 29, T), fe(FR, T)
    cols = ([fd.col(E, i) for i in range(55)]
            + [fd.col(F_, i) for i in range(29)] + [out])
    cs = [FElt(rng.randrange(FR.p), FR) for _ in range(85)]
    timed("rlc, the first append (85 x 2^16)",
          lambda: op.rlc_polys(FR, cols, cs))
    kzg = [fe(FR, T >> j) for j in range(16)]
    timed("rlc, HyperKZG's (16 polynomials, padded to 2^16)",
          lambda: op.rlc_polys(FR, kzg, cs[:16], pad_to=T))
    del E, F_, cols, kzg, flags, fps

    def reduction():
        acc = op.ProverOpeningAccumulator(FR)
        for k, n in enumerate((T, T, T, T, 1 << 10)):
            ell = n.bit_length() - 1
            acc.openings.append(op.ProverOpening(
                polys[k], eqs[k], [FElt(7 + j, FR) for j in range(ell)],
                FElt(11 + k, FR)))
        acc.prove_batch_opening_reduction(
            [FElt(3 + k, FR) for k in range(5)], Transcript(b"rounds"))

    polys = [fe(FR, n) for n in (T, T, T, T, 1 << 10)]
    eqs = [fe(FR, n) for n in (T, T, T, T, 1 << 10)]
    timed("reduction sumcheck, 16 rounds (4 x 2^16, 1 x 2^10)", reduction,
          host=True)


def fs_row(ms, label, smoke, fn):
    """K8 or K9 timed on the card alone and with the host in the way."""
    ms[label] = smoke.event_ms(fn, 10)
    ms[label + " (enqueue)"] = smoke.event_ms(fn, 10, hold=False)
    print(f"{label}: {ms[label]:.4f} ms on the card alone, "
          f"{ms[label + ' (enqueue)']:.4f} ms with the host's enqueue",
          flush=True)


def k1_to_k7_rows(FR, FQ, fe, layers, rc, row, fk, ck):
    """K1-K7 at chip_smoke.py's phase-2 shapes and the VM's largest."""
    a = fe(FR, 4, 1 << 20)
    b = fe(FR, 1, 1)
    row("K1 [16,4,2^20] x [16,1,1] Fr", lambda: fk.mont_mul(FR, a, b))
    a = fe(FR, 116, 1 << 16)
    row("K1 [16,116,2^16] x [16,1,1] Fr", lambda: fk.mont_mul(FR, a, b))
    a, b = fe(FQ, 1 << 20), fe(FQ, 1 << 20)
    row("K1 [16,2^20] x [16,2^20] Fq", lambda: fk.mont_mul(FQ, a, b))
    del a, b
    for B, s in ((8, 1 << 19), (43, 1 << 15), (64, 1 << 15), (81, 1 << 15),
                 (110, 1 << 15)):
        l, r = layers(B, s)
        eq, c = fe(FR, s), fe(FR, B)
        tag = f"[{B},16,2^{s.bit_length() - 1}]"
        if B != 64:
            row(f"K4 {tag} x 2", lambda: fk.mont_mul_bl(FR, l, r))
        try:
            row(f"K2 l,r {tag}",
                lambda: fk.gp_pair_evals(FR, l, r, eq, c))
        except ValueError as e:     # a checkout whose K2 caps the batch
            print(f"K2 l,r {tag}: refused ({e})", flush=True)
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


if __name__ == "__main__":
    main()
