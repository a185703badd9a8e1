#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (jolt_tpu_torch) on one GPU.

    python3 chip_smoke.py          # from the root of a checkout, on a CUDA card

Phases (any failure exits non-zero, no phase catches and carries on):
  1. the card's name and power limit (nvidia-smi); build every kernel
     (one nvcc per source, started together) and read each kernel
     function's registers, spills and shared memory from the ptxas
     report, with the warps per SM they leave room for;
  2. each kernel against its plain PyTorch version on the card, at the
     shapes the nv = 20 Surge prove gives it (K7: the SRS fixture tiled),
     compared for equality, and timed with CUDA events (kernel_ms,
     plain_ms, and the bound from bytes and from 32-bit multiplies);
     then K2 at the fib GP's batch (B = 43, 64; s = 2^15, 2^9, 2^5) and
     K2 and K5 on edge residues (0, 1, p - 1, R mod p, ... so that the
     lazy sums cross p and 2p), with K5's lanes holding P + P, P + (-P)
     and the identity;
  3. the main path begins (launch counts set to 0): HyperKZG setup of the
     2^20-point SRS, generated on the card; its first 2^17 points must equal
     fixtures/srs/srs_131072_6a6f6c74.npz bit for bit;
  4. Surge XOR, nv = 20, C = 4, M = 2^16, operands from default_rng(0) as
     `python -m jolt_tpu_torch.cli surge-bench` draws them: one warm-up
     prove (the main path's launch counts are read after it), verify, a
     tampered proof must be rejected, two timed proves and a timed verify;
  5. reference on a small input: Surge at nv = 10 on the card and on the
     CPU (plain versions) must give the same transcript and commitments,
     and two commitments must equal a host MSM;
  6. the Jolt VM's main path (launch counts set to 0 before it): the
     fibonacci(13000) program on the mini VM (ADD, BNE; C = 4, M = 2^16)
     traced to 65,005 steps, padded to T = 2^16, HyperKZG setup from the
     2^16-point SRS fixture, a warm-up prove (K1-K5 must have launched)
     during which the inputs of each kernel's largest call are kept and
     then replayed against the plain version as in phase 2, the
     verifier's accept, a proof with one opening bumped by one rejected,
     then a timed prove and a timed verify;
  7. reference on a small input: fibonacci(3) on the mini VM at M = 2^8
     with HyperKZG over 2^8 points, on the card and on the CPU: both
     transcripts must equal jolt_tpu's, frozen in fixtures/port/
     (scripts/freeze_port_fixtures.py), read here with numpy.
Then a {"kernels": [...]} JSON line, the card line again, and last
{"ok": true, "device": {...}}.  Imports nothing of JAX or jolt_tpu.
K7 (jac_double) lies on neither main path (see csrc/point.cu): phase 2
holds it against its plain version, and the launch check exempts it.
"""
from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory (data sheet)
SMS = 132                          # H100 SXM streaming multiprocessors
IMAD_PER_CLK_SM = 64               # 32-bit integer multiply(-add) results
#   per clock per SM at compute capability 9.0 (CUDA C++ Programming
#   Guide, "Arithmetic Instructions" throughput table)
MULS_PER_PRODUCT = 264             # 32-bit multiplies one 256-bit Montgomery
#   product needs (CIOS over eight 32-bit words, csrc/field.cuh): 64 word
#   products a_i*b_j and 64 m_i*p_j, each a low and a high half, and 8 low
#   halves m_i = t_0 * inv
NV = 20
FIB_N, FIB_T, FIB_M = 13000, 1 << 16, 1 << 16
REGS_PER_SM, SMEM_PER_SM, MAX_WARPS_PER_SM = 65536, 228 * 1024, 64
OFF_PATH = {"jac_double": "no prove path of either package launches "
            "jac_double_pallas (K7); phase 2 holds it against its plain "
            "version"}


def work(name: str, args) -> tuple[int, int]:
    """(bytes, Montgomery products) that one call of kernel `name` needs:
    each input read once and each output written once (int32 limbs), and
    the products of the function itself: K2 5B + 3 per pair of B circuits,
    K3 2B + 1, K5 12 per add (RCB16 Alg. 7), K6 16 (an add; the doubling
    and infinity lanes of phase 2 are 2^-14 of its lanes), K7 7
    (dbl-2009-l)."""
    tb = lambda *ts: 4 * sum(t.numel() for t in ts)
    if name == "mont_mul":
        import torch
        _, a, b = args
        n = math.prod(torch.broadcast_shapes(a.shape, b.shape)[1:])
        return tb(a, b) + 4 * 16 * n, n
    if name == "mont_mul_bl":
        _, a, b = args
        return 3 * tb(a), a.shape[0] * a.shape[2]
    if name in ("gp_pair_evals", "gp_pair_bind"):
        _, l, r, eq, x = args
        B, h = l.shape[0], l.shape[2] // 2
        if name == "gp_pair_evals":
            return tb(l, r, eq, x) + 4 * 16 * 3, (5 * B + 3) * h
        return tb(l, r, eq) * 3 // 2 + 4 * 16, (2 * B + 1) * h
    pts = [t for p in args for t in p]
    n = pts[0][0].numel()
    per = {"proj_cadd": 12, "jac_add": 16, "jac_double": 7}[name]
    return tb(*pts) + 3 * 4 * 16 * n, per * n


def ptxas_usage(reports: dict[str, str]) -> dict[str, dict]:
    """{CUDA function: registers, spill bytes, static shared bytes} from
    the -Xptxas -v reports of the libraries built in this run."""
    usage, fn = {}, None
    for text in reports.values():
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                fn = m.group(1)
                usage[fn] = {"registers": None, "spill_bytes": None,
                             "smem_bytes": 0}
            elif fn and (m := re.search(r"(\d+) bytes spill stores, "
                                        r"(\d+) bytes spill loads", line)):
                usage[fn]["spill_bytes"] = int(m[1]) + int(m[2])
            elif fn and (m := re.search(r"Used (\d+) registers", line)):
                usage[fn]["registers"] = int(m[1])
                sm = re.search(r"(\d+) bytes smem", line)
                usage[fn]["smem_bytes"] = int(sm[1]) if sm else 0
    return usage


def resident_warps(regs: int, smem: int, threads: int) -> int:
    """Warps per SM that the registers and shared memory of a block of
    `threads` leave room for (registers allocated per warp in units of
    256; 1 KB of shared memory reserved per block)."""
    wpb = threads // 32
    per_warp = -(-regs * 32 // 256) * 256
    blocks = min(REGS_PER_SM // per_warp // wpb,
                 SMEM_PER_SM // (smem + 1024), MAX_WARPS_PER_SM // wpb, 32)
    return blocks * wpb


def event_ms(fn, reps: int) -> float:
    """Device ms per call of `fn`, by CUDA events around `reps` calls.
    One call is left running when the start event is recorded, so the
    card does not sit idle while the host enqueues the first timed call
    (a bias of the host's enqueue time / reps otherwise)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def max_sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0]
    return float(out) * 1e6


def sass_counts(lib_path) -> dict[str, dict[str, int]]:
    """Static SASS instructions per kernel function of a built library
    (cuobjdump): the integer multiply-adds (IMAD family, moves excluded),
    the integer adds (IADD3 family), selects, and all instructions."""
    tool = Path("/usr/local/cuda/bin/cuobjdump")
    out = subprocess.run([str(tool if tool.exists() else "cuobjdump"),
                          "-sass", str(lib_path)],
                         capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = dict(imad=0, iadd3=0, sel=0, total=0)
            continue
        m = re.match(r"\s+/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)",
                     line)
        if fn and m:
            op = m[1]
            c = counts[fn]
            c["total"] += 1
            if op.startswith("IMAD") and not op.startswith("IMAD.MOV"):
                c["imad"] += 1
            elif op.startswith("IADD3"):
                c["iadd3"] += 1
            elif op == "SEL":
                c["sel"] += 1
    return counts


def main() -> None:
    if not (ROOT / "jolt_tpu_torch" / "csrc").is_dir() \
            or not (ROOT / "fixtures" / "srs").is_dir() \
            or not (ROOT / "fixtures" / "port").is_dir():
        fail("run from the root of a checkout: jolt_tpu_torch/ and "
             "fixtures/ are missing")
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    sys.path.insert(0, str(ROOT))
    from jolt_tpu_torch import _native as nat
    from jolt_tpu_torch import cli
    from jolt_tpu_torch.curve import device as cd
    from jolt_tpu_torch.curve import kernels as ck
    from jolt_tpu_torch.curve.bn254 import G1Jacobian
    from jolt_tpu_torch.curve.device import FOLD_LANES, MSM_CHANNEL_CHUNK
    from jolt_tpu_torch.field import arith
    from jolt_tpu_torch.field import device as fd
    from jolt_tpu_torch.field import kernels as fk
    from jolt_tpu_torch.field.host import FElt
    from jolt_tpu_torch.field.spec import FieldSpec, fq_spec, fr_spec
    from jolt_tpu_torch.instructions import XorInstruction
    from jolt_tpu_torch.lasso import (SurgePreprocessing, generate_witness,
                                      surge_prove, surge_verify)
    from jolt_tpu_torch.commitment.hyperkzg import HyperKZG
    from jolt_tpu_torch.subprotocols.sumcheck import VerificationError
    from jolt_tpu_torch.vm.host import fibonacci_program, trace_program

    dev = torch.device("cuda")
    FR, FQ = fr_spec(), fq_spec()
    card = card_line()
    print(card, flush=True)

    # -- phase 1: build --------------------------------------------------
    t0 = time.perf_counter()
    for name in nat.SOURCES:            # build from the sources, always
        nat.lib_path(name).unlink(missing_ok=True)
    reports = nat.build(ptxas_verbose=True)
    print(f"phase 1: built {len(nat.SOURCES)} kernel libraries in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    reported, usage = ptxas_usage(reports), {}
    for k in nat.KERNELS:
        fns = [f for f in reported if k.mangled in f]
        if not fns:
            fail(f"ptxas reported no function for {k.name} ({k.function})")
        u = dict(reported[fns[0]], threads=k.threads)
        u["resident_warps_per_sm"] = resident_warps(
            u["registers"], u["smem_bytes"], k.threads)
        usage[k.name] = u
        print(f"phase 1: {k.name}: {fns[0]}: {json.dumps(u)}", flush=True)
    for name in nat.SOURCES:
        for fn, c in sass_counts(nat.lib_path(name)).items():
            for k in nat.KERNELS:
                if k.mangled in fn:
                    usage[k.name]["sass"] = c
            print(f"phase 1: {name}.cu: {fn}: SASS {json.dumps(c)}",
                  flush=True)
    clock_hz = max_sm_clock_hz()
    imad_rate = SMS * IMAD_PER_CLK_SM * clock_hz
    print(f"phase 1: max SM clock {clock_hz / 1e6:.0f} MHz; INT32 multiply "
          f"rate {imad_rate:.4g}/s; {MULS_PER_PRODUCT} 32-bit multiplies per "
          f"Montgomery product", flush=True)

    # -- phase 2: each kernel against its plain version ------------------
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def rand_fe(spec, *shape):
        """Reduced random field elements [16, *shape] (top limb below p's)."""
        t = torch.randint(0, 1 << 16, (16,) + shape, generator=gen,
                          device=dev, dtype=torch.int32)
        t[15] = torch.randint(0, int(spec.p_limbs[15]), shape, generator=gen,
                              device=dev, dtype=torch.int32)
        return t

    def edge_fe(spec, *shape):
        """Reduced elements [16, *shape], three in four drawn from edges
        (0, 1, 2, p - 1, p - 2, (p -+ 1)/2, R mod p, p - R mod p, 2^255 mod
        p), so that the kernels' lazy sums and differences cross p and
        2p."""
        p = spec.p
        pool = [0, 1, 2, p - 1, p - 2, (p - 1) // 2, (p + 1) // 2, spec.r,
                p - spec.r, (1 << 255) % p]
        pool_t = torch.from_numpy(fd.pack_ints(pool).astype(np.int32)).to(dev)
        t = rand_fe(spec, *shape).reshape(16, -1)
        pick = torch.randint(0, len(pool), (t.shape[1],), generator=gen,
                             device=dev)
        use = torch.rand(t.shape[1], generator=gen, device=dev) < 0.75
        t[:, use] = pool_t[:, pick[use]]
        return t.reshape((16,) + shape)

    def as_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    # each kernel's wrapper and plain version, taken before phase 6 wraps
    # the wrappers where the prover looks them up
    KERNEL = {
        "mont_mul": (fk.mont_mul, arith.mont_mul),
        "mont_mul_bl": (fk.mont_mul_bl, fk.mont_mul_bl_plain),
        "gp_pair_evals": (fk.gp_pair_evals, fk.gp_pair_evals_plain),
        "gp_pair_bind": (fk.gp_pair_bind, fk.gp_pair_bind_plain),
        "proj_cadd": (ck.proj_cadd, ck.proj_cadd_plain),
        "jac_add": (ck.jac_add, ck.jac_add_plain),
        "jac_double": (ck.jac_double, lambda p: ck.jac_double_plain(*p))}
    results = {}                    # {kernel: {"phase 2"|"phase 6 fib": row}}
    more = {}                       # {kernel: [rows at further shapes]}

    def compare(phase, name, shape, args, record=True):
        wrapper, plain = KERNEL[name]
        got = as_tuple(wrapper(*args))
        want = as_tuple(plain(*args))
        torch.cuda.synchronize()
        err = max(int((g.long() - w.long()).abs().max()) for g, w in
                  zip(got, want))
        if err != 0 or any(g.shape != w.shape for g, w in zip(got, want)):
            fail(f"{name} at {shape}: kernel and plain version differ (max "
                 f"abs err {err})")
        del got, want
        kernel_ms = event_ms(lambda: wrapper(*args), 10)
        plain_ms = event_ms(lambda: plain(*args), 1)
        nbytes, products = work(name, args)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        muls = products * MULS_PER_PRODUCT
        ops_ms = muls / imad_rate * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
        print(f"{phase}: {name} shape={shape} kernel_ms={kernel_ms:.4f} "
              f"plain_ms={plain_ms:.2f} bytes={nbytes} "
              f"bytes_bound_ms={bytes_ms:.4f} int32_muls={muls} "
              f"ops_bound_ms={ops_ms:.4f} bound_by={bound_by} "
              f"max_abs_err={err}", flush=True)
        row = dict(shape=shape, max_abs_err=err, ms=kernel_ms,
                   plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                   bytes_bound_ms=bytes_ms, ops_bound_ms=ops_ms)
        if record:
            results.setdefault(name, {})[phase] = row
        else:                           # more shapes, kept beside the row
            more.setdefault(name, []).append(row)

    n = 1 << NV
    # K1, Fr: the witness's to-Montgomery pass, [16, 4, 2^20] x R^2
    a = rand_fe(FR, 4, n)
    r2 = arith.const_limbs(FR, "r2", dev).reshape(16, 1, 1)
    compare("phase 2", "mont_mul", "[16,4,2^20] x [16,1,1] Fr", (FR, a, r2))
    del a
    # K1, Fq: Jacobian -> projective of the SRS, [16, 2^20] x [16, 2^20]
    a, b = rand_fe(FQ, n), rand_fe(FQ, n)
    compare("phase 2", "mont_mul", "[16,2^20] x [16,2^20] Fq", (FQ, a, b),
            record=False)
    del a, b
    # K4, K2, K3: the read/write GP's leaf layer, B = 8, s = 2^19
    B, s = 8, n // 2
    pair = rand_fe(FR, B, 2 * s).movedim(0, 1).contiguous()   # [8, 16, 2^20]
    l, r = pair[..., :s], pair[..., s:]
    eq = rand_fe(FR, s)
    coeffs = rand_fe(FR, B)
    compare("phase 2", "mont_mul_bl", "[8,16,2^19] x [8,16,2^19] Fr",
            (FR, l, r))
    compare("phase 2", "gp_pair_evals",
            "l,r [8,16,2^19], eq [16,2^19], coeffs [16,8]",
            (FR, l, r, eq, coeffs))
    rc = fd.scalar_to_device(FR, 0x1234567 ** 9, "cpu")
    compare("phase 2", "gp_pair_bind",
            "l,r [8,16,2^19], eq [16,2^19] -> halves", (FR, l, r, eq, rc))
    del pair, l, r, eq
    # K2 at the fib GP's batch: its largest round and two small ones (the
    # small rounds show the per-launch floor), then on edge residues
    for Bk, sk in [(b, k) for b in (43, 64) for k in (15, 9, 5)] + [(43, 12)]:
        mk = edge_fe if sk == 12 else rand_fe
        lk = mk(FR, Bk, 1 << sk).movedim(0, 1).contiguous()
        rk = mk(FR, Bk, 1 << sk).movedim(0, 1).contiguous()
        compare("phase 2", "gp_pair_evals",
                f"l,r [{Bk},16,2^{sk}], eq [16,2^{sk}], coeffs [16,{Bk}]"
                + (" edge residues" if sk == 12 else ""),
                (FR, lk, rk, mk(FR, 1 << sk), mk(FR, Bk)), record=False)
        del lk, rk
    # K5, K6 on real points: the 2^17-point SRS fixture, tiled
    with np.load(ROOT / "fixtures" / "srs" / "srs_131072_6a6f6c74.npz") as z:
        fix = {k: z[k] for k in ("X", "Y", "Z")}
    X, Y, Z = (torch.from_numpy(fix[k].astype(np.int32)).to(dev)
               for k in ("X", "Y", "Z"))
    m = X.shape[1]
    # K5: one fold step, accumulators [16, T, K] with K = 64 channels
    K = MSM_CHANNEL_CHUNK
    T = FOLD_LANES // K
    PX, PZ = fd.fmul(FQ, X, Z), fd.fmul(FQ, Z, fd.fmul(FQ, Z, Z))
    proj = [t.reshape(16, -1)[:, :T * K // 8].repeat(1, 8).reshape(16, T, K)
            .contiguous() for t in (PX, Y, PZ)]
    perm = torch.randperm(T * K, generator=gen, device=dev)
    other = [t.reshape(16, -1)[:, perm].reshape(16, T, K).contiguous()
             for t in proj]
    other[0][:, 0], other[1][:, 0], other[2][:, 0] = \
        proj[0][:, 0], proj[1][:, 0], proj[2][:, 0]            # doubling
    other[0][:, 1], other[2][:, 1] = 0, 0                      # (0:1:0)
    other[1][:, 1] = arith.const_limbs(FQ, "r", dev)[:, None]
    other[0][:, 2], other[2][:, 2] = proj[0][:, 2], proj[2][:, 2]
    other[1][:, 2] = arith.sub(FQ, torch.zeros_like(proj[1][:, 2]),
                               proj[1][:, 2])                  # P + (-P)
    p1, p2 = tuple(proj), tuple(other)
    compare("phase 2", "proj_cadd", f"[16,{T},{K}] x 6 -> 3 Fq", (p1, p2))
    p1 = tuple(edge_fe(FQ, T, K) for _ in range(3))
    p2 = tuple(edge_fe(FQ, T, K) for _ in range(3))
    compare("phase 2", "proj_cadd", f"[16,{T},{K}] x 6 -> 3 Fq edge residues",
            (p1, p2), record=False)
    del proj, other, p1, p2, PX, PZ
    # K6: the first tree level of SRS generation, [16, 16, 2^18]
    W2, C = 16, 1 << 18
    idx = torch.randint(0, m, (2, W2 * C), generator=gen, device=dev)
    q1 = [t[:, idx[0]].reshape(16, W2, C) for t in (X, Y, Z)]
    q2 = [t[:, idx[1]].reshape(16, W2, C) for t in (X, Y, Z)]
    for k in range(3):
        q2[k][:, 0, :64] = q1[k][:, 0, :64]                    # doubling
    q2[1][:, 1, :64] = arith.sub(FQ, torch.zeros_like(q1[1][:, 1, :64]),
                                    q1[1][:, 1, :64])          # inverse
    for k in (0, 2):
        q2[k][:, 1, :64] = q1[k][:, 1, :64]
    q2[2][:, 2, :64] = 0                                       # P2 = infinity
    q1[2][:, 3, :64] = 0                                       # P1 = infinity
    p1, p2 = tuple(q1), tuple(q2)
    compare("phase 2", "jac_add", f"[16,{W2},2^18] x 6 -> 3 Fq", (p1, p2))
    del q1, q2, p1, p2, idx
    # K7: the SRS fixture tiled to [16, 2^20], with Z = 0 lanes
    reps = n // m
    pd = [t.repeat(1, reps).contiguous() for t in (X, Y, Z)]
    pd[2][:, ::97] = 0                                         # infinity
    pt = tuple(pd)
    compare("phase 2", "jac_double", "[16,2^20] x 3 -> 3 Fq", (pt,))
    del pd, pt
    torch.cuda.empty_cache()

    # -- phase 3: the main path begins: SRS setup -----------------------
    nat.reset_launch_counts()
    t0 = time.perf_counter()
    pre, pcs = cli.surge_setup(NV, dev)
    setup_s = time.perf_counter() - t0
    gX, gY, gZ = pcs.pk.g1_jac
    for k, t in zip(("X", "Y", "Z"), (gX, gY, gZ)):
        got = t[:, :m].cpu().numpy().astype(np.uint32)
        if got.shape != fix[k].shape or not (got == fix[k]).all():
            fail(f"SRS coordinate {k}: first 2^17 points differ from the "
                 "fixture")
    print(f"phase 3: HyperKZG setup with a 2^{NV}-point SRS generated on the "
          f"card (+ XOR subtables): {setup_s:.3f} s; first 2^17 points equal "
          f"srs_131072_6a6f6c74.npz (X, Y, Z) [{card}]", flush=True)

    # -- phase 4: Surge XOR, nv = 20 --------------------------------------
    x, y = cli.surge_inputs(np.random.default_rng(0), NV)
    t0 = time.perf_counter()
    proof, transcript, _ = surge_prove(pre, pcs, x, y)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    main_counts = nat.launch_counts()
    print(f"phase 4: warm-up prove {warm_s:.3f} s; main-path launches "
          f"(setup + this prove) {json.dumps(main_counts)}", flush=True)
    missing = [k for k, v in main_counts.items()
               if v <= 0 and k not in OFF_PATH]
    if missing:
        fail(f"kernels of the main path never launched: {missing}")
    surge_verify(pre, proof, debug_transcript=transcript)
    good = proof.primary_sumcheck.claimed_evaluation
    proof.primary_sumcheck.claimed_evaluation = good + FElt(1, FR)
    try:
        surge_verify(pre, proof)
    except VerificationError:
        pass
    else:
        fail("a proof with its claimed evaluation bumped by one verified")
    proof.primary_sumcheck.claimed_evaluation = good
    prove_s, prove_counts = [], None
    for _ in range(2):
        nat.reset_launch_counts()
        t0 = time.perf_counter()
        proof, transcript, _ = surge_prove(pre, pcs, x, y)
        torch.cuda.synchronize()
        prove_s.append(time.perf_counter() - t0)
        prove_counts = nat.launch_counts()
    t0 = time.perf_counter()
    for _ in range(3):
        surge_verify(pre, proof, debug_transcript=transcript)
    verify_s = (time.perf_counter() - t0) / 3
    print(f"phase 4: Surge XOR nv={NV} C=4 M=2^16: prove_s={prove_s} "
          f"verify_s={verify_s:.4f} (avg of 3), tampered proof rejected, "
          f"peak_mem_GB={torch.cuda.max_memory_allocated() / 1e9:.2f} "
          f"[{card}]", flush=True)
    print(f"phase 4: launches per nv={NV} prove {json.dumps(prove_counts)}",
          flush=True)

    # -- phase 5: reference on a small input ------------------------------
    xs, ys = cli.surge_inputs(np.random.default_rng(1), 10)
    runs = {}
    for d in (dev, torch.device("cpu")):
        pre_s = SurgePreprocessing(XorInstruction, 4, 1 << 8, device=d)
        pcs_s = HyperKZG.setup(1 << 10, device=d)
        p, tr, _ = surge_prove(pre_s, pcs_s, xs, ys)
        surge_verify(pre_s, p, debug_transcript=tr)
        runs[d.type] = (tr.state_history,
                        [c.point for c in p.commitments + p.final_commitments])
    if runs["cuda"] != runs["cpu"]:
        fail("Surge nv=10: card and CPU transcripts or commitments differ")
    polys, _ = generate_witness(pre_s, xs, ys)
    pts = [G1Jacobian(int(a), int(b), int(c)) for a, b, c in zip(
        *(fd.unpack_ints(fd.from_mont_device(FQ, t).numpy()) for t in
          pcs_s.pk.g1_jac))]
    for j in (0, 8):                    # dim_0 and E_0 against a host MSM
        scal = fd.device_to_ints(FR, polys.read_write_values()[j])
        acc = G1Jacobian.identity()
        for pt, sc in zip(pts, scal):
            acc = acc.add(pt.mul(int(sc)))
        if acc.to_affine() != runs["cuda"][1][j]:
            fail(f"Surge nv=10: commitment {j} differs from the host MSM")
    print("phase 5: Surge nv=10 card == CPU (transcript, 16 commitments); "
          "2 commitments == host MSM", flush=True)

    # -- phase 6: the Jolt VM, fibonacci at T = 2^16 ---------------------
    vm = cli.fib_vm(FIB_M)
    t0 = time.perf_counter()
    steps, io, rows = trace_program(fibonacci_program(FIB_N), vm,
                                    max_input_size=32, max_output_size=32)
    trace_s = time.perf_counter() - t0
    T = 1 << (len(steps) - 1).bit_length()
    if T != FIB_T:
        fail(f"fib({FIB_N}) traced to {len(steps)} steps, padded to {T}, "
             f"not 2^16")
    print(f"phase 6: fib({FIB_N}) traced to {len(steps)} steps "
          f"({len(rows)} bytecode rows) in {trace_s:.2f} s, padded to "
          f"T = 2^16", flush=True)
    # Through setup and the warm-up prove, each kernel's wrapper is wrapped
    # where the prover's modules look it up (field/kernels.py for K1-K4,
    # curve/device.py for K5-K7), keeping a copy of the inputs of its
    # largest call on the card; the copies are replayed below.
    sites = {name: (fk if name in ("mont_mul", "mont_mul_bl",
                                   "gp_pair_evals", "gp_pair_bind") else cd)
             for name in KERNEL}
    largest = {}

    def tensors(x):
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, (tuple, list)):
            for y in x:
                yield from tensors(y)

    def copy(x):
        if isinstance(x, torch.Tensor):
            return x.clone()
        if isinstance(x, (tuple, list)):
            return type(x)(copy(y) for y in x)
        return x

    def keep_largest(name, fn):
        def wrapped(*args):
            ts = list(tensors(args))
            size = max(t.numel() for t in ts)
            if ts[0].is_cuda and size > largest.get(name, (0, None))[0]:
                largest[name] = (size, copy(args))
            return fn(*args)
        return wrapped

    for name, mod in sites.items():
        setattr(mod, name, keep_largest(name, KERNEL[name][0]))
    nat.reset_launch_counts()
    t0 = time.perf_counter()
    srs_len = vm.required_srs_len(io, steps, rows)
    pcs_f = HyperKZG.setup(srs_len, device=dev)
    pre_f = vm.preprocess(rows, pcs_f)
    torch.cuda.synchronize()
    setup_f = time.perf_counter() - t0
    t0 = time.perf_counter()
    proof, com, tr, acc = vm.prove(io, steps, pre_f)
    torch.cuda.synchronize()
    warm_f = time.perf_counter() - t0
    fib_counts = nat.launch_counts()
    for name, mod in sites.items():
        setattr(mod, name, KERNEL[name][0])
    print(f"phase 6: HyperKZG setup ({srs_len} points) + preprocessing "
          f"{setup_f:.3f} s; warm-up prove {warm_f:.3f} s; main-path "
          f"launches (setup + this prove) {json.dumps(fib_counts)}",
          flush=True)
    missing = [k for k in ("mont_mul", "mont_mul_bl", "gp_pair_evals",
                           "gp_pair_bind", "proj_cadd") if fib_counts[k] <= 0]
    if missing:
        fail(f"kernels of the Jolt VM path never launched: {missing}")
    unseen = [k for k, v in fib_counts.items() if v and k not in largest]
    if unseen:
        fail(f"launches that bypassed the recording wrappers: {unseen}")
    for name in KERNEL:                 # the fib path's shapes, as phase 2
        if name in largest:
            args = largest.pop(name)[1]
            shape = " x ".join(str(list(t.shape)) for t in tensors(args))
            if isinstance(args[0], FieldSpec):
                shape += f" {args[0].name}"
            compare("phase 6 fib", name, shape, args)
            del args
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    vm.verify(pre_f, proof, com, debug_transcript=tr, debug_accumulator=acc)
    print(f"phase 6: verifier accepts ({time.perf_counter() - t0:.3f} s, "
          f"with the debug oracles)", flush=True)
    ops = proof.instruction_lookups.primary_sumcheck.openings
    good = ops.lookup_outputs_opening
    ops.lookup_outputs_opening = good + FElt(1, FR)
    try:
        vm.verify(pre_f, proof, com)
    except VerificationError as e:
        print(f"phase 6: a proof with its lookup-outputs opening bumped by "
              f"one is rejected ({e})", flush=True)
    else:
        fail("a proof with an opening bumped by one verified")
    ops.lookup_outputs_opening = good
    nat.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    proof, com, tr, acc = vm.prove(io, steps, pre_f)
    torch.cuda.synchronize()
    prove_f = time.perf_counter() - t0
    fib_prove_counts = nat.launch_counts()
    t0 = time.perf_counter()
    vm.verify(pre_f, proof, com)
    verify_f = time.perf_counter() - t0
    print(f"phase 6: Jolt VM fib({FIB_N}) T=2^16 C=4 M=2^16 HyperKZG: "
          f"prove_s={prove_f:.3f} verify_s={verify_f:.3f} "
          f"peak_mem_GB={torch.cuda.max_memory_allocated() / 1e9:.2f} "
          f"[{card}]", flush=True)
    print(f"phase 6: launches per T=2^16 prove "
          f"{json.dumps(fib_prove_counts)}", flush=True)
    del proof, com, tr, acc, pre_f, pcs_f
    torch.cuda.empty_cache()

    # -- phase 7: fib(3) on the card, on the CPU, and jolt_tpu's ----------
    with np.load(ROOT / "fixtures" / "port" / "fib3_hyperkzg.npz") as z:
        frozen = [bytes(row) for row in z["state_history"]]
    vm3 = cli.fib_vm(1 << 8)
    steps3, io3, rows3 = trace_program(fibonacci_program(3), vm3,
                                       max_input_size=32, max_output_size=32)
    hist = {}
    for d in (dev, torch.device("cpu")):
        t0 = time.perf_counter()
        pcs3 = HyperKZG.setup(1 << 8, device=d)
        pre3 = vm3.preprocess(rows3, pcs3)
        p3, c3, t3, _ = vm3.prove(io3, steps3, pre3)
        vm3.verify(pre3, p3, c3, debug_transcript=t3)
        hist[d.type] = t3.state_history
        print(f"phase 7: fib(3) M=2^8 HyperKZG on {d.type}: "
              f"{len(t3.state_history)} transcript states, proved and "
              f"verified in {time.perf_counter() - t0:.2f} s", flush=True)
    if hist["cuda"] != hist["cpu"]:
        fail("fib(3): card and CPU transcripts differ")
    if hist["cuda"] != frozen:
        fail("fib(3): the transcript differs from jolt_tpu's "
             "(fixtures/port/fib3_hyperkzg.npz)")
    print("phase 7: fib(3) card == CPU == jolt_tpu transcript "
          f"({len(frozen)} states)", flush=True)

    # -- summary ----------------------------------------------------------
    kernels = []
    for k in nat.KERNELS:
        r = results[k.name]["phase 2"]
        row = {
            "name": k.name, "route": "cuda", "source": k.source_path,
            "replaces": k.replaces, "launches": main_counts[k.name],
            "max_abs_err": max(v["max_abs_err"] for v in
                               [*results[k.name].values(),
                                *more.get(k.name, [])]),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None, "bytes_bound_ms": r["bytes_bound_ms"],
            "ops_bound_ms": r["ops_bound_ms"], "shape": r["shape"],
            "launches_per_prove": prove_counts[k.name],
            "launches_fib_main_path": fib_counts[k.name],
            "launches_per_fib_prove": fib_prove_counts[k.name]}
        row.update(usage[k.name])
        if k.name in more:
            row["more_shapes"] = more[k.name]
        if "phase 6 fib" in results[k.name]:
            row["at_fib_shape"] = results[k.name]["phase 6 fib"]
        if k.name in OFF_PATH:
            row["off_main_path"] = OFF_PATH[k.name]
        kernels.append(row)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
