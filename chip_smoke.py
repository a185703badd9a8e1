#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (jolt_tpu_torch) on one GPU.

    python3 chip_smoke.py          # from the root of a checkout, on a CUDA card

Phases (any failure exits non-zero, no phase catches and carries on):
  1. the card's name and power limit (nvidia-smi); build every kernel
     (one nvcc per source, started together) and print each kernel's
     registers and spills as ptxas reports them;
  2. each kernel against its plain PyTorch version on the card, at the
     shapes the nv = 20 Surge prove gives it, compared for equality, and
     timed with CUDA events (kernel_ms, plain_ms, bytes bound);
  3. the main path begins (launch counts set to 0): HyperKZG setup of the
     2^20-point SRS, generated on the card; its first 2^17 points must equal
     fixtures/srs/srs_131072_6a6f6c74.npz bit for bit;
  4. Surge XOR, nv = 20, C = 4, M = 2^16, operands from default_rng(0) as
     `python -m jolt_tpu_torch.cli surge-bench` draws them: one warm-up
     prove (the main path's launch counts are read after it), verify, a
     tampered proof must be rejected, two timed proves and a timed verify;
  5. reference on a small input: Surge at nv = 10 on the card and on the
     CPU (plain versions) must give the same transcript and commitments,
     and two commitments must equal a host MSM.
Then a {"kernels": [...]} JSON line, the card line again, and last
{"ok": true, "device": {...}}.  Imports nothing of JAX or jolt_tpu.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory (data sheet)
NV = 20


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def main() -> None:
    if not (ROOT / "jolt_tpu_torch" / "csrc").is_dir() \
            or not (ROOT / "fixtures" / "srs").is_dir():
        fail("run from the root of a checkout: jolt_tpu_torch/ and "
             "fixtures/ are missing")
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    sys.path.insert(0, str(ROOT))
    from jolt_tpu_torch import _native as nat
    from jolt_tpu_torch import cli
    from jolt_tpu_torch.curve import kernels as ck
    from jolt_tpu_torch.curve.bn254 import G1Jacobian
    from jolt_tpu_torch.curve.device import FOLD_LANES, MSM_CHANNEL_CHUNK
    from jolt_tpu_torch.field import arith
    from jolt_tpu_torch.field import device as fd
    from jolt_tpu_torch.field import kernels as fk
    from jolt_tpu_torch.field.host import FElt
    from jolt_tpu_torch.field.spec import fq_spec, fr_spec
    from jolt_tpu_torch.instructions import XorInstruction
    from jolt_tpu_torch.lasso import (SurgePreprocessing, generate_witness,
                                      surge_prove, surge_verify)
    from jolt_tpu_torch.commitment.hyperkzg import HyperKZG
    from jolt_tpu_torch.subprotocols.sumcheck import VerificationError

    dev = torch.device("cuda")
    FR, FQ = fr_spec(), fq_spec()
    card = card_line()
    print(card, flush=True)

    # -- phase 1: build --------------------------------------------------
    t0 = time.perf_counter()
    reports = nat.build(ptxas_verbose=True)
    print(f"phase 1: built {len(nat.SOURCES)} kernel libraries in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, text in reports.items():          # registers and spills
        for line in text.splitlines():
            if "Compiling entry" in line or "registers" in line \
                    or "spill" in line:
                print(f"phase 1: {name}.cu: {line.strip()}", flush=True)

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

    def event_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def as_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    results = {}

    def compare(name, shape, kernel_fn, plain_fn, nbytes, record=True):
        got = as_tuple(kernel_fn())
        want = as_tuple(plain_fn())
        torch.cuda.synchronize()
        err = max(int((g.long() - w.long()).abs().max()) for g, w in
                  zip(got, want))
        if err != 0 or any(g.shape != w.shape for g, w in zip(got, want)):
            fail(f"{name}: kernel and plain version differ (max abs err "
                 f"{err})")
        del got, want
        kernel_ms = event_ms(kernel_fn, 10)
        plain_ms = event_ms(plain_fn, 1)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        print(f"phase 2: {name} shape={shape} kernel_ms={kernel_ms:.4f} "
              f"plain_ms={plain_ms:.2f} bytes={nbytes} "
              f"bound_ms={bound_ms:.4f} max_abs_err={err}", flush=True)
        if record:
            results[name] = dict(shape=shape, max_abs_err=err, ms=kernel_ms,
                                 plain_ms=plain_ms, bound_ms=bound_ms)

    n = 1 << NV
    L4 = 16 * 4                         # bytes of one limb column (int32)
    # K1, Fr: the witness's to-Montgomery pass, [16, 4, 2^20] x R^2
    a = rand_fe(FR, 4, n)
    r2 = arith.const_limbs(FR, "r2", dev).reshape(16, 1, 1)
    compare("mont_mul", "[16,4,2^20] x [16,1,1] Fr",
            lambda: fk.mont_mul(FR, a, r2),
            lambda: arith.mont_mul(FR, a, r2), 2 * 4 * n * L4 + L4)
    del a
    # K1, Fq: Jacobian -> projective of the SRS, [16, 2^20] x [16, 2^20]
    a, b = rand_fe(FQ, n), rand_fe(FQ, n)
    compare("mont_mul", "[16,2^20] x [16,2^20] Fq",
            lambda: fk.mont_mul(FQ, a, b),
            lambda: arith.mont_mul(FQ, a, b), 3 * n * L4, record=False)
    del a, b
    # K4, K2, K3: the read/write GP's leaf layer, B = 8, s = 2^19
    B, s = 8, n // 2
    pair = rand_fe(FR, B, 2 * s).movedim(0, 1).contiguous()   # [8, 16, 2^20]
    l, r = pair[..., :s], pair[..., s:]
    eq = rand_fe(FR, s)
    coeffs = rand_fe(FR, B)
    compare("mont_mul_bl", "[8,16,2^19] x [8,16,2^19] Fr",
            lambda: fk.mont_mul_bl(FR, l, r),
            lambda: fk.mont_mul_bl_plain(FR, l, r), 3 * B * s * L4)
    compare("gp_pair_evals", "l,r [8,16,2^19], eq [16,2^19], coeffs [16,8]",
            lambda: fk.gp_pair_evals(FR, l, r, eq, coeffs),
            lambda: fk.gp_pair_evals_plain(FR, l, r, eq, coeffs),
            (2 * B + 1) * s * L4 + B * L4 + 3 * L4)
    rc = fd.scalar_to_device(FR, 0x1234567 ** 9, "cpu")
    compare("gp_pair_bind", "l,r [8,16,2^19], eq [16,2^19] -> halves",
            lambda: fk.gp_pair_bind(FR, l, r, eq, rc),
            lambda: fk.gp_pair_bind_plain(FR, l, r, eq, rc),
            (2 * B + 1) * (s + s // 2) * L4 + L4)
    del pair, l, r, eq
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
    p1, p2 = tuple(proj), tuple(other)
    compare("proj_cadd", f"[16,{T},{K}] x 6 -> 3 Fq",
            lambda: ck.proj_cadd(p1, p2),
            lambda: ck.proj_cadd_plain(p1, p2), 9 * T * K * L4)
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
    compare("jac_add", f"[16,{W2},2^18] x 6 -> 3 Fq",
            lambda: ck.jac_add(p1, p2),
            lambda: ck.jac_add_plain(p1, p2), 9 * W2 * C * L4)
    del q1, q2, p1, p2, idx
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
    missing = [k for k, v in main_counts.items() if v <= 0]
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

    # -- summary ----------------------------------------------------------
    kernels = []
    for k in nat.KERNELS:
        r = results[k.name]
        kernels.append({
            "name": k.name, "route": "cuda", "source": k.source_path,
            "replaces": k.replaces, "launches": main_counts[k.name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": "bytes", "library_ms": None, "shape": r["shape"],
            "launches_per_prove": prove_counts[k.name]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
