#!/usr/bin/env python3
"""One Keccak-f[1600] permutation and one Montgomery product of the
transcript kernels' source (csrc/keccak.cu), measured on their own on a
CUDA card.

    python3 scripts/probe_keccak.py [--root DIR]

Compiles DIR's jolt_tpu_torch/csrc/keccak.cu (default: this checkout),
#included whole, with a few probe kernels beside it, by nvcc for sm_90a
with `-Xptxas -v`, into jolt_tpu_torch/_build/ of this checkout, and
prints:
  - ptxas's registers, spills, stack and shared memory of every kernel
    function in that library (K8's, K9's and the probes');
  - the SASS instructions (cuobjdump) of one permutation and of one
    `jt::fmul`, each in a probe kernel that runs it once: the static
    count and the count issued, where a loop's body counts as often as it
    runs (the one-thread design's round loop, `#pragma unroll 1`, 24
    times), with the shuffles and the integer multiply-adds among them;
  - on the card: a permutation chained 1 and 1,001 times in one launch
    (us a permutation: the difference over 1,000), the same for a
    product chained on itself, and the probe's permutation against
    utils/keccak_device.py's keccak_f_plain on a random state.

The source's design is read from it: `keccak_f_warp` (one warp holds the
state) or the one-thread `keccak_f`.  With the warp design, three other
exchanges of the same round, defined here (WARP_ALTERNATIVES), are
counted, checked and timed beside it.  Prints the card's name and power
limit first and a JSON line last.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ROUNDS = 24

PROBE_COMMON = r"""
extern "C" __global__ void probe_fmul_once(const uint32_t* a,
                                           const uint32_t* b, uint32_t* out,
                                           jt::Field F) {
  jt::Fe x, y;
  for (int k = 0; k < 8; k++) { x.w[k] = a[k]; y.w[k] = b[k]; }
  x = jt::fmul(x, y, F);
  for (int k = 0; k < 8; k++) out[k] = x.w[k];
}

extern "C" __global__ void probe_fmul_loop(const uint32_t* a,
                                           const uint32_t* b, uint32_t* out,
                                           int n, jt::Field F) {
  jt::Fe x, y;
  for (int k = 0; k < 8; k++) { x.w[k] = a[k]; y.w[k] = b[k]; }
  for (int i = 0; i < n; i++) x = jt::fmul(x, y, F);
  for (int k = 0; k < 8; k++) out[k] = x.w[k];
}

extern "C" int probe_fmul(const uint32_t* a, const uint32_t* b,
                          uint32_t* out, int n, const uint32_t* field,
                          void* stream) {
  probe_fmul_loop<<<1, 1, 0, (cudaStream_t)stream>>>(a, b, out, n,
                                                     jt::make_field(field));
  return (int)cudaGetLastError();
}
"""

# the one-thread design: 25 uint64 lanes in one thread's registers
PROBE_THREAD = r"""
__device__ __forceinline__ void probe_load(uint64_t a[25],
                                           const uint32_t* w) {
#pragma unroll
  for (int i = 0; i < 25; i++)
    a[i] = (uint64_t)w[2 * i] | ((uint64_t)w[2 * i + 1] << 32);
}
__device__ __forceinline__ void probe_store(const uint64_t a[25],
                                            uint32_t* w) {
#pragma unroll
  for (int i = 0; i < 25; i++) {
    w[2 * i] = (uint32_t)a[i];
    w[2 * i + 1] = (uint32_t)(a[i] >> 32);
  }
}

extern "C" __global__ void probe_perm_once(const uint32_t* in,
                                           uint32_t* out) {
  uint64_t a[25];
  probe_load(a, in);
  keccak_f(a);
  probe_store(a, out);
}

extern "C" __global__ void probe_perm_loop(const uint32_t* in, uint32_t* out,
                                           int n) {
  uint64_t a[25];
  probe_load(a, in);
  for (int i = 0; i < n; i++) keccak_f(a);
  probe_store(a, out);
}

extern "C" int probe_perm(const uint32_t* in, uint32_t* out, int n,
                          void* stream) {
  probe_perm_loop<<<1, 1, 0, (cudaStream_t)stream>>>(in, out, n);
  return (int)cudaGetLastError();
}
"""

# the warp design (lane t holds state lane t), and three other exchanges
# of the same round for comparison: the four-stage one (pi, then chi, as
# their own shuffle stages: 18 shuffles), the row-slot one (each lane also
# keeps state lanes (x + 1, y) and (x - 1, y), so theta is one stage of 16
# shuffles and pi with chi one of 10: two stages), and the row-slot one
# through shared memory (a 16-byte store and four 16-byte loads, an 8-byte
# store and five 8-byte loads a round)
PROBE_WARP = r"""
#define PROBE_FULL 0xFFFFFFFFu
__device__ __forceinline__ void probe_load(uint32_t& lo, uint32_t& hi,
                                           const uint32_t* w) {
  const int t = threadIdx.x, i = t < 25 ? t : 0;
  lo = t < 25 ? w[2 * i] : 0u;
  hi = t < 25 ? w[2 * i + 1] : 0u;
}
__device__ __forceinline__ void probe_store(uint32_t lo, uint32_t hi,
                                            uint32_t* w) {
  const int t = threadIdx.x;
  if (t < 25) {
    w[2 * t] = lo;
    w[2 * t + 1] = hi;
  }
}

// the alternatives' lane constants are computed here, each then held in a
// register (the empty asm), as keccak.cu's are read from its table
__device__ __forceinline__ uint32_t probe_reg(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

// lane t = x + 5y of the alternatives; idle lanes read themselves
struct ProbeLane {
  uint32_t x, y, column[4], left, right, src[5], rot, swap, iota, row[4];
};
__device__ __forceinline__ ProbeLane probe_lane(int t) {
  const int R[5][5] = {{0, 36, 3, 41, 18}, {1, 44, 10, 45, 2},
                       {62, 6, 43, 15, 61}, {28, 55, 25, 21, 56},
                       {27, 20, 39, 8, 14}};
  const bool on = t < 25;
  const int x = on ? t % 5 : 0, y = on ? t / 5 : 0;
  ProbeLane T;
  T.x = x;
  T.y = y;
  for (int j = 0; j < 4; j++)
    T.column[j] = probe_reg(on ? x + 5 * ((y + 1 + j) % 5) : t);
  T.left = probe_reg(on ? (x + 4) % 5 + 5 * y : t);
  T.right = probe_reg(on ? (x + 1) % 5 + 5 * y : t);
  for (int j = 0; j < 5; j++) {       // the lane whose rho output is B[x+j, y]
    const int X = (x + j) % 5, xs = ((3 * (y - 3 * X)) % 5 + 5) % 5;
    T.src[j] = probe_reg(on ? xs + 5 * X : t);
  }
  for (int j = 0; j < 2; j++)          // lanes (x + 1, y), (x + 2, y)
    T.row[j] = probe_reg(on ? (x + 1 + j) % 5 + 5 * y : t);
  T.rot = probe_reg(on ? R[x][y] : 0);
  T.swap = probe_reg(T.rot >= 32);
  T.iota = probe_reg(t == 0 ? PROBE_FULL : 0u);
  return T;
}

__device__ __forceinline__ void probe_rho(uint32_t al, uint32_t ah,
                                          const ProbeLane& T, uint32_t& bl,
                                          uint32_t& bh) {
  const uint32_t P = __funnelshift_l(al, ah, T.rot);
  const uint32_t Q = __funnelshift_l(ah, al, T.rot);
  bh = T.swap ? Q : P;
  bl = T.swap ? P : Q;
}

// four stages: C[x], C[x -+ 1], pi, then chi
__device__ __forceinline__ void keccak_f_four_stage(uint32_t& lo,
                                                    uint32_t& hi,
                                                    const ProbeLane& T) {
#pragma unroll
  for (int r = 0; r < 24; r++) {
    uint32_t v[4][2];
#pragma unroll
    for (int j = 0; j < 4; j++) {
      v[j][0] = __shfl_sync(PROBE_FULL, lo, T.column[j]);
      v[j][1] = __shfl_sync(PROBE_FULL, hi, T.column[j]);
    }
    const uint32_t cl = (lo ^ v[0][0] ^ v[1][0]) ^ (v[2][0] ^ v[3][0]);
    const uint32_t ch = (hi ^ v[0][1] ^ v[1][1]) ^ (v[2][1] ^ v[3][1]);
    const uint32_t ml = __shfl_sync(PROBE_FULL, cl, T.left);
    const uint32_t mh = __shfl_sync(PROBE_FULL, ch, T.left);
    const uint32_t pl = __shfl_sync(PROBE_FULL, cl, T.right);
    const uint32_t ph = __shfl_sync(PROBE_FULL, ch, T.right);
    uint32_t bl, bh;
    probe_rho(lo ^ ml ^ __funnelshift_l(ph, pl, 1),
              hi ^ mh ^ __funnelshift_l(pl, ph, 1), T, bl, bh);
    const uint32_t b0l = __shfl_sync(PROBE_FULL, bl, T.src[0]);
    const uint32_t b0h = __shfl_sync(PROBE_FULL, bh, T.src[0]);
    const uint32_t b1l = __shfl_sync(PROBE_FULL, b0l, T.row[0]);
    const uint32_t b1h = __shfl_sync(PROBE_FULL, b0h, T.row[0]);
    const uint32_t b2l = __shfl_sync(PROBE_FULL, b0l, T.row[1]);
    const uint32_t b2h = __shfl_sync(PROBE_FULL, b0h, T.row[1]);
    const uint32_t rl = (uint32_t)keccak_rc(r);
    const uint32_t rh = (uint32_t)(keccak_rc(r) >> 32);
    lo = (b0l ^ (rl & T.iota)) ^ (~b1l & b2l);
    hi = (b0h ^ (rh & T.iota)) ^ (~b1h & b2h);
  }
}

// row slots: s[0] = A[x, y], s[1] = A[x + 1, y], s[2] = A[x - 1, y]
__device__ __forceinline__ void row_slots_chi(const uint32_t* c,
                                              uint32_t rk, uint32_t iota0,
                                              uint32_t iota1, uint32_t iota2,
                                              uint32_t* s) {
  s[0] = (c[0] ^ (rk & iota0)) ^ (~c[1] & c[2]);
  s[1] = (c[1] ^ (rk & iota1)) ^ (~c[2] & c[3]);
  s[2] = (c[4] ^ (rk & iota2)) ^ (~c[0] & c[1]);
}

template <bool SMEM>
__device__ __forceinline__ void keccak_f_row_slots(uint32_t* lo, uint32_t* hi,
                                                   const ProbeLane& T,
                                                   uint4* th, uint2* cb) {
  const int t = threadIdx.x & 31;
  // the slot holding (0, 0): lanes (0, 0), (4, 0), (1, 0)
  const uint32_t i0 = probe_reg(t == 0 ? PROBE_FULL : 0u);
  const uint32_t i1 = probe_reg(t == 4 ? PROBE_FULL : 0u);
  const uint32_t i2 = probe_reg(t == 1 ? PROBE_FULL : 0u);
#pragma unroll
  for (int r = 0; r < 24; r++) {
    uint32_t g[4][4];
    if (SMEM) {
      th[t] = make_uint4(lo[1], hi[1], lo[2], hi[2]);
      __syncwarp();
#pragma unroll
      for (int j = 0; j < 4; j++) {
        const uint4 q = th[T.column[j]];
        g[j][0] = q.x; g[j][1] = q.y; g[j][2] = q.z; g[j][3] = q.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; j++) {
        g[j][0] = __shfl_sync(PROBE_FULL, lo[1], T.column[j]);
        g[j][1] = __shfl_sync(PROBE_FULL, hi[1], T.column[j]);
        g[j][2] = __shfl_sync(PROBE_FULL, lo[2], T.column[j]);
        g[j][3] = __shfl_sync(PROBE_FULL, hi[2], T.column[j]);
      }
    }
    const uint32_t pl = (lo[1] ^ g[0][0] ^ g[1][0]) ^ (g[2][0] ^ g[3][0]);
    const uint32_t ph = (hi[1] ^ g[0][1] ^ g[1][1]) ^ (g[2][1] ^ g[3][1]);
    const uint32_t ml = (lo[2] ^ g[0][2] ^ g[1][2]) ^ (g[2][2] ^ g[3][2]);
    const uint32_t mh = (hi[2] ^ g[0][3] ^ g[1][3]) ^ (g[2][3] ^ g[3][3]);
    uint32_t bl, bh;
    probe_rho(lo[0] ^ ml ^ __funnelshift_l(ph, pl, 1),
              hi[0] ^ mh ^ __funnelshift_l(pl, ph, 1), T, bl, bh);
    uint32_t cl[5], ch[5];
    if (SMEM) {
      cb[t] = make_uint2(bl, bh);
      __syncwarp();
#pragma unroll
      for (int j = 0; j < 5; j++) {
        const uint2 q = cb[T.src[j]];
        cl[j] = q.x;
        ch[j] = q.y;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 5; j++) {
        cl[j] = __shfl_sync(PROBE_FULL, bl, T.src[j]);
        ch[j] = __shfl_sync(PROBE_FULL, bh, T.src[j]);
      }
    }
    row_slots_chi(cl, (uint32_t)keccak_rc(r), i0, i1, i2, lo);
    row_slots_chi(ch, (uint32_t)(keccak_rc(r) >> 32), i0, i1, i2, hi);
  }
}

extern "C" __global__ void probe_perm_once(const uint32_t* in,
                                           uint32_t* out) {
  const KfLane T = kf_lane(threadIdx.x);
  KfState s;
  probe_load(s.lo, s.hi, in);
  keccak_f_warp(s, T);
  probe_store(s.lo, s.hi, out);
}

extern "C" __global__ void probe_perm_loop(const uint32_t* in, uint32_t* out,
                                           int n) {
  const KfLane T = kf_lane(threadIdx.x);
  KfState s;
  probe_load(s.lo, s.hi, in);
  for (int i = 0; i < n; i++) keccak_f_warp(s, T);
  probe_store(s.lo, s.hi, out);
}

extern "C" __global__ void probe_four_stage_once(const uint32_t* in,
                                                 uint32_t* out) {
  const ProbeLane T = probe_lane(threadIdx.x);
  uint32_t lo, hi;
  probe_load(lo, hi, in);
  keccak_f_four_stage(lo, hi, T);
  probe_store(lo, hi, out);
}

extern "C" __global__ void probe_four_stage_loop(const uint32_t* in,
                                                 uint32_t* out, int n) {
  const ProbeLane T = probe_lane(threadIdx.x);
  uint32_t lo, hi;
  probe_load(lo, hi, in);
  for (int i = 0; i < n; i++) keccak_f_four_stage(lo, hi, T);
  probe_store(lo, hi, out);
}

template <bool SMEM>
__device__ __forceinline__ void row_slots_run(const uint32_t* in,
                                              uint32_t* out, int n) {
  __shared__ uint4 th[32];
  __shared__ uint2 cb[32];
  const ProbeLane T = probe_lane(threadIdx.x);
  const bool on = threadIdx.x < 25;
  const int lane[3] = {(int)(T.x + 5 * T.y), (int)((T.x + 1) % 5 + 5 * T.y),
                       (int)((T.x + 4) % 5 + 5 * T.y)};
  uint32_t lo[3], hi[3];
#pragma unroll
  for (int k = 0; k < 3; k++) {
    lo[k] = on ? in[2 * lane[k]] : 0u;
    hi[k] = on ? in[2 * lane[k] + 1] : 0u;
  }
  for (int i = 0; i < n; i++) keccak_f_row_slots<SMEM>(lo, hi, T, th, cb);
  probe_store(lo[0], hi[0], out);
}

extern "C" __global__ void probe_row_slots_once(const uint32_t* in,
                                                uint32_t* out) {
  row_slots_run<false>(in, out, 1);
}
extern "C" __global__ void probe_row_slots_loop(const uint32_t* in,
                                                uint32_t* out, int n) {
  row_slots_run<false>(in, out, n);
}
extern "C" __global__ void probe_row_slots_smem_once(const uint32_t* in,
                                                     uint32_t* out) {
  row_slots_run<true>(in, out, 1);
}
extern "C" __global__ void probe_row_slots_smem_loop(const uint32_t* in,
                                                     uint32_t* out, int n) {
  row_slots_run<true>(in, out, n);
}

#define PROBE_LAUNCHER(name)                                              \
  extern "C" int probe_##name(const uint32_t* in, uint32_t* out, int n,   \
                              void* stream) {                             \
    probe_##name##_loop<<<1, 32, 0, (cudaStream_t)stream>>>(in, out, n);  \
    return (int)cudaGetLastError();                                       \
  }
PROBE_LAUNCHER(perm)
PROBE_LAUNCHER(four_stage)
PROBE_LAUNCHER(row_slots)
PROBE_LAUNCHER(row_slots_smem)
"""
WARP_ALTERNATIVES = ("four_stage", "row_slots", "row_slots_smem")


def design(source: str) -> str:
    if "keccak_f_warp" in source:
        return "warp"
    if re.search(r"void keccak_f\(uint64_t a\[25\]\)", source):
        return "thread"
    sys.exit("probe_keccak: no Keccak-f of a known design in the source")


def sass_functions(lib: Path) -> dict[str, list[tuple[int, str, str]]]:
    """{function: [(address, opcode, line)]} of a library's SASS."""
    tool = Path("/usr/local/cuda/bin/cuobjdump")
    out = subprocess.run([str(tool if tool.exists() else "cuobjdump"),
                          "-sass", str(lib)], capture_output=True,
                         text=True, check=True).stdout
    funcs, fn = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            funcs[fn] = []
            continue
        m = re.match(r"\s+/\*([0-9a-f]+)\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)",
                     line)
        if fn and m:
            funcs[fn].append((int(m[1], 16), m[2], line))
    return funcs


def issued(instrs, trips: int) -> dict:
    """Static and issued instruction counts of a probe that runs its
    subject once: a backward branch's body counts `trips` times."""
    ops = [(a, op, line) for a, op, line in instrs if op != "NOP"]
    loops = []
    for a, op, line in ops:
        m = re.search(r"\bBRA(?:\.\w+)*\s+(?:\S+,\s*)?0x([0-9a-f]+)", line)
        if op.startswith("BRA") and m and int(m[1], 16) < a:
            loops.append((int(m[1], 16), a))
    body = [x for x in ops if loops and loops[0][0] <= x[0] <= loops[0][1]]
    extra = (trips - 1) if len(loops) == 1 else 0

    def count(pred):
        return (sum(1 for x in ops if pred(x[1]))
                + extra * sum(1 for x in body if pred(x[1])))
    return {"static": len(ops), "loops": len(loops),
            "loop_body": len(body), "issued": count(lambda op: True),
            "shfl": count(lambda op: op.startswith("SHFL")),
            "imad": count(lambda op: op.startswith("IMAD")
                          and not op.startswith("IMAD.MOV")),
            "lop3": count(lambda op: op.startswith("LOP3")),
            "shf": count(lambda op: op == "SHF" or op.startswith("SHF."))}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path, default=ROOT,
                    help="checkout whose csrc/keccak.cu is probed")
    args = ap.parse_args()
    import ctypes

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("probe_keccak: no CUDA card")
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    root = args.root.resolve()
    sys.path.insert(0, str(ROOT))
    from jolt_tpu_torch import _native as nat
    from jolt_tpu_torch.field.spec import fr_spec
    from jolt_tpu_torch.utils import keccak_device as kd
    card = smoke.card_line()
    print(card, flush=True)

    src = root / "jolt_tpu_torch" / "csrc" / "keccak.cu"
    kind = design(src.read_text())
    nat.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    probe_cu = nat.BUILD_DIR / f"probe_keccak_{kind}.cu"
    probe_cu.write_text(f'#include "{src}"\n' + PROBE_COMMON
                        + (PROBE_WARP if kind == "warp" else PROBE_THREAD))
    lib_file = nat.BUILD_DIR / f"libprobe_keccak_{kind}.so"
    build = subprocess.run([nat._nvcc(), *nat.NVCC_FLAGS, "-Xptxas", "-v",
                            "-o", str(lib_file), str(probe_cu)],
                           capture_output=True, text=True)
    if build.returncode:
        sys.exit(f"probe_keccak: nvcc failed\n{build.stdout}{build.stderr}")
    usage = smoke.ptxas_usage({"probe": build.stdout + build.stderr})
    for fn, u in usage.items():
        print(f"ptxas {fn}: {json.dumps(u)}", flush=True)
    report = {"root": str(args.root), "design": kind, "card": card,
              "ptxas": usage}
    funcs = sass_functions(lib_file)
    perms = ["perm"] + (list(WARP_ALTERNATIVES) if kind == "warp" else [])
    for name, trips in [(f"probe_{p}_once", ROUNDS) for p in perms] + [
            ("probe_fmul_once", 1)]:
        c = issued(funcs[name], trips)
        report[name] = c
        print(f"SASS {name}: {json.dumps(c)}", flush=True)

    lib = ctypes.CDLL(str(lib_file))
    vp = ctypes.c_void_p
    for p in perms:
        getattr(lib, f"probe_{p}").argtypes = [vp, vp, ctypes.c_int, vp]
    lib.probe_fmul.argtypes = [vp, vp, vp, ctypes.c_int,
                               ctypes.POINTER(ctypes.c_uint32), vp]
    dev = torch.device("cuda")
    rng = np.random.default_rng(10)
    words = rng.integers(0, 1 << 32, size=50, dtype=np.uint64)
    w_in = torch.from_numpy(words.astype(np.int64)).to(torch.int32).to(dev)
    w_out = torch.zeros(50, dtype=torch.int32, device=dev)
    stream = vp(torch.cuda.current_stream().cuda_stream)

    want = kd.keccak_f_plain(torch.from_numpy(words.astype(np.int64)))
    runs = {}
    for p in perms:
        def perm(n, fn=getattr(lib, f"probe_{p}")):
            if fn(vp(w_in.data_ptr()), vp(w_out.data_ptr()), n, stream):
                sys.exit(f"probe_keccak: probe_{p} refused its launch")
        perm(1)
        torch.cuda.synchronize()
        got = w_out.cpu().numpy().astype(np.int64) & 0xFFFFFFFF
        if not (got == want.numpy()).all():
            sys.exit(f"probe_keccak: probe_{p}'s permutation differs from "
                     "keccak_f_plain")
        print(f"probe_{p}'s permutation == keccak_f_plain on a random "
              "state", flush=True)
        runs["us_per_permutation" + ("" if p == "perm" else f"_{p}")] = perm

    FR = fr_spec()
    a = torch.arange(1, 9, dtype=torch.int32, device=dev)   # below p
    out = torch.zeros(8, dtype=torch.int32, device=dev)
    field = kd.field_words(FR)

    def fmul(n):
        if lib.probe_fmul(vp(a.data_ptr()), vp(a.data_ptr()),
                          vp(out.data_ptr()), n, field, stream):
            sys.exit("probe_keccak: probe_fmul refused its launch")

    for label, fn in [*runs.items(), ("us_per_fmul", fmul)]:
        t1 = smoke.event_ms(lambda: fn(1), 10)
        t2 = smoke.event_ms(lambda: fn(1001), 10)
        report[label] = (t2 - t1) * 1e3 / 1000
        report[label.replace("us_per", "launch_ms_of_one")] = t1
        print(f"{label}: {report[label]:.4f} (one launch with one: "
              f"{t1:.4f} ms) [{card}]", flush=True)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
