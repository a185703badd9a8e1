// K10, K11: the field programs that jolt_tpu runs as one jax.jit program
// per call, each as one launch.
//
// K10 `field_addsub_kernel` replaces jolt_tpu/field/device.py's
// `_fadd_jit` and `_fsub_jit` (and `fneg`, a subtraction from zero):
// (a + b) mod p, (a - b) mod p or (0 - b) mod p elementwise over limb
// tensors [16, *batch].  Each operand is indexed as K1's are (csrc/mont.cu):
// (bb, i) with a batch stride, a limb stride and an element stride, so a
// broadcast scalar (strides 0) or a half of a wider tensor (the lo/hi
// halves of a bind, the round split of the primary sumcheck) goes in as a
// view, with no copy.  The output is contiguous.
//
// K11 `field_sum_kernel` replaces `_fsum_jit`: the modular sum along one
// axis, as `rows` sums of `n` terms each (the wrapper moves the summed
// axis last as a view; term k of row r sits at r*rs + k*es).
//
// Bound on the H100: bytes.  K10 reads two elements and writes one (192 B
// of int32 limbs; a [16, 55, 2^15] half is 0.35 GB, 0.10 ms at 3.35
// TB/s), with one 8-word add and one conditional subtract; K11 reads each
// term once (64 B) for one add.  At the prover's sizes every bound is
// microseconds, so the launch and the wrapper's host time are what count:
// the design is one launch per call with no scratch copies.
//
// The sum's design.  Sums mod p are unique, so any order of add_mods gives
// jolt_tpu's bits.  The work is cut into segments of one row's terms, one
// warp each, in one of two layouts that the wrapper picks from the
// strides, so that a warp's loads are coalesced:
//   - lanes along the row (ROWS_FAST = 0; rs >= es, or few rows): a warp
//     sums a chunk of one row, lane j the terms j, j + 32, ...; a shuffle
//     tree sums the 32 lanes;
//   - lanes across rows (ROWS_FAST = 1; many rows with es != 1, as in a
//     sum over the leading axis of [16, m, n]): a warp takes 32 rows and a
//     chunk of their terms, one row per lane.
// The wrapper cuts each row into `chunks` so that about one wave of warps
// runs (field/kernels.py `sum_plan`).  With one chunk a warp writes its
// rows' sums.  With more, each segment's sum goes to `partials`, and the
// last warp to finish a row (or a group of 32 rows) -- an atomic ticket on
// a counter that the wrapper allocates once per stream and that warp
// resets to 0 -- sums the row's partials and writes the output: one launch
// for any length, 1 to 2^20 and beyond.
#include "field.cuh"

namespace {

constexpr int OPS_THREADS = 256;

// op: 0 a + b, 1 a - b, 2 0 - b (a is not read)
__global__ void __launch_bounds__(OPS_THREADS)
field_addsub_kernel(const int32_t* __restrict__ a,
                    const int32_t* __restrict__ b, int32_t* __restrict__ out,
                    long long n, long long s, long long a_bs, long long a_ls,
                    long long a_es, long long b_bs, long long b_ls,
                    long long b_es, long long o_ls, int op, jt::Field F) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += step) {
    const long long bb = s == n ? 0 : e / s;
    const long long i = e - bb * s;
    const jt::Fe y = jt::load_limbs(b + bb * b_bs + i * b_es, b_ls);
    jt::Fe r;
    if (op == 2) {
      r = jt::fsub(jt::fe_zero(), y, F);
    } else {
      const jt::Fe x = jt::load_limbs(a + bb * a_bs + i * a_es, a_ls);
      r = op == 0 ? jt::fadd(x, y, F) : jt::fsub(x, y, F);
    }
    jt::store_limbs(out + e, o_ls, r);
  }
}

// out[:, r] = sum_k a[r, k] mod p for r < rows, k < n; limb l of term
// (r, k) at a + r*rs + k*es + l*ls.  Segment seg of the layout covers
// terms [c*chunk, (c+1)*chunk) of one row (ROWS_FAST = 0: row seg /
// chunks) or of 32 rows (ROWS_FAST = 1: rows 32*(seg / chunks) + lane),
// c = seg % chunks.  partials: one 8-word sum per (row, chunk);
// counters: one per row (or group of 32 rows), 0 between launches.
// a tensor's terms: term k of row r at a + r*rs + k*es, limb l at + l*ls.
// One struct argument: with the pointer and strides as four arguments
// ptxas takes 40 registers in place of 48 and the sum runs 8-20 % slower
// on an H100 (0.058 against 0.048 ms over 2^20 terms).
struct Terms {
  const int32_t* a;
  long long ls, es, rs;
};

__global__ void __launch_bounds__(OPS_THREADS)
field_sum_kernel(Terms t, long long rows, long long n, long long chunk,
                 long long chunks, int rows_fast,
                 uint32_t* __restrict__ partials,
                 unsigned int* __restrict__ counters,
                 int32_t* __restrict__ out, long long o_ls, jt::Field F) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * (OPS_THREADS / 32);
  const long long groups = rows_fast ? (rows + 31) / 32 : rows;
  for (long long seg = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
       seg < groups * chunks; seg += warps) {
    const long long g = seg / chunks, c = seg - g * chunks;
    const long long k0 = c * chunk;
    const long long k1 = k0 + chunk < n ? k0 + chunk : n;
    // this lane's row, and whether it holds one
    const long long r = rows_fast ? g * 32 + lane : g;
    const bool live = r < rows;
    jt::Fe acc = jt::fe_zero();
    if (rows_fast) {
      if (live)
        for (long long k = k0; k < k1; k++)
          acc = jt::fadd(acc, jt::load_limbs(t.a + r * t.rs + k * t.es, t.ls), F);
    } else {
      for (long long k = k0 + lane; k < k1; k += 32)
        acc = jt::fadd(acc, jt::load_limbs(t.a + r * t.rs + k * t.es, t.ls), F);
      acc = jt::warp_sum(acc, F);     // lane 0 holds the segment's sum
    }
    const bool writer = rows_fast ? live : lane == 0;
    if (chunks == 1) {
      if (writer) jt::store_limbs(out + r, o_ls, acc);
      continue;
    }
    if (writer) {
      jt::put_words(partials + (r * chunks + c) * 8, acc);
      __threadfence();
    }
    __syncwarp();
    unsigned int ticket = 0;
    if (lane == 0) ticket = atomicAdd(counters + g, 1u);
    ticket = __shfl_sync(0xffffffffu, ticket, 0);
    if (ticket != chunks - 1) continue;
    // the last segment of this row (group): sum its partials
    __threadfence();
    acc = jt::fe_zero();
    if (rows_fast) {
      if (live)
        for (long long j = 0; j < chunks; j++)
          acc = jt::fadd(acc, jt::get_words(partials + (r * chunks + j) * 8),
                         F);
    } else {
      for (long long j = lane; j < chunks; j += 32)
        acc = jt::fadd(acc, jt::get_words(partials + (r * chunks + j) * 8),
                       F);
      acc = jt::warp_sum(acc, F);
    }
    if (writer) jt::store_limbs(out + r, o_ls, acc);
    if (lane == 0) counters[g] = 0;
  }
}

long long warps_blocks(long long warps) {
  const long long per = OPS_THREADS / 32;
  const long long b = (warps + per - 1) / per;
  const long long cap = 1LL << 20;
  return b < 1 ? 1 : (b > cap ? cap : b);
}

}  // namespace

// K10.  out[:, bb*s + i] = a[bb, i] op b[bb, i] for bb < B, i < s; limb k
// of element (bb, i) of x at x + bb*x_bs + i*x_es + k*x_ls; out [16, B*s].
extern "C" int jt_field_addsub(const int32_t* a, const int32_t* b,
                               int32_t* out, long long B, long long s,
                               long long a_bs, long long a_ls, long long a_es,
                               long long b_bs, long long b_ls, long long b_es,
                               long long op, const uint32_t* field,
                               void* stream) {
  if (op < 0 || op > 2 || B < 0 || s < 0) return (int)cudaErrorInvalidValue;
  const long long n = B * s;
  if (n == 0) return 0;
  const jt::Field F = jt::make_field(field);
  field_addsub_kernel<<<jt_blocks(n, OPS_THREADS), OPS_THREADS, 0,
                        (cudaStream_t)stream>>>(a, b, out, n, s, a_bs, a_ls,
                                                a_es, b_bs, b_ls, b_es, n,
                                                (int)op, F);
  return (int)cudaGetLastError();
}

// K11.  out[:, r] = sum_{k < n} a[r, k] mod p; limb l of term (r, k) at
// a + r*rs + k*es + l*ls; out [16, rows].  chunk, chunks and rows_fast
// come from sum_plan (field/kernels.py); partials holds rows x chunks x 8
// words and counters one word per row (rows_fast: per 32 rows), all 0.
extern "C" int jt_field_sum(const int32_t* a, int32_t* out, long long rows,
                            long long n, long long rs, long long ls,
                            long long es, long long chunk, long long chunks,
                            long long rows_fast, uint32_t* partials,
                            unsigned int* counters, const uint32_t* field,
                            void* stream) {
  if (rows < 1 || n < 1 || chunk < 1 || chunks < 1 ||
      (chunks - 1) * chunk >= n || chunks * chunk < n)
    return (int)cudaErrorInvalidValue;
  const jt::Field F = jt::make_field(field);
  const long long groups = rows_fast ? (rows + 31) / 32 : rows;
  field_sum_kernel<<<(unsigned int)warps_blocks(groups * chunks),
                     OPS_THREADS, 0, (cudaStream_t)stream>>>(
      Terms{a, ls, es, rs}, rows, n, chunk, chunks, (int)rows_fast,
      partials, counters, out, rows, F);
  return (int)cudaGetLastError();
}
