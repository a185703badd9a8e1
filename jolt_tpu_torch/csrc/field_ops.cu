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
// term once (64 B) for one add.  K10's design is one launch per call with
// no scratch copies: at the prover's sizes most calls take microseconds.
//
// The sum's design.  Sums mod p are unique, so any order of adds gives
// jolt_tpu's bits.  One launch at any shape, one resident wave of blocks
// (SUM_MIN_BLOCKS an SM) walking the work by grid stride.  The work is
// cut into tiles of rows and each tile's terms into `chunks` segments,
// a block a segment, so that about one wave of segments exists
// (field/kernels.py `sum_plan`).  A block's threads take a tile's rows in
// one of two layouts, picked by the wrapper from the strides so that a
// warp's loads are coalesced:
//   - along the rows (ACROSS = 0; es == 1, or few rows): `tpr` threads a
//     row (32 to 256, by the row's length), 256 / tpr rows a tile; where
//     the rows are unit stride and 16-byte aligned, from 128 terms a row,
//     a thread loads four consecutive terms of a limb at once (VEC:
//     sixteen 16-byte loads in flight for four terms);
//   - across the rows (ACROSS = 1; many rows with es != 1, as in a sum
//     over the leading axis of [16, m, n]): 32 rows a tile, a lane a row,
//     the block's 8 warps splitting the terms, so that no lane walks a
//     whole row.
// Each thread keeps two lazy sums in [0, 2p) over its terms (two terms'
// loads, or a quad's, issued before their adds).  The block then sums
// each row's threads: a shuffle tree in each warp, then the warps
// through shared memory.  With one segment a tile, the
// block writes its rows' sums.  With more, each segment's row sums go to
// `partials`, and the last block to finish a tile -- an atomic ticket on
// a counter that the wrapper allocates once per stream and that block
// resets to 0 -- sums each row's partials with all its threads (L2
// loads, two sums a thread, the same block tree) and writes the output.
// No atomics on field values.  A whole block sums the partials: a lone
// warp summing a row's 4,096 partials at 2^20 terms (128 dependent L2
// loads and adds a lane) took 0.020 of a 0.049 ms sum on an H100.
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

constexpr int SUM_THREADS = 256;
constexpr int SUM_MIN_BLOCKS = 2;   // blocks an SM: the wrapper's wave

// K11's operand and cut.  Term k of row r at a + r*rs + k*es, limb l at
// + l*ls.  A tile is SUM_THREADS / tpr rows (ACROSS: 32 rows, a warp's
// lanes, and tpr = 8 warps along the terms); a segment is `chunk` terms
// of a tile, `chunks` segments a tile; partials hold 8 words a (row,
// segment), counters one word a tile, 0 between launches.
struct SumArgs {
  const int32_t* a;
  long long ls, es, rs;
  long long rows, n, chunk, chunks, tiles;
  int tpr, across, vec;
  uint32_t* partials;
  unsigned int* counters;
  int32_t* out;                     // [16, rows]
};

// terms k .. k+3 of a row from sixteen 16-byte loads, one a limb
__device__ __forceinline__ void load_quad(const int32_t* __restrict__ src,
                                          long long ls, jt::Fe* x) {
  int4 q[16];
#pragma unroll
  for (int l = 0; l < 16; l++)
    q[l] = __ldg(reinterpret_cast<const int4*>(src + l * ls));
#pragma unroll
  for (int w = 0; w < 8; w++) {
    const int4 lo = q[2 * w], hi = q[2 * w + 1];
    x[0].w[w] = ((uint32_t)lo.x & 0xFFFFu) | ((uint32_t)hi.x << 16);
    x[1].w[w] = ((uint32_t)lo.y & 0xFFFFu) | ((uint32_t)hi.y << 16);
    x[2].w[w] = ((uint32_t)lo.z & 0xFFFFu) | ((uint32_t)hi.z << 16);
    x[3].w[w] = ((uint32_t)lo.w & 0xFFFFu) | ((uint32_t)hi.w << 16);
  }
}

// One thread's share of terms [k0, k1) of a row, reduced: terms k0 + sub,
// + tpr, ... (VEC: quads from k0 + 4 sub by 4 tpr, then the row's last
// n % 4 terms one at a time), into two lazy sums.
__device__ __forceinline__ jt::Fe thread_sum(const SumArgs& s,
                                             const int32_t* __restrict__ row,
                                             long long k0, long long k1,
                                             int sub, const jt::Field& F) {
  jt::Fe acc0 = jt::fe_zero(), acc1 = jt::fe_zero();
  if (s.vec) {
    const long long kq = k0 + ((k1 - k0) & ~3LL);
    for (long long k = k0 + 4 * sub; k < kq; k += 4LL * s.tpr) {
      jt::Fe x[4];
      load_quad(row + k, s.ls, x);
      acc0 = jt::ladd(acc0, x[0], F);
      acc1 = jt::ladd(acc1, x[1], F);
      acc0 = jt::ladd(acc0, x[2], F);
      acc1 = jt::ladd(acc1, x[3], F);
    }
    k0 = kq;
  }
  long long k = k0 + sub;
  for (; k + s.tpr < k1; k += 2LL * s.tpr) {
    const jt::Fe x = jt::load_limbs(row + k * s.es, s.ls);
    const jt::Fe y = jt::load_limbs(row + (k + s.tpr) * s.es, s.ls);
    acc0 = jt::ladd(acc0, x, F);
    acc1 = jt::ladd(acc1, y, F);
  }
  if (k < k1) acc0 = jt::ladd(acc0, jt::load_limbs(row + k * s.es, s.ls), F);
  return jt::reduce(jt::ladd(acc0, acc1, F), F);
}

// Each row's sum over its threads, in its head thread (sub == 0): along
// the rows a shuffle tree in each warp, then the row's warps through
// shared memory; across them the first `warps` warps' lanes through
// shared memory (the others held no term).  Every thread of the block
// calls it.
__device__ __forceinline__ jt::Fe rows_sum(jt::Fe v, const SumArgs& s,
                                           long long warps,
                                           uint32_t (*sh)[SUM_THREADS],
                                           const jt::Field& F) {
  const int t = threadIdx.x;
  if (!s.across) {
    v = jt::warp_sum(v, F);
    if (s.tpr == 32) return v;
    if ((t & 31) == 0) {
#pragma unroll
      for (int k = 0; k < 8; k++) sh[k][t >> 5] = v.w[k];
    }
    __syncthreads();
    if (t % s.tpr == 0)
      for (int w = 1; w < s.tpr / 32; w++) {
        jt::Fe o;
#pragma unroll
        for (int k = 0; k < 8; k++) o.w[k] = sh[k][(t >> 5) + w];
        v = jt::fadd(v, o, F);
      }
  } else {
#pragma unroll
    for (int k = 0; k < 8; k++) sh[k][t] = v.w[k];
    __syncthreads();
    if (t < 32)
      for (int w = 1; w < warps; w++) {
        jt::Fe o;
#pragma unroll
        for (int k = 0; k < 8; k++) o.w[k] = sh[k][t + 32 * w];
        v = jt::fadd(v, o, F);
      }
  }
  __syncthreads();                  // sh is free again
  return v;
}

// out[:, r] = sum_k a[r, k] mod p for r < rows, k < n.  One argument
// struct (a kernel's parameters are one constant bank either way).
__global__ void __launch_bounds__(SUM_THREADS, SUM_MIN_BLOCKS)
field_sum_kernel(SumArgs s, jt::Field F) {
  __shared__ uint32_t sh[8][SUM_THREADS];
  __shared__ int last;
  const int t = threadIdx.x;
  const int per = SUM_THREADS / s.tpr;          // rows of a tile
  const int ri = s.across ? (t & 31) : t / s.tpr;
  const int sub = s.across ? (t >> 5) : t % s.tpr;
  for (long long seg = blockIdx.x; seg < s.tiles * s.chunks;
       seg += gridDim.x) {
    const long long tile = seg / s.chunks, c = seg - tile * s.chunks;
    const long long r = tile * per + ri;
    const bool live = r < s.rows, writer = live && sub == 0;
    const long long k0 = c * s.chunk;
    const long long k1 = k0 + s.chunk < s.n ? k0 + s.chunk : s.n;
    jt::Fe v = live ? thread_sum(s, s.a + r * s.rs, k0, k1, sub, F)
                    : jt::fe_zero();
    v = rows_sum(v, s, k1 - k0 < s.tpr ? k1 - k0 : s.tpr, sh, F);
    if (s.chunks == 1) {
      if (writer) jt::store_limbs(s.out + r, s.rows, v);
      continue;
    }
    if (writer) {
      jt::put_words(s.partials + (r * s.chunks + c) * 8, v);
      __threadfence();
    }
    __syncthreads();
    if (t == 0) last = atomicAdd(s.counters + tile, 1u) == s.chunks - 1;
    __syncthreads();
    if (!last) continue;
    // the last segment of this tile: each row's partials, all threads
    __threadfence();
    jt::Fe u0 = jt::fe_zero(), u1 = jt::fe_zero();
    if (live) {
      const uint32_t* p = s.partials + r * s.chunks * 8;
      long long j = sub;
      for (; j + s.tpr < s.chunks; j += 2LL * s.tpr) {
        const jt::Fe x = jt::get_words(p + j * 8);
        const jt::Fe y = jt::get_words(p + (j + s.tpr) * 8);
        u0 = jt::fadd(u0, x, F);
        u1 = jt::fadd(u1, y, F);
      }
      if (j < s.chunks) u0 = jt::fadd(u0, jt::get_words(p + j * 8), F);
    }
    v = rows_sum(jt::fadd(u0, u1, F), s,
                 s.chunks < s.tpr ? s.chunks : s.tpr, sh, F);
    if (writer) jt::store_limbs(s.out + r, s.rows, v);
    if (t == 0) s.counters[tile] = 0;
  }
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
// a + r*rs + k*es + l*ls; out [16, rows].  tpr, across, vec, chunk,
// chunks and blocks come from sum_plan (field/kernels.py); with chunks >
// 1, partials holds rows x chunks x 8 words and counters one word a tile,
// all 0.
extern "C" int jt_field_sum(const int32_t* a, int32_t* out, long long rows,
                            long long n, long long rs, long long ls,
                            long long es, long long tpr, long long across,
                            long long vec, long long chunk, long long chunks,
                            long long blocks, uint32_t* partials,
                            unsigned int* counters, const uint32_t* field,
                            void* stream) {
  const bool tpr_ok = across ? tpr == SUM_THREADS / 32
                             : (tpr == 32 || tpr == 64 || tpr == 128 ||
                                tpr == SUM_THREADS);
  if (rows < 1 || n < 1 || chunk < 1 || chunks < 1 || !tpr_ok ||
      (chunks - 1) * chunk >= n || chunks * chunk < n ||
      (chunks > 1 && (!partials || !counters)))
    return (int)cudaErrorInvalidValue;
  if (vec && (across || es != 1 || chunk % 4 || ls % 4 ||
              (rows > 1 && rs % 4) || ((uintptr_t)a & 15)))
    return (int)cudaErrorMisalignedAddress;
  const long long per = SUM_THREADS / tpr;
  const long long tiles = (rows + per - 1) / per;
  if (blocks < 1 || blocks > tiles * chunks) return (int)cudaErrorInvalidValue;
  const SumArgs s{a, ls, es, rs, rows, n, chunk, chunks, tiles, (int)tpr,
                  (int)across, (int)vec, partials, counters, out};
  field_sum_kernel<<<(unsigned int)blocks, SUM_THREADS, 0,
                     (cudaStream_t)stream>>>(s, jt::make_field(field));
  return (int)cudaGetLastError();
}
