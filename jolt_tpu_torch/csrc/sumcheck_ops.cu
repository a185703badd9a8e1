// K14-K17: the toggled grand product's round and the opening reduction's
// round, with its random linear combination (RLC), each one launch where
// jolt_tpu runs one jax.jit program and the port ran a chain of K1, K10
// and K11 launches.
//
// K14 `toggle_evals_kernel` replaces jolt_tpu/subprotocols/
// grand_product.py:976-1014 `_toggle_cubic_evals`:
//   e_t = sum_i eq_t(i) * sum_b c_b * (f_t(b/2, i) p_t(b, i) + 1 - f_t(b/2, i))
// at t in {0, 2, 3}, x_t = x_lo + t (x_hi - x_lo) on the halves (i, i + h)
// of the bit-reversed flags [16, m, s], fingerprints [16, 2m, s] and eq
// [16, s]; coeffs [16, 2m].  Fingerprint rows 2j and 2j + 1 share flag
// row j, so a thread reads each flag row once for both.  The formula the
// kernel uses: with "1" Montgomery's one, c_b * 1 = c_b, so
//   sum_b c_b gate_b = C + sum_j f_t(j) q_t(j),
//   q_t(j) = c_2j p_t(2j) + c_2j+1 p_t(2j+1) - (c_2j + c_2j+1),
// C = sum_b c_b; and c_b p_t = c_b p_lo + t (c_b p_hi - c_b p_lo) is
// extrapolated from two products.  Per memory and pair index: 4 products
// (c p at lo and hi, for two fingerprints) and 3 (f_t q_t): 7, where the
// formula as written takes 12; then 3 a pair index (eq_t times the sum).
//
// K15 `bind_halves_kernel` replaces `_toggle_bind` (grand_product.py:1017-
// 1026) and the binds of `_reduction_round_fs` (poly/opening_proof.py:71-
// 72, bind_top): out = lo + r (hi - lo) on the contiguous halves of up to
// BIND_MAX tensors [16, rows, n] (each with its own strides), into new
// contiguous [16, rows, n/2]: never in place (the reduction's polynomials
// are read again after its sumcheck).  r: 8 words by value, or 16 limbs on
// the card (a challenge that K9 drew, read with no host sync).
//
// K16 `reduction_evals_kernel` replaces the evaluation half of
// `_reduction_round_fs` (opening_proof.py:56-67) and `_quadratic_evals`
// (:144-154): for A active pairs (P_a, eq_a) of one length n = 2h,
//   (k + sum_a c_a sum_x P_a(0,x) eq_a(0,x),
//    k + sum_a c_a sum_x P_a(2,x) eq_a(2,x))
// -> [16, 2], ready for K9; the pairs' pointers, their coefficients and
// the constant k (the claims not yet active) by value.
//
// K17 `rlc_kernel` replaces `_rlc` and `rlc_polys`' padding (opening_proof.py:
// 30-52): out[x] = prev[x] + sum_i c_i P_i[x] over [16, n], P_i read as
// zero past its own length, each polynomial a view with its own limb
// stride (a column of [16, k, T], read in place); prev (optional, may be
// out itself) carries the sum over a list longer than RLC_MAX, one launch
// per RLC_MAX polynomials.
//
// Bounds on the H100.  K15 and K17 are bytes-bound: K15 reads each input
// once and writes half of it (one product an output element), K17 reads
// each polynomial once and writes the output (one product an input
// element; 1.5 x 10^13 32-bit multiplies a second against 3.35 TB/s:
// 264 multiplies cost 16 ns, 64 bytes 19 ns).  K16 reads two elements of
// each of P and eq for 2 products: bytes.  K14 at the sha2 prove's first
// round (m = 55, s = 2^16) reads 696 MB (0.208 ms) for 7 x 55 + 3
// products a pair index (0.21 ms of INT32): both about equal.
//
// Designs.  Every intermediate lies in [0, 2p) (field.cuh's lazy ops);
// sums mod p are unique, so any order gives the plain versions' bits.
//   - K14 after K2 (gp_pair.cu): a warp takes a tile of 32 consecutive
//     pair indices (one coalesced row a limb) and a group of the memories
//     (j = g, g + groups, ...), `toggle_plan` (field/kernels.py) picks the
//     groups so that about one wave of warps exists, and the warps walk
//     (tile, group) tasks by grid stride.  Each group multiplies its own
//     partial by eq_t (group 0 adds C): eq_t (C + sum_j ...) is linear, so
//     no group waits for another.  A thread's three sums over its tasks
//     stay in shared memory (registers hold the memory loop's).  Then
//     the block sum, a partial a block, and the last block (a ticket kept
//     per stream, reset by that block) sums the partials: one launch.
//   - K15: a grid-stride loop over each tensor's output elements in turn.
//   - K16: one resident wave of blocks; a thread sums its pair indices of
//     pair a, times c_a, into two sums over the pairs; block sum, partials,
//     last block adds k.
//   - K17: a thread an element, the polynomials in a loop.
#include "field.cuh"

namespace {

constexpr int TOGGLE_THREADS = 256;
constexpr int TOGGLE_WARPS = TOGGLE_THREADS / 32;
constexpr int TOGGLE_MIN_BLOCKS = 2;  // per SM; toggle_plan's wave
constexpr int TOGGLE_MAX_M = 128;     // memories a launch (cs, cc: 12 KB of
                                      // shared memory); the wrapper splits
constexpr int OPS_THREADS = 256;      // K15, K16 and K17
constexpr int REDUCE_MIN_BLOCKS = 2;
constexpr int BIND_MAX = 32;          // tensors a K15 launch
constexpr int REDUCE_MAX_PAIRS = 16;  // pairs a K16 launch
constexpr int RLC_MAX = 48;           // polynomials a K17 launch

// Block-wide mod-p sum of N reduced values a thread; the result in
// thread 0.  Warp shuffles, then a word row a warp in shared memory.
template <int N>
__device__ void block_sum(jt::Fe* e, const jt::Field& F) {
  __shared__ uint32_t red[OPS_THREADS / 32][N][8];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
#pragma unroll
  for (int t = 0; t < N; t++) e[t] = jt::warp_sum(e[t], F);
  if (lane == 0)
#pragma unroll
    for (int t = 0; t < N; t++)
#pragma unroll
      for (int k = 0; k < 8; k++) red[warp][t][k] = e[t].w[k];
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int t = 0; t < N; t++) {
#pragma unroll
      for (int k = 0; k < 8; k++)
        e[t].w[k] = lane < warps ? red[lane][t][k] : 0u;
      e[t] = jt::warp_sum(e[t], F);
    }
  }
}

// The block's N sums (in thread 0) go to partials[blockIdx.x]; the last
// block to finish sums every block's partials, adds k to each and writes
// out [16, N].  Returns in every thread.
template <int N>
__device__ void finish(jt::Fe* e, uint32_t* __restrict__ partials,
                       unsigned int* __restrict__ counter,
                       int32_t* __restrict__ out, const jt::Fe k,
                       const jt::Field& F) {
  __shared__ bool last;
  block_sum<N>(e, F);
  if (threadIdx.x == 0) {
    uint32_t* dst = partials + (long long)blockIdx.x * (8 * N);
#pragma unroll
    for (int t = 0; t < N; t++) jt::put_words(dst + 8 * t, e[t]);
    __threadfence();
    last = atomicAdd(counter, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
#pragma unroll
  for (int t = 0; t < N; t++) e[t] = jt::fe_zero();
  for (unsigned int j = threadIdx.x; j < gridDim.x; j += blockDim.x)
#pragma unroll
    for (int t = 0; t < N; t++)
      e[t] = jt::fadd(e[t], jt::get_words(partials + j * (8 * N) + 8 * t), F);
  block_sum<N>(e, F);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int t = 0; t < N; t++)
      jt::store_limbs(out + t, N, jt::fadd(e[t], k, F));
    *counter = 0;
  }
}

// ---------------------------------------------------------------------------
// K14
// ---------------------------------------------------------------------------

struct ToggleArgs {
  const int32_t* flags;   // [16, m, s]: limb l of (j, i) at l*f_ls + j*f_rs + i
  const int32_t* fps;     // [16, 2m, s]
  const int32_t* eq;      // [16, s]
  const int32_t* coeffs;  // [16, 2m]: limb l of c_b at l*c_ls + b*c_es
  long long f_ls, f_rs, p_ls, p_rs, e_ls, c_ls, c_es;
  long long h, tiles;
  int m, groups;
  uint32_t* partials;     // 24 words a block
  unsigned int* counter;  // 0 between launches
  int32_t* out;           // [16, 3]
};

__global__ void __launch_bounds__(TOGGLE_THREADS, TOGGLE_MIN_BLOCKS)
toggle_evals_kernel(ToggleArgs a, jt::Field F) {
  __shared__ jt::Fe cs[2 * TOGGLE_MAX_M];  // c_b
  __shared__ jt::Fe cc[TOGGLE_MAX_M];      // c_2j + c_2j+1
  __shared__ jt::Fe csum;                  // sum_b c_b
  __shared__ uint32_t acc[3][8][TOGGLE_THREADS];  // the thread's e_t
  const int t = threadIdx.x, lane = t & 31;
  for (int b = t; b < 2 * a.m; b += blockDim.x)
    cs[b] = jt::load_limbs(a.coeffs + b * a.c_es, a.c_ls);
#pragma unroll
  for (int k = 0; k < 8; k++) acc[0][k][t] = acc[1][k][t] = acc[2][k][t] = 0u;
  __syncthreads();
  for (int j = t; j < a.m; j += blockDim.x)
    cc[j] = jt::fadd(cs[2 * j], cs[2 * j + 1], F);
  __syncthreads();
  if (t < 32) {
    jt::Fe v = jt::fe_zero();
    for (int j = lane; j < a.m; j += 32) v = jt::fadd(v, cc[j], F);
    v = jt::warp_sum(v, F);
    if (lane == 0) csum = v;
  }
  __syncthreads();

  const long long h = a.h;
  const long long nwarps = (long long)gridDim.x * TOGGLE_WARPS;
  for (long long task = (long long)blockIdx.x * TOGGLE_WARPS + (t >> 5);
       task < a.tiles * a.groups; task += nwarps) {
    const long long tile = task / a.groups;
    const int g = (int)(task - tile * a.groups);
    const long long i = tile * 32 + lane;
    if (i >= h) continue;
    jt::Fe A0 = jt::fe_zero(), A2 = jt::fe_zero(), A3 = jt::fe_zero();
    for (int j = g; j < a.m; j += a.groups) {
      jt::Fe q0 = jt::fe_zero(), q2 = jt::fe_zero(), q3 = jt::fe_zero();
#pragma unroll
      for (int k = 0; k < 2; k++) {
        const int32_t* p = a.fps + (2LL * j + k) * a.p_rs + i;
        const jt::Fe c = cs[2 * j + k];
        const jt::Fe cp0 = jt::lmul(c, jt::load_limbs(p, a.p_ls), F);
        const jt::Fe cp1 = jt::lmul(c, jt::load_limbs(p + h, a.p_ls), F);
        const jt::Fe d = jt::lsub(cp1, cp0, F);
        const jt::Fe cp2 = jt::ladd(cp1, d, F);
        q0 = jt::ladd(q0, cp0, F);
        q2 = jt::ladd(q2, cp2, F);
        q3 = jt::ladd(q3, jt::ladd(cp2, d, F), F);
      }
      const jt::Fe cj = cc[j];
      const int32_t* f = a.flags + (long long)j * a.f_rs + i;
      const jt::Fe f0 = jt::load_limbs(f, a.f_ls);
      const jt::Fe df = jt::lsub(jt::load_limbs(f + h, a.f_ls), f0, F);
      const jt::Fe f2 = jt::ladd(jt::ladd(f0, df, F), df, F);
      A0 = jt::ladd(A0, jt::lmul(f0, jt::lsub(q0, cj, F), F), F);
      A2 = jt::ladd(A2, jt::lmul(f2, jt::lsub(q2, cj, F), F), F);
      A3 = jt::ladd(A3, jt::lmul(jt::ladd(f2, df, F), jt::lsub(q3, cj, F),
                                 F), F);
    }
    if (g == 0) {
      const jt::Fe c = csum;
      A0 = jt::ladd(A0, c, F);
      A2 = jt::ladd(A2, c, F);
      A3 = jt::ladd(A3, c, F);
    }
    const jt::Fe w0 = jt::load_limbs(a.eq + i, a.e_ls);
    const jt::Fe dw = jt::lsub(jt::load_limbs(a.eq + i + h, a.e_ls), w0, F);
    const jt::Fe w2 = jt::ladd(jt::ladd(w0, dw, F), dw, F);
    const jt::Fe x[3] = {jt::lmul(w0, A0, F), jt::lmul(w2, A2, F),
                         jt::lmul(jt::ladd(w2, dw, F), A3, F)};
#pragma unroll
    for (int u = 0; u < 3; u++) {
      jt::Fe s;
#pragma unroll
      for (int k = 0; k < 8; k++) s.w[k] = acc[u][k][t];
      s = jt::ladd(s, x[u], F);
#pragma unroll
      for (int k = 0; k < 8; k++) acc[u][k][t] = s.w[k];
    }
  }

  jt::Fe e[3];
#pragma unroll
  for (int u = 0; u < 3; u++) {
#pragma unroll
    for (int k = 0; k < 8; k++) e[u].w[k] = acc[u][k][t];
    e[u] = jt::reduce(e[u], F);
  }
  finish<3>(e, a.partials, a.counter, a.out, jt::fe_zero(), F);
}

// ---------------------------------------------------------------------------
// K15
// ---------------------------------------------------------------------------

struct BindTensor {
  const int32_t* src;  // limb l of (row, i) at l*ls + row*rs + i*es
  int32_t* dst;        // [16, rows, half], contiguous
  long long ls, rs, es, rows, half;
};

struct BindArgs {
  BindTensor t[BIND_MAX];
  int count;
  jt::Fe rc;              // the challenge's Montgomery form ...
  const int32_t* rc_dev;  // ... or, where not null, its limbs on the card
};

__global__ void __launch_bounds__(OPS_THREADS)
bind_halves_kernel(BindArgs a, jt::Field F) {
  const jt::Fe rc = a.rc_dev ? jt::load_limbs(a.rc_dev, 1) : a.rc;
  const long long step = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (int k = 0; k < a.count; k++) {
    const BindTensor b = a.t[k];
    const long long total = b.rows * b.half;
    for (long long e = first; e < total; e += step) {
      const long long row = e / b.half, i = e - row * b.half;
      const int32_t* src = b.src + row * b.rs + i * b.es;
      const jt::Fe lo = jt::load_limbs(src, b.ls);
      const jt::Fe hi = jt::load_limbs(src + b.half * b.es, b.ls);
      jt::store_limbs(b.dst + e, total,
                      jt::fadd(lo, jt::fmul(rc, jt::fsub(hi, lo, F), F), F));
    }
  }
}

// ---------------------------------------------------------------------------
// K16
// ---------------------------------------------------------------------------

struct Pair {
  const int32_t* p;  // [16, 2h]: limb l of x at l*p_ls + x
  const int32_t* e;
  long long p_ls, e_ls;
  jt::Fe c;          // the pair's coefficient (Montgomery)
};

struct ReduceArgs {
  Pair pr[REDUCE_MAX_PAIRS];
  int count;
  long long h;
  jt::Fe k;               // the claims not yet active
  uint32_t* partials;     // 16 words a block
  unsigned int* counter;  // 0 between launches
  int32_t* out;           // [16, 2]
};

__global__ void __launch_bounds__(OPS_THREADS, REDUCE_MIN_BLOCKS)
reduction_evals_kernel(ReduceArgs a, jt::Field F) {
  const long long h = a.h;
  const long long step = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  jt::Fe e[2] = {jt::fe_zero(), jt::fe_zero()};
  if (first < h)
    for (int q = 0; q < a.count; q++) {
      const Pair pr = a.pr[q];
      jt::Fe s0 = jt::fe_zero(), s2 = jt::fe_zero();
      for (long long x = first; x < h; x += step) {
        const jt::Fe p0 = jt::load_limbs(pr.p + x, pr.p_ls);
        const jt::Fe e0 = jt::load_limbs(pr.e + x, pr.e_ls);
        s0 = jt::ladd(s0, jt::lmul(p0, e0, F), F);
        const jt::Fe p1 = jt::load_limbs(pr.p + x + h, pr.p_ls);
        const jt::Fe e1 = jt::load_limbs(pr.e + x + h, pr.e_ls);
        const jt::Fe p2 = jt::ladd(p1, jt::lsub(p1, p0, F), F);
        const jt::Fe e2 = jt::ladd(e1, jt::lsub(e1, e0, F), F);
        s2 = jt::ladd(s2, jt::lmul(p2, e2, F), F);
      }
      e[0] = jt::ladd(e[0], jt::lmul(pr.c, s0, F), F);
      e[1] = jt::ladd(e[1], jt::lmul(pr.c, s2, F), F);
    }
  e[0] = jt::reduce(e[0], F);
  e[1] = jt::reduce(e[1], F);
  finish<2>(e, a.partials, a.counter, a.out, a.k, F);
}

// ---------------------------------------------------------------------------
// K17
// ---------------------------------------------------------------------------

struct RlcPoly {
  const int32_t* p;  // limb l of x at l*ls + x, x < n
  long long ls, n;
  jt::Fe c;          // its coefficient (Montgomery)
};

struct RlcArgs {
  RlcPoly t[RLC_MAX];
  int count;
  long long n;            // the output's length
  const int32_t* prev;    // [16, n] added in (null: none); may be out
  int32_t* out;           // [16, n]
};

__global__ void __launch_bounds__(OPS_THREADS)
rlc_kernel(RlcArgs a, jt::Field F) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long x = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       x < a.n; x += step) {
    jt::Fe acc = jt::fe_zero();
    if (a.prev) {   // a plain load: out, which this thread writes, may be prev
#pragma unroll
      for (int k = 0; k < 8; k++)
        acc.w[k] = ((uint32_t)a.prev[(2 * k) * a.n + x] & 0xFFFFu) |
                   ((uint32_t)a.prev[(2 * k + 1) * a.n + x] << 16);
    }
    for (int i = 0; i < a.count; i++) {
      const RlcPoly q = a.t[i];
      if (x < q.n)
        acc = jt::ladd(acc, jt::lmul(q.c, jt::load_limbs(q.p + x, q.ls), F),
                       F);
    }
    jt::store_limbs(a.out + x, a.n, jt::reduce(acc, F));
  }
}

jt::Fe fe_words(const uint32_t* w) {
  jt::Fe v;
  for (int k = 0; k < 8; k++) v.w[k] = w[k];
  return v;
}

}  // namespace

// K14, one launch over at most TOGGLE_MAX_M memories.  groups and blocks
// come from toggle_plan (field/kernels.py); partials holds blocks x 24
// words; counter is 0 on entry and left at 0.  Strides: see ToggleArgs.
extern "C" int jt_toggle_evals(const int32_t* flags, const int32_t* fps,
                               const int32_t* eq, const int32_t* coeffs,
                               const long long* strides, long long m,
                               long long h, long long groups,
                               long long blocks, uint32_t* partials,
                               unsigned int* counter, int32_t* out,
                               const uint32_t* field, void* stream) {
  if (m < 1 || m > TOGGLE_MAX_M || h < 1 || groups < 1 || groups > m ||
      blocks < 1 || blocks > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  ToggleArgs a;
  a.flags = flags;
  a.fps = fps;
  a.eq = eq;
  a.coeffs = coeffs;
  a.f_ls = strides[0];
  a.f_rs = strides[1];
  a.p_ls = strides[2];
  a.p_rs = strides[3];
  a.e_ls = strides[4];
  a.c_ls = strides[5];
  a.c_es = strides[6];
  a.h = h;
  a.tiles = (h + 31) / 32;
  a.m = (int)m;
  a.groups = (int)groups;
  a.partials = partials;
  a.counter = counter;
  a.out = out;
  toggle_evals_kernel<<<(unsigned int)blocks, TOGGLE_THREADS, 0,
                        (cudaStream_t)stream>>>(a, jt::make_field(field));
  return (int)cudaGetLastError();
}

// K15, one launch over `count` <= BIND_MAX tensors: tensor k from
// srcs[k] with strides ls[k], rs[k], es[k] (limb, row, element), rows[k]
// rows of 2 * halves[k] elements, into dsts[k].  The challenge: rc_words
// (8 words) by value, or rc_dev's 16 limbs where rc_dev is not null.
extern "C" int jt_bind_halves(const long long* srcs, const long long* dsts,
                              const long long* ls, const long long* rs,
                              const long long* es, const long long* rows,
                              const long long* halves, long long count,
                              const uint32_t* rc_words, const int32_t* rc_dev,
                              const uint32_t* field, void* stream) {
  if (count < 1 || count > BIND_MAX) return (int)cudaErrorInvalidValue;
  BindArgs a;
  long long most = 0;
  for (int k = 0; k < count; k++) {
    if (rows[k] < 1 || halves[k] < 1) return (int)cudaErrorInvalidValue;
    a.t[k] = BindTensor{reinterpret_cast<const int32_t*>(srcs[k]),
                        reinterpret_cast<int32_t*>(dsts[k]), ls[k], rs[k],
                        es[k], rows[k], halves[k]};
    if (rows[k] * halves[k] > most) most = rows[k] * halves[k];
  }
  a.count = (int)count;
  a.rc = fe_words(rc_words);
  a.rc_dev = rc_dev;
  bind_halves_kernel<<<jt_blocks(most, OPS_THREADS), OPS_THREADS, 0,
                       (cudaStream_t)stream>>>(a, jt::make_field(field));
  return (int)cudaGetLastError();
}

// K16, one launch over `count` <= REDUCE_MAX_PAIRS pairs of length 2h:
// pair q at ps[q] (limb stride p_ls[q]) and es[q] (e_ls[q]), coefficient
// coeff_words[8q..8q+7]; k_words the constant.  blocks from
// reduction_plan (field/kernels.py); partials blocks x 16 words; counter
// 0 on entry, left at 0.
extern "C" int jt_reduction_evals(const long long* ps, const long long* es,
                                  const long long* p_ls,
                                  const long long* e_ls,
                                  const uint32_t* coeff_words,
                                  long long count, long long h,
                                  const uint32_t* k_words, long long blocks,
                                  uint32_t* partials, unsigned int* counter,
                                  int32_t* out, const uint32_t* field,
                                  void* stream) {
  if (count < 1 || count > REDUCE_MAX_PAIRS || h < 1 || blocks < 1 ||
      blocks > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  ReduceArgs a;
  for (int q = 0; q < count; q++)
    a.pr[q] = Pair{reinterpret_cast<const int32_t*>(ps[q]),
                   reinterpret_cast<const int32_t*>(es[q]), p_ls[q], e_ls[q],
                   fe_words(coeff_words + 8 * q)};
  a.count = (int)count;
  a.h = h;
  a.k = fe_words(k_words);
  a.partials = partials;
  a.counter = counter;
  a.out = out;
  reduction_evals_kernel<<<(unsigned int)blocks, OPS_THREADS, 0,
                           (cudaStream_t)stream>>>(a, jt::make_field(field));
  return (int)cudaGetLastError();
}

// K17, one launch over `count` <= RLC_MAX polynomials: polynomial i at
// ps[i], limb stride ls[i], length ns[i] <= n, coefficient
// coeff_words[8i..8i+7]; out [16, n] = prev (when not null) + the sum.
extern "C" int jt_rlc(const long long* ps, const long long* ls,
                      const long long* ns, const uint32_t* coeff_words,
                      long long count, long long n, const int32_t* prev,
                      int32_t* out, const uint32_t* field, void* stream) {
  if (count < 1 || count > RLC_MAX || n < 1) return (int)cudaErrorInvalidValue;
  RlcArgs a;
  for (int i = 0; i < count; i++) {
    if (ns[i] < 1 || ns[i] > n) return (int)cudaErrorInvalidValue;
    a.t[i] = RlcPoly{reinterpret_cast<const int32_t*>(ps[i]), ls[i], ns[i],
                     fe_words(coeff_words + 8 * i)};
  }
  a.count = (int)count;
  a.n = n;
  a.prev = prev;
  a.out = out;
  rlc_kernel<<<jt_blocks(n, OPS_THREADS), OPS_THREADS, 0,
               (cudaStream_t)stream>>>(a, jt::make_field(field));
  return (int)cudaGetLastError();
}
