// K2 + K3: one round of the batched GKR grand-product sumcheck over
// bit-reversed pair layers (l, r: [B, 16, s]; eq: [16, s]; h = s/2).
//
// K2 replaces jolt_tpu/field/pallas_mont.py::gp_pair_evals_pallas:
//   e_t = sum_{i<h} eq_t(i) * sum_b c_b*l_t(b,i) * r_t(b,i),  t in {0, 2, 3},
// with x_t = x_lo + t*(x_hi - x_lo) on the halves (i, i + h), and the batching
// coefficient folded into the left factor (grand_product.py:203-227).
// K3 replaces ::gp_pair_bind_pallas: new = lo + r*(hi - lo) on the halves
// of l, r and eq; its outputs are the next round's layers, no re-layout.
//
// Bound on the H100: K2 by the integer multiply pipe, K3 by bytes.  K2
// reads l, r and eq once (0.57 GB at B = 8, s = 2^19: 0.17 ms at 3.35
// TB/s) but does 5B + 3 Montgomery products per pair (43 at B = 8, 218 at
// the fib GP's B = 43), 264 32-bit multiplies each; K3 reads the same and
// writes half of it back (0.26 ms) with 2B + 1 products per pair.
//
// K2's design splits the work over (circuit group, pair index):
//   - a warp covers a tile of 32 consecutive pair indices i (one coalesced
//     row per limb) and one group g of the circuits (b = g, g + groups,
//     ...); the launch plan (field/kernels.py `gp_evals_plan`) picks
//     `groups` from (B, h): a large round runs as one even wave of the
//     card, and in a small round each thread holds one circuit, so its
//     serial chain is 5 + 3 products, not 5B + 3;
//   - with groups <= 8 a block's 8 warps hold 8/groups tiles x groups; with
//     more, a block holds one tile x 8 groups and groups/8 blocks share a
//     tile (each multiplies its own partial by eq: eq_t(i) * sum_b x_b =
//     sum over blocks of eq_t(i) * partial, 3 more products per block);
//   - each thread forms its group's s_0, s_2, s_3 at its i; the warps of a
//     tile sum them mod p through shared memory, and then warps multiply
//     by eq_0, eq_2, eq_3 at i (one product each) and accumulate;
//   - every intermediate lies in [0, 2p) (field.cuh's lazy ops); each
//     thread reduces its sums to [0, p), warp shuffles and a small shared
//     array sum them mod p across the block, and the block's partial goes
//     to device memory;
//   - the last block to finish (an atomic ticket on a counter that the
//     wrapper allocates once per stream and the last block resets to 0)
//     sums the partials and writes the [16, 3] output: one launch.
// Sums mod p are the same in any order, so e_t equals the plain version's.
// K3 is one thread per output element.  Both mask the ragged edge (i < h),
// so every size down to s = 2 runs here.
#include "field.cuh"

namespace {

constexpr int GP_THREADS = 256;
constexpr int GP_WARPS = GP_THREADS / 32;
constexpr int GP_MIN_BLOCKS = 2;  // per SM; field/kernels.py plans one wave
                                  // as SMs x GP_MIN_BLOCKS blocks
constexpr int GP_MAX_B = 64;

// 8 words of lane + offset added mod p into v
__device__ __forceinline__ void shfl_add(jt::Fe& v, int offset,
                                         const jt::Field& F) {
  jt::Fe o;
#pragma unroll
  for (int k = 0; k < 8; k++)
    o.w[k] = __shfl_down_sync(0xffffffffu, v.w[k], offset);
  v = jt::fadd(v, o, F);
}

// Block-wide mod-p sum of three reduced values per thread; the result in
// thread 0.  Warp shuffles, then one word row per warp in shared memory.
__device__ void block_sum3(jt::Fe e[3], const jt::Field& F) {
  __shared__ uint32_t red[GP_WARPS][3][8];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int t = 0; t < 3; t++)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) shfl_add(e[t], off, F);
  if (lane == 0)
#pragma unroll
    for (int t = 0; t < 3; t++)
#pragma unroll
      for (int k = 0; k < 8; k++) red[warp][t][k] = e[t].w[k];
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int t = 0; t < 3; t++) {
#pragma unroll
      for (int k = 0; k < 8; k++)
        e[t].w[k] = lane < GP_WARPS ? red[lane][t][k] : 0u;
#pragma unroll
      for (int off = GP_WARPS / 2; off > 0; off >>= 1) shfl_add(e[t], off, F);
    }
  }
}

__device__ __forceinline__ void put(uint32_t (*row)[32], int lane,
                                    const jt::Fe& v) {
#pragma unroll
  for (int k = 0; k < 8; k++) row[k][lane] = v.w[k];
}

__device__ __forceinline__ jt::Fe get(uint32_t (*row)[32], int lane) {
  jt::Fe v;
#pragma unroll
  for (int k = 0; k < 8; k++) v.w[k] = row[k][lane];
  return v;
}

__global__ void __launch_bounds__(GP_THREADS, GP_MIN_BLOCKS)
gp_pair_evals_kernel(const int32_t* __restrict__ l,
                     const int32_t* __restrict__ r,
                     const int32_t* __restrict__ eq,
                     const int32_t* __restrict__ coeffs,
                     uint32_t* __restrict__ partials,
                     unsigned int* __restrict__ counter,
                     int32_t* __restrict__ out, int B, long long h,
                     int groups, long long l_bs, long long l_ls,
                     long long r_bs, long long r_ls, long long eq_ls,
                     long long c_ls, long long c_es, jt::Field F) {
  __shared__ jt::Fe cs[GP_MAX_B];
  __shared__ uint32_t part[GP_WARPS][3][8][32];  // [warp][t][word][lane]
  __shared__ bool last;
  for (int b = threadIdx.x; b < B; b += blockDim.x)
    cs[b] = jt::load_limbs(coeffs + b * c_es, c_ls);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gpb = groups < GP_WARPS ? groups : GP_WARPS;  // groups per block
  const int tpb = GP_WARPS / gpb;                         // tiles per block
  const int gblocks = groups / gpb;     // blocks that share one tile
  const int g = (blockIdx.x % gblocks) * gpb + warp % gpb;
  const int tw = warp / gpb;            // this warp's tile in the block
  const long long tblocks = gridDim.x / gblocks;
  const long long tiles = (h + 31) / 32;

  jt::Fe e0 = jt::fe_zero(), e2 = jt::fe_zero(), e3 = jt::fe_zero();
  for (long long tc = blockIdx.x / gblocks; tc * tpb < tiles;
       tc += tblocks) {
    const long long i = (tc * tpb + tw) * 32 + lane;
    jt::Fe s0 = jt::fe_zero(), s2 = jt::fe_zero(), s3 = jt::fe_zero();
    if (i < h) {
      for (int b = g; b < B; b += groups) {
        const int32_t* lb = l + b * l_bs + i;
        const int32_t* rb = r + b * r_bs + i;
        const jt::Fe r0 = jt::load_limbs(rb, r_ls);
        const jt::Fe cl0 = jt::lmul(cs[b], jt::load_limbs(lb, l_ls), F);
        s0 = jt::ladd(s0, jt::lmul(cl0, r0, F), F);
        const jt::Fe r1 = jt::load_limbs(rb + h, r_ls);
        const jt::Fe cl1 = jt::lmul(cs[b], jt::load_limbs(lb + h, l_ls), F);
        const jt::Fe m_l = jt::lsub(cl1, cl0, F);
        const jt::Fe m_r = jt::lsub(r1, r0, F);
        const jt::Fe le2 = jt::ladd(cl1, m_l, F);
        const jt::Fe re2 = jt::ladd(r1, m_r, F);
        s2 = jt::ladd(s2, jt::lmul(le2, re2, F), F);
        s3 = jt::ladd(s3, jt::lmul(jt::ladd(le2, m_l, F),
                                   jt::ladd(re2, m_r, F), F), F);
      }
    }
    put(part[warp][0], lane, s0);
    put(part[warp][1], lane, s2);
    put(part[warp][2], lane, s3);
    __syncthreads();
    // (tile in block, t) pairs over the warps: sum the groups, times eq_t
    for (int idx = warp; idx < tpb * 3; idx += GP_WARPS) {
      const int j = idx / 3, t = idx - 3 * j;
      const long long ii = (tc * tpb + j) * 32 + lane;
      if (ii < h) {
        jt::Fe s = get(part[j * gpb][t], lane);
        for (int q = 1; q < gpb; q++)
          s = jt::ladd(s, get(part[j * gpb + q][t], lane), F);
        jt::Fe w = jt::load_limbs(eq + ii, eq_ls);  // eq_0
        if (t > 0) {
          const jt::Fe eq1 = jt::load_limbs(eq + ii + h, eq_ls);
          const jt::Fe m_eq = jt::lsub(eq1, w, F);
          w = jt::ladd(eq1, m_eq, F);                // eq_2
          if (t == 2) w = jt::ladd(w, m_eq, F);      // eq_3
        }
        const jt::Fe x = jt::lmul(w, s, F);
        if (t == 0)
          e0 = jt::ladd(e0, x, F);
        else if (t == 1)
          e2 = jt::ladd(e2, x, F);
        else
          e3 = jt::ladd(e3, x, F);
      }
    }
    __syncthreads();
  }

  jt::Fe e[3] = {jt::reduce(e0, F), jt::reduce(e2, F), jt::reduce(e3, F)};
  block_sum3(e, F);
  if (threadIdx.x == 0) {
    uint32_t* dst = partials + (long long)blockIdx.x * 24;
#pragma unroll
    for (int t = 0; t < 3; t++)
#pragma unroll
      for (int k = 0; k < 8; k++) dst[t * 8 + k] = e[t].w[k];
    __threadfence();
    last = atomicAdd(counter, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;

  // the last block: partials [gridDim.x, 3, 8 words] -> out [16, 3]
  __threadfence();
#pragma unroll
  for (int t = 0; t < 3; t++) e[t] = jt::fe_zero();
  for (unsigned int j = threadIdx.x; j < gridDim.x; j += blockDim.x) {
#pragma unroll
    for (int t = 0; t < 3; t++) {
      jt::Fe x;
#pragma unroll
      for (int k = 0; k < 8; k++) x.w[k] = __ldcg(partials + j * 24 + t * 8 + k);
      e[t] = jt::fadd(e[t], x, F);
    }
  }
  block_sum3(e, F);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int t = 0; t < 3; t++) jt::store_limbs(out + t, 3, e[t]);
    *counter = 0;
  }
}

__global__ void __launch_bounds__(256)
gp_pair_bind_kernel(const int32_t* __restrict__ l,
                    const int32_t* __restrict__ r,
                    const int32_t* __restrict__ eq, int32_t* __restrict__ nl,
                    int32_t* __restrict__ nr, int32_t* __restrict__ neq, int B,
                    long long h, long long l_bs, long long l_ls,
                    long long r_bs, long long r_ls, long long eq_ls,
                    jt::Fe rc, jt::Field F) {
  const long long total = (2LL * B + 1) * h;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += step) {
    const long long row = e / h;
    const long long i = e - row * h;
    const int32_t* src;
    long long ls;
    int32_t* dst;
    if (row < B) {
      src = l + row * l_bs;
      ls = l_ls;
      dst = nl + row * 16 * h;
    } else if (row < 2 * B) {
      src = r + (row - B) * r_bs;
      ls = r_ls;
      dst = nr + (row - B) * 16 * h;
    } else {
      src = eq;
      ls = eq_ls;
      dst = neq;
    }
    jt::Fe lo = jt::load_limbs(src + i, ls);
    jt::Fe hi = jt::load_limbs(src + i + h, ls);
    jt::Fe v = jt::fadd(lo, jt::fmul(rc, jt::fsub(hi, lo, F), F), F);
    jt::store_limbs(dst + i, h, v);
  }
}

}  // namespace

// K2, one launch.  coeffs limb k of circuit b at coeffs[k*c_ls + b*c_es].
// groups and nblocks come from gp_evals_plan (field/kernels.py); partials
// holds nblocks x 24 words; counter is 0 on entry and left at 0.
extern "C" int jt_gp_pair_evals(const int32_t* l, const int32_t* r,
                                const int32_t* eq, const int32_t* coeffs,
                                uint32_t* partials, unsigned int* counter,
                                int32_t* out, long long B, long long h,
                                long long groups, long long l_bs,
                                long long l_ls, long long r_bs,
                                long long r_ls, long long eq_ls,
                                long long c_ls, long long c_es,
                                long long nblocks, const uint32_t* field,
                                void* stream) {
  const bool pow2 = groups == 1 || groups == 2 || groups == 4 || groups == 8;
  const bool by8 = groups > GP_WARPS && groups % GP_WARPS == 0;
  if (B < 1 || B > GP_MAX_B || h < 1 || nblocks < 1 || !(pow2 || by8) ||
      groups > GP_MAX_B || (by8 && nblocks % (groups / GP_WARPS)))
    return (int)cudaErrorInvalidValue;
  const jt::Field F = jt::make_field(field);
  gp_pair_evals_kernel<<<(unsigned int)nblocks, GP_THREADS, 0,
                         (cudaStream_t)stream>>>(
      l, r, eq, coeffs, partials, counter, out, (int)B, h, (int)groups, l_bs,
      l_ls, r_bs, r_ls, eq_ls, c_ls, c_es, F);
  return (int)cudaGetLastError();
}

// K3.  rc: the challenge's Montgomery form as 8 words, by value.
extern "C" int jt_gp_pair_bind(const int32_t* l, const int32_t* r,
                               const int32_t* eq, int32_t* nl, int32_t* nr,
                               int32_t* neq, long long B, long long h,
                               long long l_bs, long long l_ls, long long r_bs,
                               long long r_ls, long long eq_ls,
                               const uint32_t* rc_words, const uint32_t* field,
                               void* stream) {
  if (B < 1 || h < 1) return (int)cudaErrorInvalidValue;
  const jt::Field F = jt::make_field(field);
  jt::Fe rc;
  for (int k = 0; k < 8; k++) rc.w[k] = rc_words[k];
  const long long total = (2 * B + 1) * h;
  const int threads = 256;
  gp_pair_bind_kernel<<<jt_blocks(total, threads), threads, 0,
                        (cudaStream_t)stream>>>(l, r, eq, nl, nr, neq, (int)B,
                                                h, l_bs, l_ls, r_bs, r_ls,
                                                eq_ls, rc, F);
  return (int)cudaGetLastError();
}
