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
// Bound on the H100: bytes.  K2 reads l, r and eq once: at B = 8,
// s = 2^19 that is 0.57 GB, 0.17 ms at 3.35 TB/s; K3 reads the same and
// writes half of it back, 0.86 GB, 0.26 ms.  K2 also does 5B+3 Montgomery
// products per pair (43 at B = 8), so it carries more arithmetic per byte
// than any other kernel here.  The design: one thread per pair index i,
// the B circuits looped inside the thread with the coefficients staged in
// shared memory, and no intermediate (cl, le_t, re_t, s_t) ever leaving
// registers.  The TPU kernel carried its sum across sequential grid steps;
// CUDA blocks run in no order, so each block reduces its threads' sums mod
// p in shared memory into a partial [nblocks, 3, 8 words], and a second,
// one-block launch reduces the partials to the [16, 3] output.  Sums mod p
// are the same in any order.  Both kernels mask the ragged edge (i < h),
// so every size down to s = 2 runs here.
#include "field.cuh"

namespace {

constexpr int GP_THREADS = 256;
constexpr int GP_MAX_B = 64;

// block-wide mod-p sum of three values per thread; result in thread 0
__device__ void block_reduce3(jt::Fe v[3], const jt::Field& F) {
  __shared__ uint32_t red[3][8][GP_THREADS];
  const int tid = threadIdx.x;
#pragma unroll
  for (int t = 0; t < 3; t++)
#pragma unroll
    for (int k = 0; k < 8; k++) red[t][k][tid] = v[t].w[k];
  for (int stride = GP_THREADS / 2; stride > 0; stride >>= 1) {
    __syncthreads();
    if (tid < stride) {
#pragma unroll
      for (int t = 0; t < 3; t++) {
        jt::Fe x, y;
#pragma unroll
        for (int k = 0; k < 8; k++) {
          x.w[k] = red[t][k][tid];
          y.w[k] = red[t][k][tid + stride];
        }
        jt::Fe z = jt::fadd(x, y, F);
#pragma unroll
        for (int k = 0; k < 8; k++) red[t][k][tid] = z.w[k];
      }
    }
  }
  __syncthreads();
  if (tid == 0) {
#pragma unroll
    for (int t = 0; t < 3; t++)
#pragma unroll
      for (int k = 0; k < 8; k++) v[t].w[k] = red[t][k][0];
  }
}

__global__ void __launch_bounds__(GP_THREADS)
gp_pair_evals_partial(const int32_t* __restrict__ l,
                      const int32_t* __restrict__ r,
                      const int32_t* __restrict__ eq,
                      const int32_t* __restrict__ coeffs,
                      uint32_t* __restrict__ partials, int B, long long h,
                      long long l_bs, long long l_ls, long long r_bs,
                      long long r_ls, long long eq_ls, long long c_ls,
                      long long c_es, jt::Field F) {
  __shared__ jt::Fe cs[GP_MAX_B];
  for (int b = threadIdx.x; b < B; b += blockDim.x)
    cs[b] = jt::load_limbs(coeffs + b * c_es, c_ls);
  __syncthreads();

  jt::Fe e[3] = {jt::fe_zero(), jt::fe_zero(), jt::fe_zero()};
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < h;
       i += step) {
    jt::Fe s0 = jt::fe_zero(), s2 = jt::fe_zero(), s3 = jt::fe_zero();
    for (int b = 0; b < B; b++) {
      const int32_t* lb = l + b * l_bs + i;
      const int32_t* rb = r + b * r_bs + i;
      jt::Fe cl0 = jt::mont_mul(cs[b], jt::load_limbs(lb, l_ls), F);
      jt::Fe r0 = jt::load_limbs(rb, r_ls);
      s0 = jt::fadd(s0, jt::mont_mul(cl0, r0, F), F);
      jt::Fe cl1 = jt::mont_mul(cs[b], jt::load_limbs(lb + h, l_ls), F);
      jt::Fe r1 = jt::load_limbs(rb + h, r_ls);
      jt::Fe m_l = jt::fsub(cl1, cl0, F);
      jt::Fe m_r = jt::fsub(r1, r0, F);
      jt::Fe le2 = jt::fadd(cl1, m_l, F);
      jt::Fe re2 = jt::fadd(r1, m_r, F);
      s2 = jt::fadd(s2, jt::mont_mul(le2, re2, F), F);
      jt::Fe le3 = jt::fadd(le2, m_l, F);
      jt::Fe re3 = jt::fadd(re2, m_r, F);
      s3 = jt::fadd(s3, jt::mont_mul(le3, re3, F), F);
    }
    jt::Fe eq0 = jt::load_limbs(eq + i, eq_ls);
    jt::Fe eq1 = jt::load_limbs(eq + i + h, eq_ls);
    jt::Fe m_eq = jt::fsub(eq1, eq0, F);
    jt::Fe eqe2 = jt::fadd(eq1, m_eq, F);
    jt::Fe eqe3 = jt::fadd(eqe2, m_eq, F);
    e[0] = jt::fadd(e[0], jt::mont_mul(eq0, s0, F), F);
    e[1] = jt::fadd(e[1], jt::mont_mul(eqe2, s2, F), F);
    e[2] = jt::fadd(e[2], jt::mont_mul(eqe3, s3, F), F);
  }
  block_reduce3(e, F);
  if (threadIdx.x == 0) {
    uint32_t* dst = partials + (long long)blockIdx.x * 24;
#pragma unroll
    for (int t = 0; t < 3; t++)
#pragma unroll
      for (int k = 0; k < 8; k++) dst[t * 8 + k] = e[t].w[k];
  }
}

// partials [nblocks, 3, 8 words] -> out [16, 3] limbs (limbs first)
__global__ void __launch_bounds__(GP_THREADS)
gp_pair_evals_reduce(const uint32_t* __restrict__ partials, long long nblocks,
                     int32_t* __restrict__ out, jt::Field F) {
  jt::Fe e[3] = {jt::fe_zero(), jt::fe_zero(), jt::fe_zero()};
  for (long long j = threadIdx.x; j < nblocks; j += blockDim.x) {
#pragma unroll
    for (int t = 0; t < 3; t++) {
      jt::Fe x;
#pragma unroll
      for (int k = 0; k < 8; k++) x.w[k] = partials[j * 24 + t * 8 + k];
      e[t] = jt::fadd(e[t], x, F);
    }
  }
  block_reduce3(e, F);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int t = 0; t < 3; t++) jt::store_limbs(out + t, 3, e[t]);
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
    jt::Fe v = jt::fadd(lo, jt::mont_mul(rc, jt::fsub(hi, lo, F), F), F);
    jt::store_limbs(dst + i, h, v);
  }
}

jt::Field make_field(const uint32_t* field) {
  jt::Field F;
  for (int k = 0; k < 8; k++) F.p[k] = field[k];
  F.inv = field[8];
  return F;
}

}  // namespace

// K2, both launches.  coeffs limb k of circuit b at coeffs[k*c_ls + b*c_es].
extern "C" int jt_gp_pair_evals(const int32_t* l, const int32_t* r,
                                const int32_t* eq, const int32_t* coeffs,
                                uint32_t* partials, int32_t* out, long long B,
                                long long h, long long l_bs, long long l_ls,
                                long long r_bs, long long r_ls,
                                long long eq_ls, long long c_ls,
                                long long c_es, long long nblocks,
                                const uint32_t* field, void* stream) {
  if (B < 1 || B > GP_MAX_B || h < 1 || nblocks < 1) return (int)cudaErrorInvalidValue;
  const jt::Field F = make_field(field);
  cudaStream_t st = (cudaStream_t)stream;
  gp_pair_evals_partial<<<(unsigned int)nblocks, GP_THREADS, 0, st>>>(
      l, r, eq, coeffs, partials, (int)B, h, l_bs, l_ls, r_bs, r_ls, eq_ls,
      c_ls, c_es, F);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gp_pair_evals_reduce<<<1, GP_THREADS, 0, st>>>(partials, nblocks, out, F);
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
  const jt::Field F = make_field(field);
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
