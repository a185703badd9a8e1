// K1 + K4: elementwise Montgomery product over limb tensors.
//
// Replaces jolt_tpu/field/pallas_mont.py::mont_mul_pallas (K1, [16, N]
// layout) and ::mont_mul_bl_pallas (K4, batch-leading [B, 16, s] layers of
// the grand-product tree): both compute a*b*R^-1 mod p elementwise, so one
// kernel serves both, indexing (batch, column) with a batch stride and a
// limb stride per operand.  A scalar operand ([16, 1]) comes in with
// element stride 0 and is never materialised.
//
// Bound on the H100: bytes, the one published rate that applies (3.35
// TB/s).  Each product reads 2 x 64 B of int32 limbs and writes 64 B:
// 2^22 products move 0.8 GB, 0.24 ms.  A product is 264 32-bit multiplies
// (field.cuh's CIOS), well under that time, so the design keeps to one pass
// over memory with nothing else in it: one thread per element, limbs read
// limbs-first (coalesced across the warp) into eight 32-bit words in
// registers, no shared memory, no intermediate in device memory.  How far
// the integer pipes hold it above the byte bound is measured in PERF.md.
#include "field.cuh"

namespace {

__global__ void __launch_bounds__(256)
mont_mul_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                int32_t* __restrict__ out, long long n, long long s,
                long long a_bs, long long a_ls, long long a_es,
                long long b_bs, long long b_ls, long long b_es,
                long long o_bs, long long o_ls, jt::Field F) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += step) {
    long long bb = e / s;
    long long i = e - bb * s;
    jt::Fe x = jt::load_limbs(a + bb * a_bs + i * a_es, a_ls);
    jt::Fe y = jt::load_limbs(b + bb * b_bs + i * b_es, b_ls);
    jt::store_limbs(out + bb * o_bs + i, o_ls, jt::fmul(x, y, F));
  }
}

}  // namespace

// out[bb, :, i] = a[bb, :, i] * b[bb, :, i] * R^-1 mod p for bb < B, i < s.
// Element (bb, i), limb k of operand x sits at x + bb*x_bs + i*x_es + k*x_ls.
extern "C" int jt_mont_mul(const int32_t* a, const int32_t* b, int32_t* out,
                           long long B, long long s, long long a_bs,
                           long long a_ls, long long a_es, long long b_bs,
                           long long b_ls, long long b_es, long long o_bs,
                           long long o_ls, const uint32_t* field,
                           void* stream) {
  const jt::Field F = jt::make_field(field);
  const long long n = B * s;
  if (n <= 0) return 0;
  const int threads = 256;
  mont_mul_kernel<<<jt_blocks(n, threads), threads, 0,
                    (cudaStream_t)stream>>>(a, b, out, n, s, a_bs, a_ls,
                                            a_es, b_bs, b_ls, b_es, o_bs,
                                            o_ls, F);
  return (int)cudaGetLastError();
}
