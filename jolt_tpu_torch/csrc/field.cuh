// 256-bit prime-field arithmetic for the port's CUDA kernels (BN254 Fr, Fq).
//
// A field element lives in registers as eight little-endian 32-bit words,
// in Montgomery form with R = 2^256.  In device memory it is sixteen 16-bit
// limbs stored as int32, limbs first (limb k of element i at k*stride + i):
// a warp's 32 threads read 32 consecutive int32 per limb, so every limb
// load is coalesced.  The modulus and -p^{-1} mod 2^32 come in at run time
// (struct Field, from FieldSpec.words32()), passed by value to each kernel.
//
// mont_mul is CIOS (coarsely integrated operand scanning) with 32x32->64
// products and one final conditional subtraction, so every output is the
// fully reduced value in [0, p): the unique reduced Montgomery product,
// bit-identical to jolt_tpu's SOS pipeline (field/device.py `_mont_redc`).
// Inputs must be reduced (< p); p < 2^254 keeps every intermediate in nine
// words.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace jt {

struct Field {
  uint32_t p[8];
  uint32_t inv;  // -p^{-1} mod 2^32
};

struct Fe {
  uint32_t w[8];
};

__device__ __forceinline__ Fe fe_zero() {
  Fe z;
#pragma unroll
  for (int k = 0; k < 8; k++) z.w[k] = 0;
  return z;
}

__device__ __forceinline__ bool fe_is_zero(const Fe& a) {
  uint32_t acc = 0;
#pragma unroll
  for (int k = 0; k < 8; k++) acc |= a.w[k];
  return acc == 0;
}

// 16 limbs at src[0], src[ls], ..., src[15*ls] -> 8 words
__device__ __forceinline__ Fe load_limbs(const int32_t* __restrict__ src,
                                         long long ls) {
  Fe x;
#pragma unroll
  for (int k = 0; k < 8; k++) {
    uint32_t lo = (uint32_t)__ldg(src + (2 * k) * ls);
    uint32_t hi = (uint32_t)__ldg(src + (2 * k + 1) * ls);
    x.w[k] = (lo & 0xFFFFu) | (hi << 16);
  }
  return x;
}

__device__ __forceinline__ void store_limbs(int32_t* __restrict__ dst,
                                            long long ls, const Fe& x) {
#pragma unroll
  for (int k = 0; k < 8; k++) {
    dst[(2 * k) * ls] = (int32_t)(x.w[k] & 0xFFFFu);
    dst[(2 * k + 1) * ls] = (int32_t)(x.w[k] >> 16);
  }
}

// a - p with borrow; returns the borrow out of the top word
__device__ __forceinline__ uint32_t sub_p(Fe& d, const Fe& a, const Field& F) {
  uint64_t borrow = 0;
#pragma unroll
  for (int k = 0; k < 8; k++) {
    uint64_t v = (uint64_t)a.w[k] - F.p[k] - borrow;
    d.w[k] = (uint32_t)v;
    borrow = v >> 63;
  }
  return (uint32_t)borrow;
}

// (a + b) mod p, a, b < p
__device__ __forceinline__ Fe fadd(const Fe& a, const Fe& b, const Field& F) {
  Fe s, d;
  uint64_t c = 0;
#pragma unroll
  for (int k = 0; k < 8; k++) {
    c += (uint64_t)a.w[k] + b.w[k];
    s.w[k] = (uint32_t)c;
    c >>= 32;
  }
  uint32_t borrow = sub_p(d, s, F);  // a + b < 2p < 2^256: c == 0
  return borrow ? s : d;
}

// (a - b) mod p, a, b < p
__device__ __forceinline__ Fe fsub(const Fe& a, const Fe& b, const Field& F) {
  Fe d;
  uint64_t borrow = 0;
#pragma unroll
  for (int k = 0; k < 8; k++) {
    uint64_t v = (uint64_t)a.w[k] - b.w[k] - borrow;
    d.w[k] = (uint32_t)v;
    borrow = v >> 63;
  }
  if (borrow) {  // wrapped below zero: add p back (mod 2^256)
    uint64_t c = 0;
#pragma unroll
    for (int k = 0; k < 8; k++) {
      c += (uint64_t)d.w[k] + F.p[k];
      d.w[k] = (uint32_t)c;
      c >>= 32;
    }
  }
  return d;
}

__device__ __forceinline__ Fe fdbl(const Fe& a, const Field& F) {
  return fadd(a, a, F);
}

// a * b * 2^-256 mod p (CIOS), a, b < p
__device__ __forceinline__ Fe mont_mul(const Fe& a, const Fe& b,
                                       const Field& F) {
  uint32_t t[10];
#pragma unroll
  for (int k = 0; k < 10; k++) t[k] = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) {
      // t + a*b + c <= (2^32-1) + (2^32-1)^2 + (2^32-1) < 2^64
      c += (uint64_t)t[j] + (uint64_t)a.w[j] * b.w[i];
      t[j] = (uint32_t)c;
      c >>= 32;
    }
    uint64_t s = (uint64_t)t[8] + c;
    t[8] = (uint32_t)s;
    t[9] = (uint32_t)(s >> 32);
    uint32_t m = t[0] * F.inv;
    c = ((uint64_t)m * F.p[0] + t[0]) >> 32;  // low word cancels to 0
#pragma unroll
    for (int j = 1; j < 8; j++) {
      c += (uint64_t)t[j] + (uint64_t)m * F.p[j];
      t[j - 1] = (uint32_t)c;
      c >>= 32;
    }
    s = (uint64_t)t[8] + c;
    t[7] = (uint32_t)s;
    t[8] = t[9] + (uint32_t)(s >> 32);
  }
  Fe r, d;
#pragma unroll
  for (int k = 0; k < 8; k++) r.w[k] = t[k];
  uint32_t borrow = sub_p(d, r, F);  // t < 2p; t[8] == 0 since p < 2^254
  return (t[8] == 0 && borrow) ? r : d;
}

}  // namespace jt

extern "C" const char* jt_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// Grid size for a grid-stride loop over n items.
static inline unsigned int jt_blocks(long long n, int threads) {
  long long b = (n + threads - 1) / threads;
  const long long cap = 1LL << 20;
  return (unsigned int)(b < 1 ? 1 : (b > cap ? cap : b));
}
