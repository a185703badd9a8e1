// 256-bit prime-field arithmetic for the port's CUDA kernels (BN254 Fr, Fq).
//
// A field element lives in registers as eight little-endian 32-bit words,
// in Montgomery form with R = 2^256.  In device memory it is sixteen 16-bit
// limbs stored as int32, limbs first (limb k of element i at k*stride + i):
// a warp's 32 threads read 32 consecutive int32 per limb, so every limb
// load is coalesced.  The modulus, 2p and -p^{-1} mod 2^32 come in at run
// time (struct Field, made by make_field from FieldSpec.words32()), passed
// by value to each kernel.
//
// Every multi-word add, subtract and multiply-add is a PTX carry chain
// (add.cc/addc.cc, sub.cc/subc.cc, mad.lo.cc/madc.hi.cc): one instruction
// per word, the carry in the flag, no 64-bit emulation and no shifts.
// Each chain is one `asm volatile` statement, so the carry flag never
// crosses code the compiler writes.
//
// mont_mul is CIOS (coarsely integrated operand scanning): per word b_i
// of b, a*b_i and then m*p (m = t_0 * -p^{-1}) are added into the
// accumulator, which moves down one word.  For a < 2p and any b < R it
// stays below a + p, and each row's sum below 2^32 (a + p) < 2^288.  It
// runs in the even/odd form described at mont_mul below.
//
// Lazy reduction.  BN254's p is below 2^253.6, so 4p < R = 2^256.  Hence
//   - mont_mul of a, b < 2p is below (a b + R p) / R < 4p^2/R + p < 2p
//     without its final subtraction (mont_mul<false>);
//   - a sum of two values below 2p is below 4p and fits eight words, and
//     one conditional subtraction of 2p brings it back below 2p.
// So a kernel may keep intermediates in [0, 2p) (ops against F.p2) and
// reduce to [0, p) (csub against F.p) only what it stores or sums into an
// output.  mont_mul<true> ends with that subtraction: its output is the
// unique reduced product, bit-identical to jolt_tpu's SOS pipeline
// (field/device.py `_mont_redc`).  tests/test_torch_lazy_mont.py checks
// these bounds on a word-level model of the routine.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace jt {

struct Field {
  uint32_t p[8];
  uint32_t p2[8];  // 2p
  uint32_t inv;    // -p^{-1} mod 2^32
};

// words = p's eight 32-bit words, then inv32 (FieldSpec.words32())
inline Field make_field(const uint32_t* words) {
  Field F;
  uint64_t c = 0;
  for (int k = 0; k < 8; k++) {
    F.p[k] = words[k];
    c += 2ull * words[k];
    F.p2[k] = (uint32_t)c;
    c >>= 32;
  }
  F.inv = words[8];
  return F;
}

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

// a + b mod 2^256, no reduction: the caller knows a + b < 2^256
__device__ __forceinline__ Fe add_raw(const Fe& a, const Fe& b) {
  Fe s = a;
  asm volatile(
      "add.cc.u32  %0, %0, %8;\n\t"
      "addc.cc.u32 %1, %1, %9;\n\t"
      "addc.cc.u32 %2, %2, %10;\n\t"
      "addc.cc.u32 %3, %3, %11;\n\t"
      "addc.cc.u32 %4, %4, %12;\n\t"
      "addc.cc.u32 %5, %5, %13;\n\t"
      "addc.cc.u32 %6, %6, %14;\n\t"
      "addc.u32    %7, %7, %15;"
      : "+r"(s.w[0]), "+r"(s.w[1]), "+r"(s.w[2]), "+r"(s.w[3]),
        "+r"(s.w[4]), "+r"(s.w[5]), "+r"(s.w[6]), "+r"(s.w[7])
      : "r"(b.w[0]), "r"(b.w[1]), "r"(b.w[2]), "r"(b.w[3]), "r"(b.w[4]),
        "r"(b.w[5]), "r"(b.w[6]), "r"(b.w[7]));
  return s;
}

// a >= m ? a - m : a  (a < 2m gives a mod m)
__device__ __forceinline__ Fe csub(const Fe& a, const uint32_t* m) {
  Fe r = a;
  asm volatile(
      "{\n\t.reg .u32 d<8>, bw;\n\t.reg .pred ge;\n\t"
      "sub.cc.u32  d0, %0, %8;\n\t"
      "subc.cc.u32 d1, %1, %9;\n\t"
      "subc.cc.u32 d2, %2, %10;\n\t"
      "subc.cc.u32 d3, %3, %11;\n\t"
      "subc.cc.u32 d4, %4, %12;\n\t"
      "subc.cc.u32 d5, %5, %13;\n\t"
      "subc.cc.u32 d6, %6, %14;\n\t"
      "subc.cc.u32 d7, %7, %15;\n\t"
      "subc.u32    bw, 0, 0;\n\t"
      "setp.eq.u32 ge, bw, 0;\n\t"
      "@ge mov.b32 %0, d0;\n\t"
      "@ge mov.b32 %1, d1;\n\t"
      "@ge mov.b32 %2, d2;\n\t"
      "@ge mov.b32 %3, d3;\n\t"
      "@ge mov.b32 %4, d4;\n\t"
      "@ge mov.b32 %5, d5;\n\t"
      "@ge mov.b32 %6, d6;\n\t"
      "@ge mov.b32 %7, d7;\n\t}"
      : "+r"(r.w[0]), "+r"(r.w[1]), "+r"(r.w[2]), "+r"(r.w[3]),
        "+r"(r.w[4]), "+r"(r.w[5]), "+r"(r.w[6]), "+r"(r.w[7])
      : "r"(m[0]), "r"(m[1]), "r"(m[2]), "r"(m[3]), "r"(m[4]), "r"(m[5]),
        "r"(m[6]), "r"(m[7]));
  return r;
}

// (a + b) mod m for a, b < m, m = p or 2p (so a + b < 4p < 2^256)
__device__ __forceinline__ Fe add_mod(const Fe& a, const Fe& b,
                                      const uint32_t* m) {
  return csub(add_raw(a, b), m);
}

// (a - b) mod m for a, b < m: a - b, plus m where it borrowed
__device__ __forceinline__ Fe sub_mod(const Fe& a, const Fe& b,
                                      const uint32_t* m) {
  Fe d = a;
  asm volatile(
      "{\n\t.reg .u32 q<8>, bw;\n\t"
      "sub.cc.u32  %0, %0, %8;\n\t"
      "subc.cc.u32 %1, %1, %9;\n\t"
      "subc.cc.u32 %2, %2, %10;\n\t"
      "subc.cc.u32 %3, %3, %11;\n\t"
      "subc.cc.u32 %4, %4, %12;\n\t"
      "subc.cc.u32 %5, %5, %13;\n\t"
      "subc.cc.u32 %6, %6, %14;\n\t"
      "subc.cc.u32 %7, %7, %15;\n\t"
      "subc.u32    bw, 0, 0;\n\t"
      "and.b32 q0, %16, bw;\n\t"
      "and.b32 q1, %17, bw;\n\t"
      "and.b32 q2, %18, bw;\n\t"
      "and.b32 q3, %19, bw;\n\t"
      "and.b32 q4, %20, bw;\n\t"
      "and.b32 q5, %21, bw;\n\t"
      "and.b32 q6, %22, bw;\n\t"
      "and.b32 q7, %23, bw;\n\t"
      "add.cc.u32  %0, %0, q0;\n\t"
      "addc.cc.u32 %1, %1, q1;\n\t"
      "addc.cc.u32 %2, %2, q2;\n\t"
      "addc.cc.u32 %3, %3, q3;\n\t"
      "addc.cc.u32 %4, %4, q4;\n\t"
      "addc.cc.u32 %5, %5, q5;\n\t"
      "addc.cc.u32 %6, %6, q6;\n\t"
      "addc.u32    %7, %7, q7;\n\t}"
      : "+r"(d.w[0]), "+r"(d.w[1]), "+r"(d.w[2]), "+r"(d.w[3]),
        "+r"(d.w[4]), "+r"(d.w[5]), "+r"(d.w[6]), "+r"(d.w[7])
      : "r"(b.w[0]), "r"(b.w[1]), "r"(b.w[2]), "r"(b.w[3]), "r"(b.w[4]),
        "r"(b.w[5]), "r"(b.w[6]), "r"(b.w[7]), "r"(m[0]), "r"(m[1]),
        "r"(m[2]), "r"(m[3]), "r"(m[4]), "r"(m[5]), "r"(m[6]), "r"(m[7]));
  return d;
}

// The Montgomery product: CIOS with the even/odd split (Emmart, Zheng and
// Weems; the same scheme as sppark's ff/mont_t.cuh).  The accumulator T
// lives in two eight-word halves: `ev` gathers the products of the even
// words a_0, a_2, ..., a_6 (low halves at even word positions, high halves
// at odd ones) and `od` those of the odd words, one word higher
// (T = ev + 2^32 od).  In every chain the low and the high half of one
// 32x32 product are neighbours, so ptxas emits each pair as one
// IMAD.WIDE.U32.X with carry in and out; the two chains do not depend on
// each other, so they interleave.  Per word b_i of b:
//   eo_row:  od is shifted down two words while a_odd * b_i is added
//            (od[j] = od[j+2] + ...), its word at position 0 (od[1]) is
//            folded into ev[0] at the head of that chain, and a_even * b_i
//            is added into ev;
//   eo_redc: m = ev[0] * inv, and m * p is added the same way, which makes
//            position 0 zero.
// The halves then swap roles for the next word, which stands for the shift
// down one word.  At the end od is folded into ev.  The bounds of the CIOS
// loop (T < a + p < 3p, each row below 2^32 (a + p)) keep every chain's
// top word from carrying out; tests/test_torch_lazy_mont.py runs these
// chains word by word and checks that.
#define JT_EO_OUT(ev, od)                                                 \
  "+r"(ev[0]), "+r"(ev[1]), "+r"(ev[2]), "+r"(ev[3]), "+r"(ev[4]),       \
      "+r"(ev[5]), "+r"(ev[6]), "+r"(ev[7]), "+r"(od[0]), "+r"(od[1]),   \
      "+r"(od[2]), "+r"(od[3]), "+r"(od[4]), "+r"(od[5]), "+r"(od[6]),   \
      "+r"(od[7])
#define JT_EO_IN(x, y)                                                    \
  "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(x[3]), "r"(x[4]), "r"(x[5]),      \
      "r"(x[6]), "r"(x[7]), "r"(y)

// first word: ev, od = a_even * b0, a_odd * b0 (no accumulator yet)
__device__ __forceinline__ void eo_first(uint32_t* ev, uint32_t* od,
                                         const Fe& a, uint32_t bi) {
  asm volatile(
      "mul.lo.u32 %8, %17, %24;\n\t"
      "mul.hi.u32 %9, %17, %24;\n\t"
      "mul.lo.u32 %10, %19, %24;\n\t"
      "mul.hi.u32 %11, %19, %24;\n\t"
      "mul.lo.u32 %12, %21, %24;\n\t"
      "mul.hi.u32 %13, %21, %24;\n\t"
      "mul.lo.u32 %14, %23, %24;\n\t"
      "mul.hi.u32 %15, %23, %24;\n\t"
      "mul.lo.u32 %0, %16, %24;\n\t"
      "mul.hi.u32 %1, %16, %24;\n\t"
      "mul.lo.u32 %2, %18, %24;\n\t"
      "mul.hi.u32 %3, %18, %24;\n\t"
      "mul.lo.u32 %4, %20, %24;\n\t"
      "mul.hi.u32 %5, %20, %24;\n\t"
      "mul.lo.u32 %6, %22, %24;\n\t"
      "mul.hi.u32 %7, %22, %24;"
      : "=r"(ev[0]), "=r"(ev[1]), "=r"(ev[2]), "=r"(ev[3]), "=r"(ev[4]),
        "=r"(ev[5]), "=r"(ev[6]), "=r"(ev[7]), "=r"(od[0]), "=r"(od[1]),
        "=r"(od[2]), "=r"(od[3]), "=r"(od[4]), "=r"(od[5]), "=r"(od[6]),
        "=r"(od[7])
      : JT_EO_IN(a.w, bi));
}

// later words: od shifted down two words, od[1] folded into ev[0],
// T += a * bi
__device__ __forceinline__ void eo_row(uint32_t* ev, uint32_t* od,
                                       const Fe& a, uint32_t bi) {
  asm volatile(
      "add.cc.u32 %0, %0, %9;\n\t"
      "madc.lo.cc.u32 %8, %17, %24, %10;\n\t"
      "madc.hi.cc.u32 %9, %17, %24, %11;\n\t"
      "madc.lo.cc.u32 %10, %19, %24, %12;\n\t"
      "madc.hi.cc.u32 %11, %19, %24, %13;\n\t"
      "madc.lo.cc.u32 %12, %21, %24, %14;\n\t"
      "madc.hi.cc.u32 %13, %21, %24, %15;\n\t"
      "madc.lo.cc.u32 %14, %23, %24, 0;\n\t"
      "madc.hi.u32 %15, %23, %24, 0;\n\t"
      "mad.lo.cc.u32 %0, %16, %24, %0;\n\t"
      "madc.hi.cc.u32 %1, %16, %24, %1;\n\t"
      "madc.lo.cc.u32 %2, %18, %24, %2;\n\t"
      "madc.hi.cc.u32 %3, %18, %24, %3;\n\t"
      "madc.lo.cc.u32 %4, %20, %24, %4;\n\t"
      "madc.hi.cc.u32 %5, %20, %24, %5;\n\t"
      "madc.lo.cc.u32 %6, %22, %24, %6;\n\t"
      "madc.hi.cc.u32 %7, %22, %24, %7;\n\t"
      "addc.u32 %15, %15, 0;"
      : JT_EO_OUT(ev, od)
      : JT_EO_IN(a.w, bi));
}

// m = ev[0] * inv; T += m * p (position 0 becomes zero)
__device__ __forceinline__ void eo_redc(uint32_t* ev, uint32_t* od,
                                        const Field& F) {
  asm volatile(
      "{\n\t"
      ".reg .u32 m;\n\t"
      "mul.lo.u32 m, %0, %24;\n\t"
      "mad.lo.cc.u32 %8, %17, m, %8;\n\t"
      "madc.hi.cc.u32 %9, %17, m, %9;\n\t"
      "madc.lo.cc.u32 %10, %19, m, %10;\n\t"
      "madc.hi.cc.u32 %11, %19, m, %11;\n\t"
      "madc.lo.cc.u32 %12, %21, m, %12;\n\t"
      "madc.hi.cc.u32 %13, %21, m, %13;\n\t"
      "madc.lo.cc.u32 %14, %23, m, %14;\n\t"
      "madc.hi.cc.u32 %15, %23, m, %15;\n\t"
      "mad.lo.cc.u32 %0, %16, m, %0;\n\t"
      "madc.hi.cc.u32 %1, %16, m, %1;\n\t"
      "madc.lo.cc.u32 %2, %18, m, %2;\n\t"
      "madc.hi.cc.u32 %3, %18, m, %3;\n\t"
      "madc.lo.cc.u32 %4, %20, m, %4;\n\t"
      "madc.hi.cc.u32 %5, %20, m, %5;\n\t"
      "madc.lo.cc.u32 %6, %22, m, %6;\n\t"
      "madc.hi.cc.u32 %7, %22, m, %7;\n\t"
      "addc.u32 %15, %15, 0;\n\t"
      "}"
      : JT_EO_OUT(ev, od)
      : JT_EO_IN(F.p, F.inv));
}

#undef JT_EO_OUT
#undef JT_EO_IN

// a * b * 2^-256 mod p for a, b < 2p.  REDUCE: the result in [0, p);
// otherwise in [0, 2p), congruent (the lazy form).
template <bool REDUCE>
__device__ __forceinline__ Fe mont_mul(const Fe& a, const Fe& b,
                                       const Field& F) {
  uint32_t ev[8], od[8];
#pragma unroll
  for (int i = 0; i < 8; i += 2) {
    if (i == 0)
      eo_first(ev, od, a, b.w[0]);
    else
      eo_row(ev, od, a, b.w[i]);
    eo_redc(ev, od, F);
    eo_row(od, ev, a, b.w[i + 1]);  // the halves swap roles
    eo_redc(od, ev, F);
  }
  // T = ev + 2^-32 od with od[0] = 0: fold od[1..7] into ev[0..6]
  asm volatile(
      "add.cc.u32  %0, %0, %8;\n\t"
      "addc.cc.u32 %1, %1, %9;\n\t"
      "addc.cc.u32 %2, %2, %10;\n\t"
      "addc.cc.u32 %3, %3, %11;\n\t"
      "addc.cc.u32 %4, %4, %12;\n\t"
      "addc.cc.u32 %5, %5, %13;\n\t"
      "addc.cc.u32 %6, %6, %14;\n\t"
      "addc.u32    %7, %7, 0;"
      : "+r"(ev[0]), "+r"(ev[1]), "+r"(ev[2]), "+r"(ev[3]), "+r"(ev[4]),
        "+r"(ev[5]), "+r"(ev[6]), "+r"(ev[7])
      : "r"(od[1]), "r"(od[2]), "r"(od[3]), "r"(od[4]), "r"(od[5]),
        "r"(od[6]), "r"(od[7]));
  Fe r;
#pragma unroll
  for (int k = 0; k < 8; k++) r.w[k] = ev[k];
  return REDUCE ? csub(r, F.p) : r;
}

// Fully reduced ops: inputs and outputs in [0, p).
__device__ __forceinline__ Fe fmul(const Fe& a, const Fe& b, const Field& F) {
  return mont_mul<true>(a, b, F);
}
__device__ __forceinline__ Fe fadd(const Fe& a, const Fe& b, const Field& F) {
  return add_mod(a, b, F.p);
}
__device__ __forceinline__ Fe fsub(const Fe& a, const Fe& b, const Field& F) {
  return sub_mod(a, b, F.p);
}
__device__ __forceinline__ Fe fdbl(const Fe& a, const Field& F) {
  return add_mod(a, a, F.p);
}

// Lazy ops: inputs and outputs in [0, 2p).
__device__ __forceinline__ Fe lmul(const Fe& a, const Fe& b, const Field& F) {
  return mont_mul<false>(a, b, F);
}
__device__ __forceinline__ Fe ladd(const Fe& a, const Fe& b, const Field& F) {
  return add_mod(a, b, F.p2);
}
__device__ __forceinline__ Fe lsub(const Fe& a, const Fe& b, const Field& F) {
  return sub_mod(a, b, F.p2);
}
// [0, 2p) -> [0, p)
__device__ __forceinline__ Fe reduce(const Fe& a, const Field& F) {
  return csub(a, F.p);
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
