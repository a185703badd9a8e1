// K5 + K6 + K7: elementwise BN254 G1 point additions and doubling over Fq
// limb tensors.
//
// K5 replaces jolt_tpu/curve/pallas_point.py::proj_cadd_pallas: the
// complete projective addition for a = 0, b3 = 9 (Renes-Costello-Batina
// 2016, Algorithm 7; identity (0:1:0)), the accumulate step of the
// bitplane commit fold (curve/device.py:402-454).
// K6 replaces ::jac_add_pallas: the Jacobian addition with masked doubling,
// inverse and infinity (Z = 0) cases of `_jac_add_core` (pallas_point.py:
// 65-100), the tree step of SRS generation (commitment/kzg.py:73-92).
// Outputs are coordinates, not unique residues, so both follow the
// reference formulas step for step; every field op yields the reduced
// value, so the limbs match jolt_tpu bit for bit.
// K7 replaces ::jac_double_pallas: `dbl_core`, the dbl-2009-l doubling
// (a = 0, 7 Fq Montgomery products; Z = 0 stays at infinity), launched on
// its own.  Neither package's prove path launches it: jolt_tpu reaches
// jac_double_pallas only from jac_add's non-Pallas branch, where the batch
// is below the Pallas threshold, and the port's jac_add (K6) computes the
// doubling inside its own kernel.  chip_smoke.py holds K7 against its
// plain version.
//
// Bound on the H100: bytes.  K5/K6 read six coordinates and write three,
// 9 x 64 B per point-op: 2^20 adds move 0.60 GB, 0.18 ms at 3.35 TB/s;
// K7 reads three and writes three, 6 x 64 B per point.  K5 does 12 Fq
// Montgomery products per add, K6 about 22 (the doubling is computed and
// selected, as on the TPU) and K7 7, so all carry far more integer work
// per byte than the field kernels.  The design keeps one point-op per
// thread with every intermediate in registers and nothing in shared
// memory.
#include "field.cuh"

namespace {

using jt::Fe;
using jt::Field;

struct Pt {
  Fe X, Y, Z;
};

__device__ __forceinline__ Fe mul(const Fe& a, const Fe& b, const Field& F) {
  return jt::mont_mul(a, b, F);
}
__device__ __forceinline__ Fe add(const Fe& a, const Fe& b, const Field& F) {
  return jt::fadd(a, b, F);
}
__device__ __forceinline__ Fe sub(const Fe& a, const Fe& b, const Field& F) {
  return jt::fsub(a, b, F);
}
__device__ __forceinline__ Fe dbl(const Fe& a, const Field& F) {
  return jt::fdbl(a, F);
}

// dbl-2009-l, a = 0 (pallas_point.py `_dbl_core`); Z = 0 stays at Z3 = 0
__device__ __forceinline__ Pt dbl_core(const Fe& X, const Fe& Y, const Fe& Z,
                                       const Field& F) {
  Fe A = mul(X, X, F);
  Fe B = mul(Y, Y, F);
  Fe C = mul(B, B, F);
  Fe xb = add(X, B, F);
  Fe D = dbl(sub(sub(mul(xb, xb, F), A, F), C, F), F);
  Fe E = add(dbl(A, F), A, F);
  Fe Fv = mul(E, E, F);
  Pt out;
  out.X = sub(Fv, dbl(D, F), F);
  out.Y = sub(mul(E, sub(D, out.X, F), F), dbl(dbl(dbl(C, F), F), F), F);
  out.Z = dbl(mul(Y, Z, F), F);
  return out;
}

__device__ __forceinline__ Fe sel(bool c, const Fe& a, const Fe& b) {
  return c ? a : b;
}

// pallas_point.py `_jac_add_core`
__device__ __forceinline__ Pt jac_add_core(const Pt& P1, const Pt& P2,
                                           const Field& F) {
  Fe z1z1 = mul(P1.Z, P1.Z, F);
  Fe z2z2 = mul(P2.Z, P2.Z, F);
  Fe u1 = mul(P1.X, z2z2, F);
  Fe u2 = mul(P2.X, z1z1, F);
  Fe s1 = mul(mul(P1.Y, P2.Z, F), z2z2, F);
  Fe s2 = mul(mul(P2.Y, P1.Z, F), z1z1, F);
  Fe h = sub(u2, u1, F);
  Fe rr = sub(s2, s1, F);
  Fe h2 = mul(h, h, F);
  Fe h3 = mul(h, h2, F);
  Fe v = mul(u1, h2, F);
  Fe X3 = sub(sub(mul(rr, rr, F), h3, F), dbl(v, F), F);
  Fe Y3 = sub(mul(rr, sub(v, X3, F), F), mul(s1, h3, F), F);
  Fe Z3 = mul(mul(P1.Z, P2.Z, F), h, F);

  Pt d = dbl_core(P1.X, P1.Y, P1.Z, F);

  const bool p1_inf = jt::fe_is_zero(P1.Z);
  const bool p2_inf = jt::fe_is_zero(P2.Z);
  const bool h_zero = jt::fe_is_zero(h) && !p1_inf && !p2_inf;
  const bool r_zero = jt::fe_is_zero(rr);
  const bool is_dbl = h_zero && r_zero;
  const bool is_opp = h_zero && !r_zero;

  X3 = sel(is_dbl, d.X, X3);
  Y3 = sel(is_dbl, d.Y, Y3);
  Z3 = sel(is_dbl, d.Z, Z3);
  Z3 = sel(is_opp, jt::fe_zero(), Z3);
  Pt out;
  out.X = sel(p2_inf, P1.X, sel(p1_inf, P2.X, X3));
  out.Y = sel(p2_inf, P1.Y, sel(p1_inf, P2.Y, Y3));
  out.Z = sel(p2_inf, P1.Z, sel(p1_inf, P2.Z, Z3));
  return out;
}

// pallas_point.py `_cadd_core`: RCB16 Algorithm 7, a = 0, b3 = 9
__device__ __forceinline__ Pt cadd_core(const Pt& P1, const Pt& P2,
                                        const Field& F) {
  auto b3 = [&](const Fe& t) { return add(dbl(dbl(dbl(t, F), F), F), t, F); };
  Fe t0 = mul(P1.X, P2.X, F);
  Fe t1 = mul(P1.Y, P2.Y, F);
  Fe t2 = mul(P1.Z, P2.Z, F);
  Fe t3 = mul(add(P1.X, P1.Y, F), add(P2.X, P2.Y, F), F);
  t3 = sub(t3, add(t0, t1, F), F);
  Fe t4 = mul(add(P1.Y, P1.Z, F), add(P2.Y, P2.Z, F), F);
  t4 = sub(t4, add(t1, t2, F), F);
  Fe X3 = mul(add(P1.X, P1.Z, F), add(P2.X, P2.Z, F), F);
  Fe Y3 = sub(X3, add(t0, t2, F), F);
  t0 = add(dbl(t0, F), t0, F);
  t2 = b3(t2);
  Fe Z3 = add(t1, t2, F);
  t1 = sub(t1, t2, F);
  Y3 = b3(Y3);
  Pt out;
  out.X = sub(mul(t3, t1, F), mul(t4, Y3, F), F);
  out.Y = add(mul(Y3, t0, F), mul(t1, Z3, F), F);
  out.Z = add(mul(Z3, t4, F), mul(t0, t3, F), F);
  return out;
}

struct PointArgs {
  const int32_t* in[6];   // x1 y1 z1 x2 y2 z2 (K7: x1 y1 z1 only)
  long long ls[6];        // their limb strides
  int32_t* out[3];        // x3 y3 z3, limb stride o_ls
  long long o_ls;
};

template <int OP>
__global__ void __launch_bounds__(128)
point_kernel(PointArgs A, long long n, Field F) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step) {
    Pt P1, R;
    P1.X = jt::load_limbs(A.in[0] + i, A.ls[0]);
    P1.Y = jt::load_limbs(A.in[1] + i, A.ls[1]);
    P1.Z = jt::load_limbs(A.in[2] + i, A.ls[2]);
    if constexpr (OP == 2) {
      R = dbl_core(P1.X, P1.Y, P1.Z, F);
    } else {
      Pt P2;
      P2.X = jt::load_limbs(A.in[3] + i, A.ls[3]);
      P2.Y = jt::load_limbs(A.in[4] + i, A.ls[4]);
      P2.Z = jt::load_limbs(A.in[5] + i, A.ls[5]);
      if constexpr (OP == 0) {
        R = cadd_core(P1, P2, F);
      } else {
        R = jac_add_core(P1, P2, F);
      }
    }
    jt::store_limbs(A.out[0] + i, A.o_ls, R.X);
    jt::store_limbs(A.out[1] + i, A.o_ls, R.Y);
    jt::store_limbs(A.out[2] + i, A.o_ls, R.Z);
  }
}

template <int OP>
int launch_point(const int32_t* x1, const int32_t* y1, const int32_t* z1,
                 const int32_t* x2, const int32_t* y2, const int32_t* z2,
                 int32_t* ox, int32_t* oy, int32_t* oz, long long n,
                 long long ls_x1, long long ls_y1, long long ls_z1,
                 long long ls_x2, long long ls_y2, long long ls_z2,
                 long long o_ls, const uint32_t* field, void* stream) {
  if (n <= 0) return 0;
  PointArgs A;
  const int32_t* in[6] = {x1, y1, z1, x2, y2, z2};
  const long long ls[6] = {ls_x1, ls_y1, ls_z1, ls_x2, ls_y2, ls_z2};
  for (int k = 0; k < 6; k++) {
    A.in[k] = in[k];
    A.ls[k] = ls[k];
  }
  A.out[0] = ox;
  A.out[1] = oy;
  A.out[2] = oz;
  A.o_ls = o_ls;
  Field F;
  for (int k = 0; k < 8; k++) F.p[k] = field[k];
  F.inv = field[8];
  const int threads = 128;
  point_kernel<OP><<<jt_blocks(n, threads), threads, 0,
                     (cudaStream_t)stream>>>(A, n, F);
  return (int)cudaGetLastError();
}

}  // namespace

// K5: (ox, oy, oz)[i] = (x1, y1, z1)[i] + (x2, y2, z2)[i], complete
// projective.  Coordinate limb k of element i sits at ptr[k*ls + i].
extern "C" int jt_proj_cadd(const int32_t* x1, const int32_t* y1,
                            const int32_t* z1, const int32_t* x2,
                            const int32_t* y2, const int32_t* z2, int32_t* ox,
                            int32_t* oy, int32_t* oz, long long n,
                            long long ls_x1, long long ls_y1, long long ls_z1,
                            long long ls_x2, long long ls_y2, long long ls_z2,
                            long long o_ls, const uint32_t* field,
                            void* stream) {
  return launch_point<0>(x1, y1, z1, x2, y2, z2, ox, oy, oz, n, ls_x1, ls_y1,
                         ls_z1, ls_x2, ls_y2, ls_z2, o_ls, field, stream);
}

// K6: the same over Jacobian coordinates with the masked special cases.
extern "C" int jt_jac_add(const int32_t* x1, const int32_t* y1,
                          const int32_t* z1, const int32_t* x2,
                          const int32_t* y2, const int32_t* z2, int32_t* ox,
                          int32_t* oy, int32_t* oz, long long n,
                          long long ls_x1, long long ls_y1, long long ls_z1,
                          long long ls_x2, long long ls_y2, long long ls_z2,
                          long long o_ls, const uint32_t* field,
                          void* stream) {
  return launch_point<1>(x1, y1, z1, x2, y2, z2, ox, oy, oz, n, ls_x1, ls_y1,
                         ls_z1, ls_x2, ls_y2, ls_z2, o_ls, field, stream);
}

// K7: (ox, oy, oz)[i] = 2 * (x, y, z)[i], Jacobian, a = 0; Z = 0 stays 0.
extern "C" int jt_jac_double(const int32_t* x, const int32_t* y,
                             const int32_t* z, int32_t* ox, int32_t* oy,
                             int32_t* oz, long long n, long long ls_x,
                             long long ls_y, long long ls_z, long long o_ls,
                             const uint32_t* field, void* stream) {
  return launch_point<2>(x, y, z, nullptr, nullptr, nullptr, ox, oy, oz, n,
                         ls_x, ls_y, ls_z, 0, 0, 0, o_ls, field, stream);
}
