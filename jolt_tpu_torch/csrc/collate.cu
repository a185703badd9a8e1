// K13: the primary sumcheck's collations at one point, in one launch.
//
// Replaces jolt_tpu/vm/instruction_lookups.py:257-265 `_g_term_jit` (one
// jax.jit program per instruction: f_t[k] * g_k(e_t[mems_k])) and the sum
// of the terms at :299-304.  For every element i of the half-hypercube
//
//   inner[i] = sum_k f_t[k, i] * g_k(e_t[mems_k, i])  mod p,
//
// with g_k instruction k's collation polynomial.  The collations are
// recorded once on the host (vm/collation.py) as one straight-line
// program of rows (op, dst, a, b): op ADD, SUB or MUL (the Montgomery
// product), dst a temporary slot, and each operand a column of e_t
// (kind 0), a column of f_t (kind 1), a constant in Montgomery form (kind
// 2) or a slot (kind 3), as kind << 16 | index.  The last rows of each
// instruction multiply by its flag and add into the running sum, so slot
// `out_slot` ends holding inner[i].
//
// Design: one thread per element runs every row.  Every thread of a warp
// reads the same row and the same constant at once (uniform loads through
// the read-only cache), so the program costs no divergence; the slots
// (at most MAX_SLOTS field elements, six for rv32i_vm()'s 29
// instructions) sit in local memory, which L1 holds.  e_t and f_t come in
// as (limb, column, element) strides, so the round's lo/hi halves of
// E [16, m, 2h] and flags [16, NI, 2h] go in as views, as do K10's
// contiguous outputs at t >= 2 and a mesh shard's tensors; inner [16, h]
// goes out contiguous and reduced, as K12 takes it.  Every value is kept
// reduced (field.cuh's fadd, fsub, fmul), so the result is the unique
// residue: the same bits as the DevF path's K1/K10 launches, op by op.
//
// Bound on the H100, per element, from the recorded program of
// rv32i_vm() (C = 4, M = 2^16): 150 Montgomery products (121 in the
// collations, 29 for f * g) of 264 32-bit multiplies each, and 117 adds
// and subtracts; at h = 2^15, 1.30e9 multiplies at 1.673e13/s, 0.078 ms
// (INT32).  Bytes: the 55 memories and 29 flags read once and inner
// written once, (55 + 29 + 1) * 64 B, 0.053 ms at 3.35 TB/s.  So the
// multiplies bound it; with one thread per element, a round's h = 2^15
// fills some eight warps an SM, and the later rounds (h down to 1) are
// the program's dependent chain of 150 products behind one launch.
#include "field.cuh"

namespace {

constexpr int COLLATE_THREADS = 256;
constexpr int MAX_SLOTS = 16;
constexpr int KIND_SHIFT = 16;

// a tensor's columns: element (c, i) limb l at base + c*cs + i*es + l*ls
struct Cols {
  const int32_t* base;
  long long ls, cs, es;
};

__device__ __forceinline__ jt::Fe fetch(int ref, const Cols& e,
                                        const Cols& f,
                                        const int32_t* __restrict__ consts,
                                        long long n_consts,
                                        const jt::Fe* slot, long long i) {
  const int kind = ref >> KIND_SHIFT;
  const long long idx = ref & ((1 << KIND_SHIFT) - 1);
  if (kind == 0) return jt::load_limbs(e.base + idx * e.cs + i * e.es, e.ls);
  if (kind == 1) return jt::load_limbs(f.base + idx * f.cs + i * f.es, f.ls);
  if (kind == 2) return jt::load_limbs(consts + idx, n_consts);
  return slot[idx];
}

__global__ void __launch_bounds__(COLLATE_THREADS)
collate_kernel(Cols e, Cols f, const int4* __restrict__ prog, int n_ops,
               const int32_t* __restrict__ consts, long long n_consts,
               int out_slot, int32_t* __restrict__ out, long long h,
               jt::Field F) {
  jt::Fe slot[MAX_SLOTS];
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < h;
       i += step) {
    for (int pc = 0; pc < n_ops; pc++) {
      const int4 row = __ldg(prog + pc);
      const jt::Fe x = fetch(row.z, e, f, consts, n_consts, slot, i);
      const jt::Fe y = fetch(row.w, e, f, consts, n_consts, slot, i);
      slot[row.y] = row.x == 0   ? jt::fadd(x, y, F)
                    : row.x == 1 ? jt::fsub(x, y, F)
                                 : jt::fmul(x, y, F);
    }
    jt::store_limbs(out + i, h, slot[out_slot]);
  }
}

}  // namespace

// K13.  out[:, i] = the program's out_slot at element i, for i < h; e_t
// and f_t by (limb, column, element) strides; prog int32 [n_ops, 4]
// (op, dst, a, b), 16-byte aligned; consts int32 [16, n_consts]
// Montgomery limbs; out [16, h].
extern "C" int jt_collate(const int32_t* e, const int32_t* f, int32_t* out,
                          long long h, long long e_ls, long long e_cs,
                          long long e_es, long long f_ls, long long f_cs,
                          long long f_es, const int32_t* prog, long long n_ops,
                          const int32_t* consts, long long n_consts,
                          long long out_slot, const uint32_t* field,
                          void* stream) {
  if (h < 1 || n_ops < 1 || n_ops > (1LL << 30) || out_slot < 0 ||
      out_slot >= MAX_SLOTS || ((uintptr_t)prog & 15))
    return (int)cudaErrorInvalidValue;
  const jt::Field F = jt::make_field(field);
  const Cols ce{e, e_ls, e_cs, e_es}, cf{f, f_ls, f_cs, f_es};
  collate_kernel<<<jt_blocks(h, COLLATE_THREADS), COLLATE_THREADS, 0,
                   (cudaStream_t)stream>>>(
      ce, cf, reinterpret_cast<const int4*>(prog), (int)n_ops, consts,
      n_consts, (int)out_slot, out, h, F);
  return (int)cudaGetLastError();
}
