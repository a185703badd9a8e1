// The primary sumcheck's round: every point's evaluation in one launch.
//
// Replaces jolt_tpu/vm/instruction_lookups.py:279-309
// `_primary_round_evals_decomposed`, a round of four kinds of jax.jit
// program: the split into lo/hi halves and hi - lo (`_primary_split_jit`
// :235), the extrapolation to t >= 2 (`_primary_ext_jit` :249), one
// program per instruction f_t[k] * g_k(e_t[mems_k]) (`_g_term_jit` :258)
// summed, and the finisher (`_point_finish_jit` :268).  For t = 0..d
//
//   evals[t] = sum_i eq_t[i] * (sum_k f_t[k, i] * g_k(e_t[mems_k, i])
//                               - out_t[i])  mod p,
//
// x_t = lo + t (hi - lo) for x each of eq, out, the flags and the
// memories, i over the half-hypercube [0, h).  The collations g_k are
// recorded on the host (vm/collation.py) and bin-packed into G <= 8
// groups by their serial chain levels (longest first, each into the group
// with the least so far); each group is a straight-line program of rows
// (op, dst, a, b): op ADD, SUB or MUL (the Montgomery product), dst one of
// the group's slots, each operand a staged column (kind 5), a constant in
// Montgomery form (kind 2) or a slot (kind 3), as kind << 16 | index.  A
// group's rows end with its partial sum of f_k * g_k in its `out` slot.
//
// Design.  A block takes a tile of 32 elements and G warps, one per group
// (lane = element), and `split` blocks share a tile, block b of them
// taking the points b, b + split, ...:
//   1. stage: every column the rows read (eq, out, each flag, each memory
//      read) is loaded once, lo and hi, into shared memory as x_first =
//      lo + first (hi - lo) and the step split (hi - lo), each by modular
//      doubling and adding (the same residue as jolt_tpu's repeated adds);
//      the constants beside them.  The block's threads take (column,
//      live element) pairs, so a short tile (the last rounds) stages its
//      few elements of all columns side by side;
//   2. per point: each warp runs its group's rows, each row's descriptor
//      fetched a row ahead, operands and slots in shared memory ([column]
//      [word][lane], so a warp's 32 loads of a word fall in 32 banks),
//      values kept lazily in [0, 2p) (field.cuh's lmul, ladd, lsub); then
//      warp 0 reduces and adds the G partial sums, takes the finisher
//      eq_t (inner - out_t) (0 past h), sums the 32 elements by shuffles
//      and writes one 8-word partial for (point, tile), while the other
//      warps step their columns to the block's next point (x += split
//      (hi - lo)), warp 0 eq's and out's after its finisher;
//   3. the last block to finish (a ticket on a counter that the wrapper
//      keeps per stream, reset to 0 by that block) sums each point's
//      partials over the tiles and writes evals [16, points], reduced.
// No atomics touch field values; sums mod p are unique, so the result is
// jolt_tpu's bits whatever the order.
//
// Bound on the H100.  At h = 2^15 and rv32i_vm()'s 29 instructions (150
// Montgomery products an element at each of 9 points, 264 32-bit
// multiplies each, and the finisher's): some 1.2e10 multiplies at
// 1.673e13/s, 0.71 ms, 0.79 ms with the adds (INT32).  Bytes: lo and hi
// of the 86 staged columns once, 0.36 GB, 0.108 ms at 3.35 TB/s.  At small
// h each block is its longest group's dependent chain (some 3,000 levels
// of 4 cycles for rv32i_vm()), beside a launch.  So the wrapper picks
// `split` (instruction_lookups.py `round_plan`): at h = 2^15 one block a
// tile walks all 9 points, so lo and hi are read once; at h <= 2^7 the
// points run side by side, a block each.  The stage (x and the step), the
// slots and the constants take some 210 KB of shared memory for
// rv32i_vm() (`round_smem_bytes`): one block of 8 warps an SM, which is
// what holds the kernel back at h = 2^15 (about 1.6 ms on an H100 at
// 700 W, half its INT32 bound): two warps a scheduler, each a chain of
// dependent multiply-adds, leave the multiply pipe idle most cycles.
// Tried on the same card and not kept: staging four columns' loads at a
// time (2 % slower), and forwarding a row's result to the next in
// registers (no faster).  More warps need less shared memory a block: the
// flags read from device memory at use and one point a block would fit
// two blocks an SM.
#include "field.cuh"

namespace {

constexpr int ROUND_THREADS = 256;
constexpr int MAX_GROUPS = ROUND_THREADS / 32;
constexpr int MAX_SLOTS = 16;   // slots of one group (collation.py)
constexpr int KIND_SHIFT = 16;
constexpr int K_CONST = 2;          // operand kinds (collation.py); any
constexpr int K_SLOT = 3;           // other kind is a staged column (5)
constexpr int TILE = 32;             // elements of a block
constexpr int COL_WORDS = 8 * TILE;  // a staged column or a slot

// a tensor's columns: element (c, i) limb l at base + c*cs + i*es + l*ls
struct Src {
  const int32_t* base;
  long long ls, cs, es;
};

struct Round {
  Src src[4];           // eq, out, flags, E (collation.py EQ..MEMS)
  long long h, tiles;   // elements of a half; tiles of 32
  int points, split;    // d + 1; blocks per tile
  const int4* rows;     // every group's rows, group after group
  const int32_t* meta;  // row offsets [G + 1], out slots [G], slot bases
                        // [G], staged columns' sources [n_stage]
  const int32_t* consts;  // Montgomery limbs [16, n_consts]
  int n_consts, groups, n_stage, n_slots;
  uint32_t* partials;     // 8 words per (point, tile)
  unsigned int* counter;  // 0 between launches
  int32_t* out;           // [16, points]
};

__device__ __forceinline__ void put8(uint32_t* p, int st, const jt::Fe& v) {
#pragma unroll
  for (int w = 0; w < 8; w++) p[w * st] = v.w[w];
}

__device__ __forceinline__ jt::Fe get8(const uint32_t* p, int st) {
  jt::Fe v;
#pragma unroll
  for (int w = 0; w < 8; w++) v.w[w] = p[w * st];
  return v;
}

// k x mod p, 0 <= k < 2^31, by doubling and adding from k's top bit
__device__ jt::Fe times(const jt::Fe& x, int k, const jt::Field& F) {
  jt::Fe acc = jt::fe_zero();
  for (int b = 31 - __clz(k | 1); b >= 0; b--) {
    acc = jt::fdbl(acc, F);
    if ((k >> b) & 1) acc = jt::fadd(acc, x, F);
  }
  return acc;
}

__device__ __forceinline__ jt::Fe operand(int ref, const uint32_t* xs,
                                          const uint32_t* cst,
                                          const uint32_t* mine, int lane) {
  const int kind = ref >> KIND_SHIFT, idx = ref & ((1 << KIND_SHIFT) - 1);
  if (kind == K_CONST) return get8(cst + idx * 8, 1);
  return get8((kind == K_SLOT ? mine : xs) + idx * COL_WORDS + lane, TILE);
}

__global__ void __launch_bounds__(ROUND_THREADS, 1)
primary_round_kernel(Round r, jt::Field F) {
  extern __shared__ uint32_t sm[];
  __shared__ unsigned int is_last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t* xs = sm;                               // x_t of each column
  uint32_t* ds = xs + r.n_stage * COL_WORDS;       // split (hi - lo)
  uint32_t* slots = ds + r.n_stage * COL_WORDS;
  uint32_t* cst = slots + r.n_slots * COL_WORDS;
  const int32_t* outs = r.meta + r.groups + 1;
  const int32_t* bases = outs + r.groups;
  const int32_t* stage_src = bases + r.groups;
  const long long tile = blockIdx.x / r.split;
  const int first = blockIdx.x % r.split;
  const bool live = tile * TILE + lane < r.h;
  const long long left = r.h - tile * TILE;
  const int width = left < TILE ? (int)left : TILE;  // live elements

  // 1. the constants and the staged columns
  for (int j = threadIdx.x; j < r.n_consts * 8; j += blockDim.x) {
    const int c = j >> 3, w = j & 7;
    cst[j] = ((uint32_t)__ldg(r.consts + 2 * w * r.n_consts + c) & 0xFFFFu) |
             ((uint32_t)__ldg(r.consts + (2 * w + 1) * r.n_consts + c) << 16);
  }
  // (column, live element) pairs over all the block's threads: a full
  // tile a column a warp, lanes along the elements; a short tile (the
  // last rounds) its few elements of every column side by side.  Lanes
  // past h are left as they are: no row result of theirs is read.
  for (int j = threadIdx.x; j < r.n_stage * width; j += blockDim.x) {
    const int c = j / width, e = j - c * width;
    const int s = __ldg(stage_src + c);
    const int k = s >> KIND_SHIFT;     // a select, not a local copy of r
    const Src q = k == 0 ? r.src[0] : k == 1 ? r.src[1]
                : k == 2 ? r.src[2] : r.src[3];
    const int32_t* p = q.base + (s & ((1 << KIND_SHIFT) - 1)) * q.cs +
                       (tile * TILE + e) * q.es;
    const jt::Fe lo = jt::load_limbs(p, q.ls);
    const jt::Fe hi = jt::load_limbs(p + r.h * q.es, q.ls);
    const jt::Fe diff = jt::fsub(hi, lo, F);
    put8(xs + c * COL_WORDS + e, TILE,
         first == 0   ? lo
         : first == 1 ? hi
                      : jt::fadd(lo, times(diff, first, F), F));
    put8(ds + c * COL_WORDS + e, TILE, times(diff, r.split, F));
  }

  // 2. the block's points
  const int pc0 = __ldg(r.meta + warp), pc1 = __ldg(r.meta + warp + 1);
  uint32_t* mine = slots + __ldg(bases + warp) * COL_WORDS;
  for (int t = first; t < r.points; t += r.split) {
    __syncthreads();               // the staged columns are x_t
    int4 next = __ldg(r.rows + pc0);   // each row fetched a row ahead
    for (int pc = pc0; pc < pc1; pc++) {
      const int4 row = next;
      if (pc + 1 < pc1) next = __ldg(r.rows + pc + 1);
      const jt::Fe x = operand(row.z, xs, cst, mine, lane);
      const jt::Fe y = operand(row.w, xs, cst, mine, lane);
      const jt::Fe z = row.x == 0   ? jt::ladd(x, y, F)
                       : row.x == 1 ? jt::lsub(x, y, F)
                                    : jt::lmul(x, y, F);
      put8(mine + row.y * COL_WORDS + lane, TILE, z);
    }
    __syncthreads();               // every group's partial sum is written
    const bool more = t + r.split < r.points;
    if (warp == 0) {
      jt::Fe inner = jt::fe_zero();
      for (int g = 0; g < r.groups; g++) {
        const uint32_t* part =
            slots + (__ldg(bases + g) + __ldg(outs + g)) * COL_WORDS + lane;
        inner = jt::fadd(inner, jt::reduce(get8(part, TILE), F), F);
      }
      jt::Fe term = jt::fe_zero();
      if (live)
        term = jt::fmul(get8(xs + lane, TILE),
                        jt::fsub(inner, get8(xs + COL_WORDS + lane, TILE), F),
                        F);
      term = jt::warp_sum(term, F);
      if (lane == 0)
        jt::put_words(r.partials + (t * r.tiles + tile) * 8, term);
    }
    // the step to the block's next point: eq and out (columns 0, 1) by
    // warp 0 once its finisher has read them, the other columns meanwhile
    // by the other warps (all by warp 0 when it is the only one)
    if (more) {
      const int others = r.groups - 1;
      const int c0 = warp == 0 ? 0 : 1 + warp;
      const int c1 = warp == 0 && others ? 2 : r.n_stage;
      for (int c = c0; c < c1; c += warp == 0 ? 1 : others) {
        uint32_t* x = xs + c * COL_WORDS + lane;
        put8(x, TILE, jt::fadd(get8(x, TILE),
                               get8(ds + c * COL_WORDS + lane, TILE), F));
      }
    }
  }

  // 3. the last block sums each point's partials over the tiles
  if (threadIdx.x == 0) {
    __threadfence();
    is_last = atomicAdd(r.counter, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (int q = warp; q < r.points; q += r.groups) {
    jt::Fe acc = jt::fe_zero();
    for (long long j = lane; j < r.tiles; j += 32)
      acc = jt::fadd(acc, jt::get_words(r.partials + (q * r.tiles + j) * 8),
                     F);
    acc = jt::warp_sum(acc, F);
    if (lane == 0) jt::store_limbs(r.out + q, r.points, acc);
  }
  if (threadIdx.x == 0) *r.counter = 0;
}

}  // namespace

// Shared memory of a round block (collation.py GroupPlan.smem_bytes):
// x_t and the step of each staged column, the slots, the constants.
__host__ __device__ constexpr long long round_smem_bytes(long long n_stage,
                                                         long long n_slots,
                                                         long long n_consts) {
  return 4 * ((2 * n_stage + n_slots) * 256 + n_consts * 8);
}

// The round.  eq, outs [16, 2h], flags [16, NI, 2h], E [16, m, 2h] by
// (limb, column, element) strides (the hi half at h element strides);
// rows int32 [n, 4] 16-byte aligned and meta as Round says (vm/
// collation.py GroupPlan.tables); consts int32 [16, n_consts]; partials
// points * tiles * 8 words; counter one word, 0; out [16, points].
extern "C" int jt_primary_round(
    const int32_t* eq, const int32_t* outs, const int32_t* flags,
    const int32_t* e, long long eq_ls, long long eq_cs, long long eq_es,
    long long o_ls, long long o_cs, long long o_es, long long f_ls,
    long long f_cs, long long f_es, long long e_ls, long long e_cs,
    long long e_es, long long h, long long points, long long split,
    const int32_t* rows, const int32_t* meta, const int32_t* consts,
    long long groups, long long n_stage, long long n_consts,
    long long n_slots, uint32_t* partials, unsigned int* counter,
    int32_t* out, const uint32_t* field, void* stream) {
  if (h < 1 || points < 1 || split < 1 || split > points || groups < 1 ||
      groups > MAX_GROUPS || n_stage < 2 || n_slots < 1 ||
      n_slots > MAX_SLOTS * groups || n_consts < 0 || !partials ||
      !counter || ((uintptr_t)rows & 15))
    return (int)cudaErrorInvalidValue;
  Round r;
  r.src[0] = Src{eq, eq_ls, eq_cs, eq_es};
  r.src[1] = Src{outs, o_ls, o_cs, o_es};
  r.src[2] = Src{flags, f_ls, f_cs, f_es};
  r.src[3] = Src{e, e_ls, e_cs, e_es};
  r.h = h;
  r.tiles = (h + TILE - 1) / TILE;
  r.points = (int)points;
  r.split = (int)split;
  r.rows = reinterpret_cast<const int4*>(rows);
  r.meta = meta;
  r.consts = consts;
  r.n_consts = (int)n_consts;
  r.groups = (int)groups;
  r.n_stage = (int)n_stage;
  r.n_slots = (int)n_slots;
  r.partials = partials;
  r.counter = counter;
  r.out = out;
  const long long smem = round_smem_bytes(n_stage, n_slots, n_consts);
  // past 48 KiB: opt in, up to the card's limit (the launch fails past
  // it), once per device and size: the attribute stays set, and setting
  // it waits for the device's queued work
  static long long opted[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (smem > 48 * 1024 && (dev >= 64 || smem > opted[dev])) {
    err = cudaFuncSetAttribute(primary_round_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) opted[dev] = smem;
  }
  const long long blocks = r.tiles * split;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  primary_round_kernel<<<(unsigned int)blocks, 32 * (int)groups, smem,
                         (cudaStream_t)stream>>>(r, jt::make_field(field));
  return (int)cudaGetLastError();
}
