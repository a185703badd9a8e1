// K8 + K9: the Fiat-Shamir transcript on the card.
//
// Neither replaces a Pallas kernel.  On the TPU, jolt_tpu runs the
// transcript's Keccak (utils/keccak_device.py `transcript_event`, a
// lax.fori_loop over 24 rounds on lo/hi uint32 lane halves) and the fused
// sumcheck round (subprotocols/fs_device.py `fs_round_jit`) as jax.jit
// programs that XLA fuses into one program each.  Here each is one
// hand-written kernel: a Keccak-f in PyTorch ops would be some 700
// launches per permutation, and a round hashes 3 + d times.
//
// K8 `transcript_events_kernel` runs a list of transcript events:
//   event = keccak256(state(32) || 0^28 || n_rounds(u32 BE) || payload),
// a single 136-byte rate block (at most 132 message bytes).  An event
// either appends scalar i of a [16, M] Montgomery tensor (payload: its
// canonical value's 32 big-endian bytes, transcript.rs:97-105) or draws a
// challenge (empty payload; the digest read big-endian, reduced mod p and
// put in Montgomery form, transcript.rs:146-153).
//
// K9 `fs_round_kernel` is one sumcheck round's transcript block
// (fs_device.py `fs_round_plain`): the round polynomial's coefficients from
// its evaluations at 0..d through the inverse Vandermonde matrix (its
// Montgomery constants built once on the host per (field, d + 1)), the
// events UniPoly_begin, each coefficient but the linear one, UniPoly_end
// and the challenge, then the next claim by Horner at the challenge.
//
// What bounds them.  Each is one chain of Keccak-f[1600] permutations of
// 24 dependent rounds; nothing else of the work is long, and one block on
// one SM does all of it.  A permutation is about 5,040 32-bit bitwise
// operations in 168 dependent levels.  One thread issuing all of them
// (this kernel's first design: 4,884 SASS instructions, LOP3 and SHF on
// the INT32 pipe, which takes one warp instruction every other cycle) ran
// 5.11 us a permutation on an H100, and each event's field product (219
// instructions) sat on the same thread.  This design:
//   - One warp holds the state (keccak_f_warp): lane t = x + 5y keeps
//     state lane (x, y) as lo/hi 32-bit halves, so each lane issues a
//     25th of the bitwise work.  A round is three shuffle stages, 18
//     shuffles: theta's column parity C[x] from the four other lanes of
//     the column (8, then a LOP3 tree), C[x - 1] and C[x + 1] from the
//     neighbouring lanes (4), after which each lane applies theta and its
//     own rho rotation; pi and chi at once (6): each lane fetches
//     B[x .. x + 2, y] from the lanes that computed them, computes chi,
//     and lane (0, 0) adds iota.  Every shuffle takes the same register in
//     every lane; the sources are KF_TABLE, one 16-byte row per lane.
//     What bounds a round is the shuffles that one warp issues, not the
//     bitwise work (16 integer instructions a lane): a round takes about
//     160 cycles, and of the exchanges that scripts/probe_keccak.py times
//     beside this one, those with more shuffles are slower even with fewer
//     stages (PERF.md section 6).
//   - The field products leave the chain: K8's block converts every
//     appended scalar to its canonical bytes (phase A) and every digest to
//     Montgomery form (phase C), all threads in parallel, before and after
//     warp 0 runs the events (phase B).  K9's warps 1-3 run the (d + 1)^2
//     interpolation products, the row sums and the canonical forms while
//     warp 0 hashes UniPoly_begin, which needs none of them; only the
//     challenge's Montgomery form and Horner (d + 1 products) follow the
//     last permutation.
//   - One K8 launch per chained GKR layer (subprotocols/grand_product.py)
//     runs its claim appends, r_layer and the next layer's coefficients.
//
// The state tensor is int64 [9]: the state's eight little-endian 32-bit
// words, then the event count.  A field element lives in registers as
// field.cuh's eight words; limbs are read and written as int32 [16, ...].
//
// Reducing the digest: its value v may be anything below 2^256 (5.3 p for
// BN254 Fr).  mont_mul(a, b) is exact for a < 2p and any b < R (field.cuh:
// the CIOS sum stays below a + p), so v goes in the b slot against
// a = R^2 mod p < p: the product is v R mod p, reduced by the final
// subtraction.
#include "field.cuh"

namespace {

constexpr int MAX_SEGS = 16;     // segments of one K8 launch (keccak_device.py)
constexpr int K8_THREADS = 256;
constexpr int K9_THREADS = 128;  // warp 0 hashes; warps 1-3 take the
                                 // (d + 1)^2 interpolation products
constexpr int K9_STATIC_SMEM = 48 * 1024;  // dynamic shared memory a block
                                           // takes without opting in
constexpr int K8_SMEM_EVENTS = 512;  // events whose 8 words (payload or
                                     // digest) fit K8's shared memory;
                                     // more go to the caller's scratch

struct Segments {
  unsigned int kind[MAX_SEGS];   // 0: append scalars, 1: draw challenges
  unsigned int count[MAX_SEGS];
  int n;
};

struct Labels {
  uint32_t begin[8];             // b"UniPoly_begin", zero-padded to 32 bytes
  uint32_t end[8];               // b"UniPoly_end"
};

// Round constant r: with the rounds unrolled, an immediate operand of the
// instruction that adds it (a __constant__ table indexed in the unrolled
// rounds was hoisted into 48 registers ahead of K8's event loop).
__device__ __forceinline__ uint64_t keccak_rc(int r) {
  constexpr uint64_t KECCAK_RC[24] = {
      0x0000000000000001ull, 0x0000000000008082ull, 0x800000000000808Aull,
      0x8000000080008000ull, 0x000000000000808Bull, 0x0000000080000001ull,
      0x8000000080008081ull, 0x8000000000008009ull, 0x000000000000008Aull,
      0x0000000000000088ull, 0x0000000080008009ull, 0x000000008000000Aull,
      0x000000008000808Bull, 0x800000000000008Bull, 0x8000000000008089ull,
      0x8000000000008003ull, 0x8000000000008002ull, 0x8000000000000080ull,
      0x000000000000800Aull, 0x800000008000000Aull, 0x8000000080008081ull,
      0x8000000000008080ull, 0x0000000080000001ull, 0x8000000080008008ull};
  return KECCAK_RC[r];
}

// The warp's lane tables, one row per lane t = x + 5y (lanes 25-31 idle:
// they shuffle from themselves and hold nothing):
//   [0:4] theta: the lanes (x, y + j) of t's column, j = 1..4;
//   [4:6] theta: the lanes (x - 1, y) and (x + 1, y);
//   [6:9] pi and chi: the lane whose theta-and-rho output is B[x + j, y]
//         after pi (B[y, 2x + 3y] = A[x, y]), j = 0, 1, 2;
//   [9]   rho's rotation of state lane (x, y).
// tests/test_torch_fs_device.py runs a permutation and transcript events
// through these rows in numpy against keccak_f_plain and transcript_event.
__device__ const __align__(16) uint8_t KF_TABLE[32][16] = {
    { 5, 10, 15, 20,  4,  1,  0,  6, 12,  0,  0,  0,  0,  0,  0,  0},  // (0, 0)
    { 6, 11, 16, 21,  0,  2,  6, 12, 18,  1,  0,  0,  0,  0,  0,  0},  // (1, 0)
    { 7, 12, 17, 22,  1,  3, 12, 18, 24, 62,  0,  0,  0,  0,  0,  0},  // (2, 0)
    { 8, 13, 18, 23,  2,  4, 18, 24,  0, 28,  0,  0,  0,  0,  0,  0},  // (3, 0)
    { 9, 14, 19, 24,  3,  0, 24,  0,  6, 27,  0,  0,  0,  0,  0,  0},  // (4, 0)
    {10, 15, 20,  0,  9,  6,  3,  9, 10, 36,  0,  0,  0,  0,  0,  0},  // (0, 1)
    {11, 16, 21,  1,  5,  7,  9, 10, 16, 44,  0,  0,  0,  0,  0,  0},  // (1, 1)
    {12, 17, 22,  2,  6,  8, 10, 16, 22,  6,  0,  0,  0,  0,  0,  0},  // (2, 1)
    {13, 18, 23,  3,  7,  9, 16, 22,  3, 55,  0,  0,  0,  0,  0,  0},  // (3, 1)
    {14, 19, 24,  4,  8,  5, 22,  3,  9, 20,  0,  0,  0,  0,  0,  0},  // (4, 1)
    {15, 20,  0,  5, 14, 11,  1,  7, 13,  3,  0,  0,  0,  0,  0,  0},  // (0, 2)
    {16, 21,  1,  6, 10, 12,  7, 13, 19, 10,  0,  0,  0,  0,  0,  0},  // (1, 2)
    {17, 22,  2,  7, 11, 13, 13, 19, 20, 43,  0,  0,  0,  0,  0,  0},  // (2, 2)
    {18, 23,  3,  8, 12, 14, 19, 20,  1, 25,  0,  0,  0,  0,  0,  0},  // (3, 2)
    {19, 24,  4,  9, 13, 10, 20,  1,  7, 39,  0,  0,  0,  0,  0,  0},  // (4, 2)
    {20,  0,  5, 10, 19, 16,  4,  5, 11, 41,  0,  0,  0,  0,  0,  0},  // (0, 3)
    {21,  1,  6, 11, 15, 17,  5, 11, 17, 45,  0,  0,  0,  0,  0,  0},  // (1, 3)
    {22,  2,  7, 12, 16, 18, 11, 17, 23, 15,  0,  0,  0,  0,  0,  0},  // (2, 3)
    {23,  3,  8, 13, 17, 19, 17, 23,  4, 21,  0,  0,  0,  0,  0,  0},  // (3, 3)
    {24,  4,  9, 14, 18, 15, 23,  4,  5,  8,  0,  0,  0,  0,  0,  0},  // (4, 3)
    { 0,  5, 10, 15, 24, 21,  2,  8, 14, 18,  0,  0,  0,  0,  0,  0},  // (0, 4)
    { 1,  6, 11, 16, 20, 22,  8, 14, 15,  2,  0,  0,  0,  0,  0,  0},  // (1, 4)
    { 2,  7, 12, 17, 21, 23, 14, 15, 21, 61,  0,  0,  0,  0,  0,  0},  // (2, 4)
    { 3,  8, 13, 18, 22, 24, 15, 21,  2, 56,  0,  0,  0,  0,  0,  0},  // (3, 4)
    { 4,  9, 14, 19, 23, 20, 21,  2,  8, 14,  0,  0,  0,  0,  0,  0},  // (4, 4)
    {25, 25, 25, 25, 25, 25, 25, 25, 25,  0,  0,  0,  0,  0,  0,  0},  // idle
    {26, 26, 26, 26, 26, 26, 26, 26, 26,  0,  0,  0,  0,  0,  0,  0},  // idle
    {27, 27, 27, 27, 27, 27, 27, 27, 27,  0,  0,  0,  0,  0,  0,  0},  // idle
    {28, 28, 28, 28, 28, 28, 28, 28, 28,  0,  0,  0,  0,  0,  0,  0},  // idle
    {29, 29, 29, 29, 29, 29, 29, 29, 29,  0,  0,  0,  0,  0,  0,  0},  // idle
    {30, 30, 30, 30, 30, 30, 30, 30, 30,  0,  0,  0,  0,  0,  0,  0},  // idle
    {31, 31, 31, 31, 31, 31, 31, 31, 31,  0,  0,  0,  0,  0,  0,  0},  // idle
};

// One lane's row of KF_TABLE, read once per kernel (one 16-byte load).
struct KfLane {
  uint32_t column[4];
  uint32_t left, right;
  uint32_t chi[3];
  uint32_t rot;
  uint32_t swap;                 // rot >= 32: rho's halves trade places
  uint32_t iota;                 // all ones on lane (0, 0)
};

__device__ __forceinline__ KfLane kf_lane(int lane) {
  const uint4 row = __ldg(reinterpret_cast<const uint4*>(KF_TABLE[lane]));
  const uint32_t w[4] = {row.x, row.y, row.z, row.w};
  auto byte = [&](int i) { return (w[i / 4] >> (8 * (i % 4))) & 0xFFu; };
  KfLane T;
#pragma unroll
  for (int j = 0; j < 4; j++) T.column[j] = byte(j);
  T.left = byte(4);
  T.right = byte(5);
#pragma unroll
  for (int j = 0; j < 3; j++) T.chi[j] = byte(6 + j);
  T.rot = byte(9);
  T.swap = T.rot >= 32;
  T.iota = lane == 0 ? 0xFFFFFFFFu : 0u;
  return T;
}

// The warp's Keccak state: lane t holds state lane t as lo/hi halves.
struct KfState {
  uint32_t lo, hi;
};

// Keccak-f[1600] on the warp's state (see the note at the top): a round is
// three stages of shuffles, 18 in all.  Every lane of the warp must call
// it.
__device__ __forceinline__ void keccak_f_warp(KfState& s, const KfLane& T) {
  constexpr unsigned FULL = 0xFFFFFFFFu;
#pragma unroll
  for (int round = 0; round < 24; round++) {
    // theta: the column parity C[x] over the column's five lanes
    uint32_t v[4][2];
#pragma unroll
    for (int j = 0; j < 4; j++) {
      v[j][0] = __shfl_sync(FULL, s.lo, T.column[j]);
      v[j][1] = __shfl_sync(FULL, s.hi, T.column[j]);
    }
    const uint32_t cl = (s.lo ^ v[0][0] ^ v[1][0]) ^ (v[2][0] ^ v[3][0]);
    const uint32_t ch = (s.hi ^ v[0][1] ^ v[1][1]) ^ (v[2][1] ^ v[3][1]);
    // A[x, y] ^ C[x - 1] ^ rotl(C[x + 1], 1)
    const uint32_t ml = __shfl_sync(FULL, cl, T.left);
    const uint32_t mh = __shfl_sync(FULL, ch, T.left);
    const uint32_t pl = __shfl_sync(FULL, cl, T.right);
    const uint32_t ph = __shfl_sync(FULL, ch, T.right);
    const uint32_t al = s.lo ^ ml ^ __funnelshift_l(ph, pl, 1);
    const uint32_t ah = s.hi ^ mh ^ __funnelshift_l(pl, ph, 1);
    // rho: rotl by T.rot (the funnel shift takes it mod 32; the halves
    // trade places at 32 and above)
    const uint32_t P = __funnelshift_l(al, ah, T.rot);
    const uint32_t Q = __funnelshift_l(ah, al, T.rot);
    const uint32_t bh = T.swap ? Q : P, bl = T.swap ? P : Q;
    // pi and chi at once: b[j] = B[x + j, y]; iota on (0, 0)
    uint32_t cbl[3], cbh[3];
#pragma unroll
    for (int j = 0; j < 3; j++) {
      cbl[j] = __shfl_sync(FULL, bl, T.chi[j]);
      cbh[j] = __shfl_sync(FULL, bh, T.chi[j]);
    }
    const uint32_t rl = (uint32_t)keccak_rc(round);
    const uint32_t rh = (uint32_t)(keccak_rc(round) >> 32);
    s.lo = (cbl[0] ^ (rl & T.iota)) ^ (~cbl[1] & cbl[2]);
    s.hi = (cbh[0] ^ (rh & T.iota)) ^ (~cbh[1] & cbh[2]);
  }
}

__device__ __forceinline__ uint32_t bswap32(uint32_t w) {
  return __byte_perm(w, 0, 0x0123);
}

// The transcript state [9] into lanes 0-3 (words 0-7).
__device__ __forceinline__ KfState kf_load_state(const long long* st) {
  const int t = threadIdx.x & 31, i = t < 4 ? t : 0;
  KfState s;
  s.lo = t < 4 ? (uint32_t)st[2 * i] : 0u;
  s.hi = t < 4 ? (uint32_t)st[2 * i + 1] : 0u;
  return s;
}

// Lanes 0-3 hold the digest: its eight words.
__device__ __forceinline__ void kf_digest(const KfState& s, uint32_t* out) {
  const int t = threadIdx.x & 31;
  if (t < 4) {
    out[2 * t] = s.lo;
    out[2 * t + 1] = s.hi;
  }
}

__device__ __forceinline__ void kf_store_state(long long* st, const KfState& s,
                                               uint32_t n) {
  const int t = threadIdx.x & 31;
  if (t < 4) {
    st[2 * t] = (long long)s.lo;
    st[2 * t + 1] = (long long)s.hi;
  }
  if (t == 0) st[8] = (long long)n;
}

// Absorb the message of event n into lane t (state lane t): the previous
// digest stays in lanes 0-3 (words 0-7); word 15 (lane 7, high half) is
// the count, big-endian; the payload's eight words (null: none) are words
// 16-23 (lanes 8-11); the padding puts 0x01 at the message's end (word
// 16 + 8: lane 12, or word 16: lane 8) and 0x80 at byte 135 (lane 16, high
// half); every other word is zero.
__device__ __forceinline__ void kf_absorb(KfState& s, uint32_t n,
                                          const uint32_t* payload) {
  const uint32_t t = threadIdx.x & 31, pad = payload ? 12u : 8u;
  if (t >= 4) {
    s.lo = 0u;
    s.hi = 0u;
  }
  if (t == 7) s.hi = bswap32(n);
  if (payload && t - 8u < 4u) {
    s.lo = payload[2 * (t - 8)];
    s.hi = payload[2 * (t - 8) + 1];
  }
  if (t == pad) s.lo ^= 1u;
  if (t == 16) s.hi ^= 0x80000000u;
}

// x R^-1 (canonical, < p) as the 32 big-endian bytes' LE words
__device__ __forceinline__ void canonical_be(const jt::Fe& x,
                                             const jt::Field& F,
                                             uint32_t* out) {
  jt::Fe one = jt::fe_zero();
  one.w[0] = 1;
  const jt::Fe v = jt::fmul(x, one, F);
#pragma unroll
  for (int k = 0; k < 8; k++) out[k] = bswap32(v.w[7 - k]);
}

// A digest's eight words (read big-endian, any value below 2^256) -> v R
// mod p: r2 = R^2 mod p < p takes the a slot, whose bound (a < 2p) the
// CIOS sum needs; v takes the b slot (any b < R)
__device__ __forceinline__ jt::Fe digest_to_mont(const uint32_t* d,
                                                 const jt::Fe& r2,
                                                 const jt::Field& F) {
  jt::Fe v;
#pragma unroll
  for (int k = 0; k < 8; k++) v.w[k] = bswap32(d[7 - k]);
  return jt::fmul(r2, v, F);
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// Both kernels are one block.  With minBlocksPerSM = 1 in their launch
// bounds, ptxas gives a stage's shuffles registers of their own and issues
// them back to back; without it, it reused one register across K8's theta
// shuffles and serialised them.
//
// K8's scratch: 8 words per event when the events outnumber
// K8_SMEM_EVENTS (the caller allocates it), else unused.
__global__ void __launch_bounds__(K8_THREADS, 1)
transcript_events_kernel(const long long* __restrict__ state_in,
                         long long* __restrict__ state_out,
                         const int32_t* __restrict__ scalars, long long s_ls,
                         long long s_es, int32_t* __restrict__ chals,
                         long long c_ls, uint32_t* scratch, Segments segs,
                         jt::Fe r2, jt::Field F) {
  __shared__ uint32_t smem[K8_SMEM_EVENTS * 8];
  int n_app = 0, n_chal = 0;
  for (int s = 0; s < segs.n; s++)
    (segs.kind[s] == 0 ? n_app : n_chal) += (int)segs.count[s];
  uint32_t* pay = n_app + n_chal <= K8_SMEM_EVENTS ? smem : scratch;
  uint32_t* dig = pay + 8 * n_app;
  // phase A: every appended scalar's payload, one product per thread
  for (int i = threadIdx.x; i < n_app; i += K8_THREADS)
    canonical_be(jt::load_limbs(scalars + i * s_es, s_ls), F, pay + 8 * i);
  __syncthreads();
  // phase B: warp 0 runs the events in order
  if (threadIdx.x < 32) {
    const KfLane T = kf_lane(threadIdx.x);
    KfState st = kf_load_state(state_in);
    uint32_t n = (uint32_t)state_in[8];
    int col = 0, nc = 0;
    for (int s = 0; s < segs.n; s++) {
      const bool app = segs.kind[s] == 0;
      for (unsigned int e = 0; e < segs.count[s]; e++) {
        kf_absorb(st, n, app ? pay + 8 * col : nullptr);
        keccak_f_warp(st, T);
        n++;
        if (app) {
          col++;
        } else {
          kf_digest(st, dig + 8 * nc);
          nc++;
        }
      }
    }
    kf_store_state(state_out, st, n);
  }
  __syncthreads();
  // phase C: every challenge's Montgomery form, one product per thread
  for (int c = threadIdx.x; c < n_chal; c += K8_THREADS)
    jt::store_limbs(chals + c, c_ls, digest_to_mont(dig + 8 * c, r2, F));
}

// K9's dynamic shared memory at degree d, in bytes: the (d + 1)^2
// products and d + 1 coefficients (32-byte field elements), then the
// d + 2 messages of 8 words (fs_device.py k9_smem_bytes mirrors it).
__host__ __device__ constexpr long long k9_smem_bytes(long long degree) {
  return ((degree + 1) * (degree + 1) + (degree + 1)) * 32 +
         (degree + 2) * 32;
}

// evals: n_evals columns at limb stride e_ls (column j at +j): the round
// polynomial at t = 0..d, or with the hint and n_evals = d, at t = 0, 2..d
// (t = 1 is prev - e_0).  vinv: [16, npts^2] Montgomery limbs, row-major.
// Outputs: comp [16, d] (the coefficients but the linear one), rj [16],
// prev_out [16], state_out [9].  Any degree d >= 1: the buffers are sized
// from d at launch (k9_smem_bytes), and warps 1-3 loop over the products.
__global__ void __launch_bounds__(K9_THREADS, 1)
fs_round_kernel(const int32_t* __restrict__ evals, long long e_ls,
                int n_evals, const int32_t* __restrict__ prev,
                const int32_t* __restrict__ vinv,
                const long long* __restrict__ state_in,
                long long* __restrict__ state_out, int32_t* __restrict__ comp,
                int32_t* __restrict__ rj_out, int32_t* __restrict__ prev_out,
                int degree, int use_hint, Labels labels, jt::Fe r2,
                jt::Field F) {
  extern __shared__ __align__(16) unsigned char k9_smem[];
  const int npts = degree + 1, tid = threadIdx.x;
  jt::Fe* prod = reinterpret_cast<jt::Fe*>(k9_smem);       // [npts^2]
  jt::Fe* co = prod + npts * npts;                          // [npts]
  // the messages in order: UniPoly_begin, the d payloads, UniPoly_end,
  // 8 words each
  uint32_t* msg = reinterpret_cast<uint32_t*>(co + npts);   // [d + 2][8]
  __shared__ uint32_t dig[8];
  KfLane T;
  KfState st;
  uint32_t n = 0;
  if (tid < 32) {
    T = kf_lane(tid);
    st = kf_load_state(state_in);
    n = (uint32_t)state_in[8];
    if (tid < 8) {
      msg[tid] = labels.begin[tid];
      msg[8 * (degree + 1) + tid] = labels.end[tid];
    }
    __syncwarp();
  } else {
    // warps 1-3: product j = r npts + c is V^-1[r][c] e_c
    for (int j = tid - 32; j < npts * npts; j += K9_THREADS - 32) {
      const int c = j % npts;
      jt::Fe ev;
      if (use_hint && c == 1)
        ev = jt::fsub(jt::load_limbs(prev, 1), jt::load_limbs(evals, e_ls),
                      F);
      else
        ev = jt::load_limbs(evals + (c >= 2 && n_evals == degree ? c - 1 : c),
                            e_ls);
      prod[j] = jt::fmul(jt::load_limbs(vinv + j, (long long)npts * npts),
                         ev, F);
    }
    bar_sync(1, K9_THREADS - 32);
    for (int j = tid - 32; j < npts; j += K9_THREADS - 32) {
      jt::Fe acc = prod[j * npts];   // coefficient j: its row's sum
      for (int c = 1; c < npts; c++)
        acc = jt::fadd(acc, prod[j * npts + c], F);
      co[j] = acc;
      if (j != 1) {              // appended, in order, but the linear one
        const int a = j == 0 ? 0 : j - 1;
        jt::store_limbs(comp + a, degree, acc);
        canonical_be(acc, F, msg + 8 * (1 + a));
      }
    }
  }
  // warp 0: UniPoly_begin (beside the products), the d appends,
  // UniPoly_end, the challenge
  for (int e = 0; e < degree + 3; e++) {
    if (e == 1) __syncthreads();
    if (tid < 32) {
      kf_absorb(st, n, e <= degree + 1 ? msg + 8 * e : nullptr);
      keccak_f_warp(st, T);
      n++;
    }
  }
  if (tid < 32) {
    kf_digest(st, dig);
    __syncwarp();
    kf_store_state(state_out, st, n);
    if (tid == 0) {
      const jt::Fe rj = digest_to_mont(dig, r2, F);
      jt::Fe acc = co[degree];
      for (int r = degree - 1; r >= 0; r--)
        acc = jt::fadd(co[r], jt::fmul(rj, acc, F), F);
      jt::store_limbs(rj_out, 1, rj);
      jt::store_limbs(prev_out, 1, acc);
    }
  }
}

}  // namespace

// K8.  kinds/counts: nseg segments (host arrays, copied into the launch's
// parameters); scalars column i at scalars + i*s_es, limb stride s_ls;
// chals [16, c_ls] receives the challenges in order; scratch: 8 words per
// event, needed when there are more than K8_SMEM_EVENTS events.
extern "C" int jt_transcript_events(const long long* state_in,
                                    long long* state_out,
                                    const int32_t* scalars, long long s_ls,
                                    long long s_es, int32_t* chals,
                                    long long c_ls, uint32_t* scratch,
                                    long long nseg, const uint32_t* kinds,
                                    const uint32_t* counts,
                                    const uint32_t* field, void* stream) {
  if (nseg < 1 || nseg > MAX_SEGS) return (int)cudaErrorInvalidValue;
  Segments segs;
  segs.n = (int)nseg;
  long long events = 0;
  for (int s = 0; s < MAX_SEGS; s++) {
    segs.kind[s] = s < nseg ? kinds[s] : 0;
    segs.count[s] = s < nseg ? counts[s] : 0;
    events += segs.count[s];
  }
  if (events > K8_SMEM_EVENTS && scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  const jt::Field F = jt::make_field(field);
  jt::Fe r2;
  for (int k = 0; k < 8; k++) r2.w[k] = field[9 + k];
  transcript_events_kernel<<<1, K8_THREADS, 0, (cudaStream_t)stream>>>(
      state_in, state_out, scalars, s_ls, s_es, chals, c_ls, scratch, segs,
      r2, F);
  return (int)cudaGetLastError();
}

// K9.  labels: the two label payloads' 16 words; field: FieldSpec
// words32() then R^2 mod p's eight words.
extern "C" int jt_fs_round(const int32_t* evals, long long e_ls,
                           long long n_evals, const int32_t* prev,
                           const int32_t* vinv, const long long* state_in,
                           long long* state_out, int32_t* comp,
                           int32_t* rj_out, int32_t* prev_out,
                           long long degree, long long use_hint,
                           const uint32_t* labels, const uint32_t* field,
                           void* stream) {
  if (degree < 1 ||
      !(n_evals == degree + 1 || (use_hint && n_evals == degree)))
    return (int)cudaErrorInvalidValue;
  const long long smem = k9_smem_bytes(degree);
  if (smem > K9_STATIC_SMEM) {   // past 48 KiB (a degree above 37): opt in,
                                 // up to the card's limit
    cudaError_t e = cudaFuncSetAttribute(
        fs_round_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  Labels lab;
  for (int k = 0; k < 8; k++) {
    lab.begin[k] = labels[k];
    lab.end[k] = labels[8 + k];
  }
  const jt::Field F = jt::make_field(field);
  jt::Fe r2;
  for (int k = 0; k < 8; k++) r2.w[k] = field[9 + k];
  fs_round_kernel<<<1, K9_THREADS, (size_t)smem, (cudaStream_t)stream>>>(
      evals, e_ls, (int)n_evals, prev, vinv, state_in, state_out, comp,
      rj_out, prev_out, (int)degree, (int)use_hint, lab, r2, F);
  return (int)cudaGetLastError();
}

// The dynamic shared memory one K9 block may take on the current device
// (the opt-in limit); fs_device.py refuses a degree whose k9_smem_bytes
// exceed it, naming the degree.
extern "C" int jt_fs_round_max_smem(long long* out) {
  int dev = 0, v = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  *out = v;
  return (int)e;
}
