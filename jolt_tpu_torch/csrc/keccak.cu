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
// a single 136-byte rate block (at most 132 message bytes), on 25 native
// uint64 lanes with rotations by __funnelshift_l.  An event either appends
// scalar i of a [16, M] Montgomery tensor (payload: its canonical value's
// 32 big-endian bytes, transcript.rs:97-105) or draws a challenge (empty
// payload; the digest read big-endian, reduced mod p and put in Montgomery
// form, transcript.rs:146-153).
//
// K9 `fs_round_kernel` is one sumcheck round's transcript block
// (fs_device.py `fs_round_plain`): the round polynomial's coefficients from
// its evaluations at 0..d through the inverse Vandermonde matrix (its
// Montgomery constants built once on the host per (field, d + 1)), the
// events UniPoly_begin, each coefficient but the linear one, UniPoly_end
// and the challenge, then the next claim by Horner at the challenge.
//
// Both are one thread: the work is a chain of dependent 64-bit bitwise ops
// (24 rounds per permutation) and field products, not a pass over many
// elements.  What bounds them is that chain's latency plus one launch; a
// launch replaces a host round trip (pull the evaluations, hash on the
// host, push the challenge) in the middle of every round.
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
constexpr int MAX_DEGREE = 8;    // K9's largest round degree: rv32i_vm()'s
                                 // primary sumcheck (max g degree 6, + 2)
constexpr int MAX_PTS = MAX_DEGREE + 1;

struct Segments {
  unsigned int kind[MAX_SEGS];   // 0: append scalars, 1: draw challenges
  unsigned int count[MAX_SEGS];
  int n;
};

struct Labels {
  uint32_t begin[8];             // b"UniPoly_begin", zero-padded to 32 bytes
  uint32_t end[8];               // b"UniPoly_end"
};

__device__ __forceinline__ uint64_t rotl64(uint64_t x, int r) {
  uint32_t lo = (uint32_t)x, hi = (uint32_t)(x >> 32);
  if (r >= 32) {
    const uint32_t t = lo;
    lo = hi;
    hi = t;
    r -= 32;
  }
  const uint32_t nhi = __funnelshift_l(lo, hi, r);
  const uint32_t nlo = __funnelshift_l(hi, lo, r);
  return ((uint64_t)nhi << 32) | nlo;
}

__constant__ uint64_t KECCAK_RC[24] = {
    0x0000000000000001ull, 0x0000000000008082ull, 0x800000000000808Aull,
    0x8000000080008000ull, 0x000000000000808Bull, 0x0000000080000001ull,
    0x8000000080008081ull, 0x8000000000008009ull, 0x000000000000008Aull,
    0x0000000000000088ull, 0x0000000080008009ull, 0x000000008000000Aull,
    0x000000008000808Bull, 0x800000000000008Bull, 0x8000000000008089ull,
    0x8000000000008003ull, 0x8000000000008002ull, 0x8000000000000080ull,
    0x000000000000800Aull, 0x800000008000000Aull, 0x8000000080008081ull,
    0x8000000000008080ull, 0x0000000080000001ull, 0x8000000080008008ull};

__device__ __forceinline__ void keccak_f(uint64_t a[25]) {
  // rho + pi walked as one cycle through the lanes (lane piln[i] takes the
  // previous lane rotated by rotc[i]; Keccak reference, "compact" form)
  constexpr int rotc[24] = {1,  3,  6,  10, 15, 21, 28, 36, 45, 55, 2,  14,
                            27, 41, 56, 8,  25, 43, 62, 18, 39, 61, 20, 44};
  constexpr int piln[24] = {10, 7,  11, 17, 18, 3, 5,  16, 8,  21, 24, 4,
                            15, 23, 19, 13, 12, 2, 20, 14, 22, 9,  6,  1};
#pragma unroll 1
  for (int round = 0; round < 24; round++) {
    uint64_t c[5];
#pragma unroll
    for (int x = 0; x < 5; x++)
      c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
#pragma unroll
    for (int x = 0; x < 5; x++) {
      const uint64_t d = c[(x + 4) % 5] ^ rotl64(c[(x + 1) % 5], 1);
#pragma unroll
      for (int y = 0; y < 25; y += 5) a[x + y] ^= d;
    }
    uint64_t t = a[1];
#pragma unroll
    for (int i = 0; i < 24; i++) {
      const uint64_t b = a[piln[i]];
      a[piln[i]] = rotl64(t, rotc[i]);
      t = b;
    }
#pragma unroll
    for (int y = 0; y < 25; y += 5) {
      uint64_t row[5];
#pragma unroll
      for (int x = 0; x < 5; x++) row[x] = a[y + x];
#pragma unroll
      for (int x = 0; x < 5; x++)
        a[y + x] = row[x] ^ (~row[(x + 1) % 5] & row[(x + 2) % 5]);
    }
    a[0] ^= KECCAK_RC[round];
  }
}

__device__ __forceinline__ uint32_t bswap32(uint32_t w) {
  return __byte_perm(w, 0, 0x0123);
}

// The transcript state in registers: eight LE words and the count.
struct State {
  uint32_t w[8];
  uint32_t n;
};

__device__ __forceinline__ State load_state(const long long* s) {
  State st;
#pragma unroll
  for (int k = 0; k < 8; k++) st.w[k] = (uint32_t)s[k];
  st.n = (uint32_t)s[8];
  return st;
}

__device__ __forceinline__ void store_state(long long* s, const State& st) {
#pragma unroll
  for (int k = 0; k < 8; k++) s[k] = (long long)st.w[k];
  s[8] = (long long)st.n;
}

// state <- keccak256(state || 0^28 || n_BE || payload), n += 1, for a
// payload of NPW words (0 or 8); every lane index is a constant, so the
// lanes stay in registers
template <int NPW>
__device__ __forceinline__ void event(State& st, const uint32_t* payload) {
  uint64_t a[25];
#pragma unroll
  for (int i = 0; i < 25; i++) a[i] = 0;
#pragma unroll
  for (int i = 0; i < 4; i++)
    a[i] = (uint64_t)st.w[2 * i] | ((uint64_t)st.w[2 * i + 1] << 32);
  // words 8..14 are zero; word 15 is the count, big-endian
  a[7] = (uint64_t)bswap32(st.n) << 32;
#pragma unroll
  for (int k = 0; k < NPW; k++)
    a[(16 + k) / 2] |= (uint64_t)payload[k] << (32 * ((16 + k) % 2));
  const int nw = 16 + NPW;               // pad: 0x01 at the message's end,
  a[nw / 2] ^= 1ull << (32 * (nw % 2));  // 0x80 at byte 135 (word 33)
  a[16] ^= 0x8000000000000000ull;
  keccak_f(a);
#pragma unroll
  for (int i = 0; i < 4; i++) {
    st.w[2 * i] = (uint32_t)a[i];
    st.w[2 * i + 1] = (uint32_t)(a[i] >> 32);
  }
  st.n += 1;
}

// append a scalar given in Montgomery form: its canonical value's BE bytes
__device__ __forceinline__ void append_scalar(State& st, const jt::Fe& x,
                                              const jt::Field& F) {
  jt::Fe one = jt::fe_zero();
  one.w[0] = 1;
  const jt::Fe v = jt::fmul(x, one, F);        // x R^-1: canonical, < p
  uint32_t payload[8];
#pragma unroll
  for (int k = 0; k < 8; k++) payload[k] = bswap32(v.w[7 - k]);
  event<8>(st, payload);
}

// draw a challenge: the digest read big-endian (any value below 2^256)
__device__ __forceinline__ jt::Fe challenge(State& st) {
  event<0>(st, nullptr);
  jt::Fe v;
#pragma unroll
  for (int k = 0; k < 8; k++) v.w[k] = bswap32(st.w[7 - k]);
  return v;
}

// v R mod p for any v < 2^256: r2 = R^2 mod p < p takes the a slot, whose
// bound (a < 2p) the CIOS sum needs; v takes the b slot (any b < R)
__device__ __forceinline__ jt::Fe to_mont(const jt::Fe& v, const jt::Fe& r2,
                                          const jt::Field& F) {
  return jt::fmul(r2, v, F);
}

__device__ __forceinline__ void message(State& st, const uint32_t* label) {
  event<8>(st, label);
}

__global__ void __launch_bounds__(1)
transcript_events_kernel(const long long* __restrict__ state_in,
                         long long* __restrict__ state_out,
                         const int32_t* __restrict__ scalars, long long s_ls,
                         long long s_es, int32_t* __restrict__ chals,
                         long long c_ls, Segments segs, jt::Fe r2,
                         jt::Field F) {
  State st = load_state(state_in);
  long long col = 0, nc = 0;
  for (int s = 0; s < segs.n; s++) {
    for (unsigned int e = 0; e < segs.count[s]; e++) {
      if (segs.kind[s] == 0) {
        append_scalar(st, jt::load_limbs(scalars + col * s_es, s_ls), F);
        col++;
      } else {
        const jt::Fe v = challenge(st);
        jt::store_limbs(chals + nc, c_ls, to_mont(v, r2, F));
        nc++;
      }
    }
  }
  store_state(state_out, st);
}

// evals: n_evals columns at limb stride e_ls (column j at +j): the round
// polynomial at t = 0..d, or with the hint and n_evals = d, at t = 0, 2..d
// (t = 1 is prev - e_0).  vinv: [16, npts^2] Montgomery limbs, row-major.
// Outputs: comp [16, d] (the coefficients but the linear one), rj [16],
// prev_out [16], state_out [9].
__global__ void __launch_bounds__(1)
fs_round_kernel(const int32_t* __restrict__ evals, long long e_ls,
                int n_evals, const int32_t* __restrict__ prev,
                const int32_t* __restrict__ vinv,
                const long long* __restrict__ state_in,
                long long* __restrict__ state_out, int32_t* __restrict__ comp,
                int32_t* __restrict__ rj_out, int32_t* __restrict__ prev_out,
                int degree, int use_hint, Labels labels, jt::Fe r2,
                jt::Field F) {
  const int npts = degree + 1;
  jt::Fe ev[MAX_PTS], co[MAX_PTS];
  const jt::Fe pv = jt::load_limbs(prev, 1);
  for (int t = 0, j = 0; t < npts; t++) {
    if (t == 1 && n_evals == degree) continue;   // the hinted evaluation
    ev[t] = jt::load_limbs(evals + j, e_ls);
    j++;
  }
  if (use_hint) ev[1] = jt::fsub(pv, ev[0], F);
  for (int r = 0; r < npts; r++) {
    jt::Fe acc = jt::fe_zero();
    for (int c = 0; c < npts; c++)
      acc = jt::fadd(acc,
                     jt::fmul(jt::load_limbs(vinv + r * npts + c,
                                             (long long)npts * npts),
                              ev[c], F),
                     F);
    co[r] = acc;
  }
  State st = load_state(state_in);
  message(st, labels.begin);
  for (int r = 0, j = 0; r < npts; r++) {
    if (r == 1) continue;                        // the linear coefficient
    append_scalar(st, co[r], F);
    jt::store_limbs(comp + j, degree, co[r]);
    j++;
  }
  message(st, labels.end);
  const jt::Fe rj = to_mont(challenge(st), r2, F);
  jt::Fe acc = co[degree];
  for (int r = degree - 1; r >= 0; r--)
    acc = jt::fadd(co[r], jt::fmul(rj, acc, F), F);
  jt::store_limbs(rj_out, 1, rj);
  jt::store_limbs(prev_out, 1, acc);
  store_state(state_out, st);
}

}  // namespace

// K8.  kinds/counts: nseg segments (host arrays, copied into the launch's
// parameters); scalars column i at scalars + i*s_es, limb stride s_ls;
// chals [16, c_ls] receives the challenges in order.
extern "C" int jt_transcript_events(const long long* state_in,
                                    long long* state_out,
                                    const int32_t* scalars, long long s_ls,
                                    long long s_es, int32_t* chals,
                                    long long c_ls, long long nseg,
                                    const uint32_t* kinds,
                                    const uint32_t* counts,
                                    const uint32_t* field, void* stream) {
  if (nseg < 1 || nseg > MAX_SEGS) return (int)cudaErrorInvalidValue;
  Segments segs;
  segs.n = (int)nseg;
  for (int s = 0; s < MAX_SEGS; s++) {
    segs.kind[s] = s < nseg ? kinds[s] : 0;
    segs.count[s] = s < nseg ? counts[s] : 0;
  }
  const jt::Field F = jt::make_field(field);
  jt::Fe r2;
  for (int k = 0; k < 8; k++) r2.w[k] = field[9 + k];
  transcript_events_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      state_in, state_out, scalars, s_ls, s_es, chals, c_ls, segs, r2, F);
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
  if (degree < 1 || degree > MAX_DEGREE ||
      !(n_evals == degree + 1 || (use_hint && n_evals == degree)))
    return (int)cudaErrorInvalidValue;
  Labels lab;
  for (int k = 0; k < 8; k++) {
    lab.begin[k] = labels[k];
    lab.end[k] = labels[8 + k];
  }
  const jt::Field F = jt::make_field(field);
  jt::Fe r2;
  for (int k = 0; k < 8; k++) r2.w[k] = field[9 + k];
  fs_round_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      evals, e_ls, (int)n_evals, prev, vinv, state_in, state_out, comp,
      rj_out, prev_out, (int)degree, (int)use_hint, lab, r2, F);
  return (int)cudaGetLastError();
}
