// Keccak-256 (original 0x01 padding, Ethereum-style): the host hash of the
// Fiat-Shamir transcript (transcript.rs:8-210 semantics).
//
// A copy of jolt_tpu's native Keccak for the PyTorch port.  The verifier
// replays the whole transcript on the host (about 19k hashes for a
// sha2-chain(13) proof), which the pure-Python permutation
// (utils/keccak.py keccak256_py) takes seconds for.  Bit-exact against
// keccak256_py and fixtures/transcript_vectors.json
// (tests/test_torch_guests.py).
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -o libjolt_keccak.so keccak.cpp
#include <cstdint>
#include <cstring>

static const uint64_t RC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808AULL,
    0x8000000080008000ULL, 0x000000000000808BULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008AULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000AULL,
    0x000000008000808BULL, 0x800000000000008BULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800AULL, 0x800000008000000AULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL};

static const int ROT[5][5] = {{0, 36, 3, 41, 18},
                              {1, 44, 10, 45, 2},
                              {62, 6, 43, 15, 61},
                              {28, 55, 25, 21, 56},
                              {27, 20, 39, 8, 14}};

static inline uint64_t rol(uint64_t x, int n) {
  n &= 63;
  return n ? (x << n) | (x >> (64 - n)) : x;
}

static void keccak_f(uint64_t st[25]) {
  for (int r = 0; r < 24; r++) {
    uint64_t c[5], d[5], b[25];
    for (int x = 0; x < 5; x++)
      c[x] = st[x] ^ st[x + 5] ^ st[x + 10] ^ st[x + 15] ^ st[x + 20];
    for (int x = 0; x < 5; x++)
      d[x] = c[(x + 4) % 5] ^ rol(c[(x + 1) % 5], 1);
    for (int x = 0; x < 5; x++)
      for (int y = 0; y < 5; y++) st[x + 5 * y] ^= d[x];
    for (int x = 0; x < 5; x++)
      for (int y = 0; y < 5; y++)
        b[y + 5 * ((2 * x + 3 * y) % 5)] = rol(st[x + 5 * y], ROT[x][y]);
    for (int x = 0; x < 5; x++)
      for (int y = 0; y < 5; y++)
        st[x + 5 * y] = b[x + 5 * y] ^ ((~b[(x + 1) % 5 + 5 * y]) &
                                        b[(x + 2) % 5 + 5 * y]);
    st[0] ^= RC[r];
  }
}

extern "C" {

// out: 32 bytes.
void jolt_keccak256(const uint8_t* data, uint64_t len, uint8_t* out) {
  const uint64_t RATE = 136;
  uint64_t st[25];
  std::memset(st, 0, sizeof(st));
  uint64_t off = 0;
  // full blocks
  while (len - off >= RATE) {
    for (int i = 0; i < 17; i++) {
      uint64_t lane;
      std::memcpy(&lane, data + off + 8 * i, 8);  // little-endian host
      st[i] ^= lane;
    }
    keccak_f(st);
    off += RATE;
  }
  // final (padded) block: 0x01 ... 0x80 (merged 0x81 when one byte left)
  uint8_t block[136];
  uint64_t rem = len - off;
  std::memset(block, 0, RATE);
  std::memcpy(block, data + off, rem);
  block[rem] ^= 0x01;
  block[RATE - 1] ^= 0x80;
  for (int i = 0; i < 17; i++) {
    uint64_t lane;
    std::memcpy(&lane, block + 8 * i, 8);
    st[i] ^= lane;
  }
  keccak_f(st);
  std::memcpy(out, st, 32);
}

}
