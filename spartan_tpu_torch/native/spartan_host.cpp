// spartan_host — native host runtime of spartan_tpu_torch, a copy of the
// JAX package's native/spartan_host.cpp, so the port builds its own library
// (spartan_tpu_torch/host/native.py, into spartan_tpu_torch/build/host/).
//
// TPU-native equivalent of the reference's host-side Rust support code:
// the Blake2s Fiat–Shamir RNG (linear-sumcheck Blake2s512Rng, reference use
// src/lib.rs:28,61-65) and the hot parts of arkworks-style canonical
// serialization (the FS transcript absorbs the ENTIRE serialized A/B/C
// matrices up front — src/lib.rs:62-64 — which is O(nnz) bytes; building
// those bytes in a Python loop dominates host time for large circuits).
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this image).
// Semantics are bit-identical to spartan_tpu_torch/utils/{transcript,
// serialize}.py; tests cross-check the two.
//
// Build: g++ -O3 -shared -fPIC -o libspartan_host.so spartan_host.cpp

#include <cstdint>
#include <cstring>
#include <cstdlib>

// ---------------------------------------------------------------------------
// Blake2s (RFC 7693), minimal one-shot implementation
// ---------------------------------------------------------------------------

namespace {

static const uint32_t BLAKE2S_IV[8] = {
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
};

static const uint8_t SIGMA[10][16] = {
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
    {11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4},
    {7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8},
    {9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13},
    {2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9},
    {12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11},
    {13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10},
    {6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5},
    {10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0},
};

struct Blake2sState {
  uint32_t h[8];
  uint8_t buf[64];
  size_t buflen;
  uint64_t t;
};

static inline uint32_t rotr32(uint32_t x, int n) {
  return (x >> n) | (x << (32 - n));
}

static void blake2s_compress(Blake2sState* S, const uint8_t block[64],
                             bool last) {
  uint32_t m[16], v[16];
  for (int i = 0; i < 16; i++) {
    m[i] = (uint32_t)block[4 * i] | ((uint32_t)block[4 * i + 1] << 8) |
           ((uint32_t)block[4 * i + 2] << 16) |
           ((uint32_t)block[4 * i + 3] << 24);
  }
  for (int i = 0; i < 8; i++) v[i] = S->h[i];
  for (int i = 0; i < 8; i++) v[8 + i] = BLAKE2S_IV[i];
  v[12] ^= (uint32_t)(S->t & 0xFFFFFFFF);
  v[13] ^= (uint32_t)(S->t >> 32);
  if (last) v[14] = ~v[14];

#define G(r, i, a, b, c, d)                 \
  do {                                      \
    a = a + b + m[SIGMA[r][2 * i]];         \
    d = rotr32(d ^ a, 16);                  \
    c = c + d;                              \
    b = rotr32(b ^ c, 12);                  \
    a = a + b + m[SIGMA[r][2 * i + 1]];     \
    d = rotr32(d ^ a, 8);                   \
    c = c + d;                              \
    b = rotr32(b ^ c, 7);                   \
  } while (0)

  for (int r = 0; r < 10; r++) {
    G(r, 0, v[0], v[4], v[8], v[12]);
    G(r, 1, v[1], v[5], v[9], v[13]);
    G(r, 2, v[2], v[6], v[10], v[14]);
    G(r, 3, v[3], v[7], v[11], v[15]);
    G(r, 4, v[0], v[5], v[10], v[15]);
    G(r, 5, v[1], v[6], v[11], v[12]);
    G(r, 6, v[2], v[7], v[8], v[13]);
    G(r, 7, v[3], v[4], v[9], v[14]);
  }
#undef G
  for (int i = 0; i < 8; i++) S->h[i] ^= v[i] ^ v[8 + i];
}

static void blake2s_init(Blake2sState* S) {
  memset(S, 0, sizeof(*S));
  for (int i = 0; i < 8; i++) S->h[i] = BLAKE2S_IV[i];
  // parameter block: digest_length=32, fanout=1, depth=1
  S->h[0] ^= 0x01010000 ^ 32;
}

static void blake2s_update(Blake2sState* S, const uint8_t* in, size_t len) {
  while (len > 0) {
    if (S->buflen == 64) {
      S->t += 64;
      blake2s_compress(S, S->buf, false);
      S->buflen = 0;
    }
    size_t take = 64 - S->buflen;
    if (take > len) take = len;
    memcpy(S->buf + S->buflen, in, take);
    S->buflen += take;
    in += take;
    len -= take;
  }
}

static void blake2s_final(Blake2sState* S, uint8_t out[32]) {
  S->t += S->buflen;
  memset(S->buf + S->buflen, 0, 64 - S->buflen);
  blake2s_compress(S, S->buf, true);
  for (int i = 0; i < 8; i++) {
    out[4 * i] = (uint8_t)(S->h[i]);
    out[4 * i + 1] = (uint8_t)(S->h[i] >> 8);
    out[4 * i + 2] = (uint8_t)(S->h[i] >> 16);
    out[4 * i + 3] = (uint8_t)(S->h[i] >> 24);
  }
}

static void blake2s(const uint8_t* in, size_t len, uint8_t out[32]) {
  Blake2sState S;
  blake2s_init(&S);
  blake2s_update(&S, in, len);
  blake2s_final(&S, out);
}

}  // namespace

extern "C" {

// one-shot blake2s-256
void spartan_blake2s(const uint8_t* in, uint64_t len, uint8_t* out32) {
  blake2s(in, len, out32);
}

// ---------------------------------------------------------------------------
// Fiat–Shamir transcript RNG (chain construction; see utils/transcript.py)
//   state <- blake2s("")            setup
//   state <- blake2s(state||bytes)  feed
//   block_k = blake2s(state||LE64(k))
// ---------------------------------------------------------------------------

struct FsRng {
  uint8_t state[32];
  uint64_t counter;
  uint8_t buffer[32];
  size_t avail;  // bytes available at buffer end
};

void* spartan_fs_new() {
  FsRng* r = (FsRng*)calloc(1, sizeof(FsRng));
  blake2s(nullptr, 0, r->state);
  return r;
}

void spartan_fs_free(void* p) { free(p); }

void spartan_fs_feed(void* p, const uint8_t* data, uint64_t len) {
  FsRng* r = (FsRng*)p;
  Blake2sState S;
  blake2s_init(&S);
  blake2s_update(&S, r->state, 32);
  blake2s_update(&S, data, len);
  blake2s_final(&S, r->state);
  r->counter = 0;
  r->avail = 0;
}

// Overwrite the chain state (device-resident transcript handoff: the fused
// on-device sumcheck phase advances the transcript and returns its final
// 32-byte state; the host resumes from it). Resets the output stream.
void spartan_fs_set_state(void* p, const uint8_t* state32) {
  FsRng* r = (FsRng*)p;
  memcpy(r->state, state32, 32);
  r->counter = 0;
  r->avail = 0;
}

void spartan_fs_get_state(void* p, uint8_t* out32) {
  memcpy(out32, ((FsRng*)p)->state, 32);
}

void spartan_fs_next_bytes(void* p, uint8_t* out, uint64_t n) {
  FsRng* r = (FsRng*)p;
  while (n > 0) {
    if (r->avail == 0) {
      uint8_t input[40];
      memcpy(input, r->state, 32);
      for (int i = 0; i < 8; i++)
        input[32 + i] = (uint8_t)(r->counter >> (8 * i));
      blake2s(input, 40, r->buffer);
      r->counter++;
      r->avail = 32;
    }
    size_t off = 32 - r->avail;
    size_t take = r->avail < n ? r->avail : (size_t)n;
    memcpy(out, r->buffer + off, take);
    out += take;
    n -= take;
    r->avail -= take;
  }
}

// ---------------------------------------------------------------------------
// Matrix serialization (arkworks layout; see utils/serialize.py ser_matrix)
//   Vec<Vec<(Fr, usize)>>: u64 rows; per row u64 len; per entry 32B LE + u64.
// Inputs are flat arrays: per-row counts, and per-entry (32-byte coeff, u64
// col) already in canonical LE form.
// Returns bytes written; call with out=null to query size.
// ---------------------------------------------------------------------------

uint64_t spartan_ser_matrix(const uint64_t* row_counts, uint64_t n_rows,
                            const uint8_t* coeffs32, const uint64_t* cols,
                            uint64_t nnz, uint8_t* out) {
  uint64_t size = 8 + 8 * n_rows + nnz * 40;
  if (!out) return size;
  uint8_t* p = out;
  auto put_u64 = [&p](uint64_t v) {
    for (int i = 0; i < 8; i++) *p++ = (uint8_t)(v >> (8 * i));
  };
  put_u64(n_rows);
  uint64_t e = 0;
  for (uint64_t r = 0; r < n_rows; r++) {
    put_u64(row_counts[r]);
    for (uint64_t j = 0; j < row_counts[r]; j++, e++) {
      memcpy(p, coeffs32 + 32 * e, 32);
      p += 32;
      put_u64(cols[e]);
    }
  }
  return (uint64_t)(p - out);
}

}  // extern "C"
