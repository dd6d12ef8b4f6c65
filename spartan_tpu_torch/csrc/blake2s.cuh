// Blake2s-256 (digest 32 bytes, no key) of word-aligned messages, and the
// Fiat-Shamir stream's Fr sampler, for one thread: the Blake2s of the
// transcript step (fs.cuh) and of the yardstick blake2s_batch.
//
// Replaces spartan_tpu/ops/blake2s.py: blake2s_words (:120), which the JAX
// package runs as vectorised uint32 ops inside its fused sumcheck programs,
// and the sampler of spartan_tpu/ops/fs_device.py (fs_sample_fr :108).
// Words are little-endian within a word, as the transcript serializes.
//
// What bounds it: one compression is a chain of 240 dependent 32-bit
// instructions (10 rounds, a column and a diagonal step each, 12 a G mix:
// two three-input adds, two adds, four xors, four rotates) and about 1,000
// instructions in all, which one thread issues; on the H100 a compression
// takes about 1,660 cycles, 0.84 us (PERF.md). The rounds are written
// out with the message schedule as literal indices, so the 16 message words
// stay in registers (a table of the schedule would index them at run time,
// through local memory); the four G mixes of a column or diagonal step are
// independent instructions that the compiler interleaves; a rotate is one
// instruction (PRMT for 16 and 8, SHF.R.W for 12 and 7) and a + b + m one
// IADD3.
#pragma once

#include <cstdint>

namespace b2s {

__device__ __forceinline__ uint32_t rot16(uint32_t x) { return __byte_perm(x, x, 0x1032); }
__device__ __forceinline__ uint32_t rot8(uint32_t x) { return __byte_perm(x, x, 0x0321); }
__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) { return __funnelshift_r(x, x, n); }

__device__ __forceinline__ uint32_t iv(int i) {
  switch (i) {
    case 0: return 0x6a09e667u; case 1: return 0xbb67ae85u;
    case 2: return 0x3c6ef372u; case 3: return 0xa54ff53au;
    case 4: return 0x510e527fu; case 5: return 0x9b05688cu;
    case 6: return 0x1f83d9abu; default: return 0x5be0cd19u;
  }
}

#define SPK_B2S_G(a, b, c, d, x, y) \
  a = a + b + (x); d = rot16(d ^ a); c = c + d; b = rotr(b ^ c, 12); \
  a = a + b + (y); d = rot8(d ^ a);  c = c + d; b = rotr(b ^ c, 7);
#define SPK_B2S_ROUND(s0, s1, s2, s3, s4, s5, s6, s7, s8, s9, s10, s11, s12, s13, s14, s15) \
  SPK_B2S_G(v0, v4, v8, v12, m[s0], m[s1]) SPK_B2S_G(v1, v5, v9, v13, m[s2], m[s3])           \
  SPK_B2S_G(v2, v6, v10, v14, m[s4], m[s5]) SPK_B2S_G(v3, v7, v11, v15, m[s6], m[s7])         \
  SPK_B2S_G(v0, v5, v10, v15, m[s8], m[s9]) SPK_B2S_G(v1, v6, v11, v12, m[s10], m[s11])       \
  SPK_B2S_G(v2, v7, v8, v13, m[s12], m[s13]) SPK_B2S_G(v3, v4, v9, v14, m[s14], m[s15])

struct Words8 {
  uint32_t v[8];
};
struct Words16 {
  uint32_t v[16];
};

// One compression of the message block m into h: t is the byte count so far
// (messages below 4 GiB), last the final-block flag. One function, not
// inlined at its call sites (the absorb's, the sampler's): a round runs each
// once or a few times, and a copy is about 16 KB of code (PERF.md).
static __device__ __noinline__ Words8 compress_fn(Words8 hh, Words16 mm, uint32_t t, bool last) {
  const uint32_t* m = mm.v;
  uint32_t v0 = hh.v[0], v1 = hh.v[1], v2 = hh.v[2], v3 = hh.v[3], v4 = hh.v[4], v5 = hh.v[5], v6 = hh.v[6];
  uint32_t v7 = hh.v[7], v8 = iv(0), v9 = iv(1), v10 = iv(2), v11 = iv(3);
  uint32_t v12 = iv(4) ^ t, v13 = iv(5), v14 = last ? ~iv(6) : iv(6), v15 = iv(7);
  SPK_B2S_ROUND(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
  SPK_B2S_ROUND(14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3)
  SPK_B2S_ROUND(11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4)
  SPK_B2S_ROUND(7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8)
  SPK_B2S_ROUND(9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13)
  SPK_B2S_ROUND(2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9)
  SPK_B2S_ROUND(12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11)
  SPK_B2S_ROUND(13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10)
  SPK_B2S_ROUND(6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5)
  SPK_B2S_ROUND(10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0)
  hh.v[0] ^= v0 ^ v8;  hh.v[1] ^= v1 ^ v9;  hh.v[2] ^= v2 ^ v10; hh.v[3] ^= v3 ^ v11;
  hh.v[4] ^= v4 ^ v12; hh.v[5] ^= v5 ^ v13; hh.v[6] ^= v6 ^ v14; hh.v[7] ^= v7 ^ v15;
  return hh;
}

__device__ __forceinline__ void compress(uint32_t h[8], const uint32_t m[16], uint32_t t, bool last) {
  Words8 hh;
  Words16 mm;
#pragma unroll
  for (int i = 0; i < 8; ++i) hh.v[i] = h[i];
#pragma unroll
  for (int i = 0; i < 16; ++i) mm.v[i] = m[i];
  hh = compress_fn(hh, mm, t, last);
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] = hh.v[i];
}
#undef SPK_B2S_ROUND
#undef SPK_B2S_G

// out = blake2s of the nwords words at msg (byte length 4 nwords). The last
// block is zero-padded and takes the final flag, also when it is full; an
// empty message is one zero block.
__device__ __forceinline__ void hash_words(const uint32_t* msg, int nwords, uint32_t out[8]) {
  uint32_t h[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] = iv(i);
  h[0] ^= 0x01010020u;  // digest length 32, fanout 1, depth 1
  const int nblocks = nwords > 0 ? (nwords + 15) / 16 : 1;
  uint32_t m[16];
  for (int k = 0; k < nblocks; ++k) {
    const bool last = k == nblocks - 1;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int w = 16 * k + j;
      m[j] = w < nwords ? msg[w] : 0u;
    }
    compress(h, m, last ? 4u * (uint32_t)nwords : 64u * (uint32_t)(k + 1), last);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = h[i];
}

// Block `counter` of the output stream of `state`: blake2s(state || LE64),
// one final compression of 40 bytes, the block built in registers.
__device__ __forceinline__ void stream_block(const uint32_t state[8], uint32_t counter, uint32_t out[8]) {
  uint32_t m[16];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = state[i];
    out[i] = iv(i);
  }
  m[8] = counter;
#pragma unroll
  for (int i = 9; i < 16; ++i) m[i] = 0u;
  out[0] ^= 0x01010020u;
  compress(out, m, 40u, true);
}

// One uniform Fr element (canonical words, least significant first) from the
// stream of `state`, from block `counter` on: bit 255 masked, rejected while
// >= r (arkworks' UniformRand, the host's sampler). Returns the next counter.
// `mod(i)` is word i of r.
template <class P>
__device__ __forceinline__ uint32_t sample_fr(const uint32_t state[8], uint32_t counter, uint32_t out[8]) {
  for (;;) {
    stream_block(state, counter++, out);
    out[7] &= 0x7fffffffu;
    bool lt = false, eq = true;  // out < r, compared from the top word with constant indices (no local memory)
#pragma unroll
    for (int i = 7; i >= 0; --i) {
      lt = lt || (eq && out[i] < P::mod(i));
      eq = eq && out[i] == P::mod(i);
    }
    if (lt) return counter;
  }
}

}  // namespace b2s

// Yardstick: the Blake2s of `count` messages of `nwords` words each (rows of
// msgs), one thread a message. Only chip_smoke.py launches it.
__global__ void blake2s_batch_kernel(const uint32_t* __restrict__ msgs, uint32_t* __restrict__ out,
                                     int64_t count, int nwords) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  uint32_t h[8];
  b2s::hash_words(msgs + i * nwords, nwords, h);
#pragma unroll
  for (int j = 0; j < 8; ++j) out[i * 8 + j] = h[j];
}
