// The two-launch design's K6 (sc1_round_kernel) and K5 (fs_sc1_emit_kernel)
// bodies with clock64() stamps at their stage boundaries, and a chain of
// Blake2s compressions on one thread in two forms of the rotates (shifts and
// ors, and PRMT/funnel shifts). Built by run.py against that design's csrc/
// (commit 6f01809): the split that the one-launch round started from.
#include "fs.cuh"
#include "sumcheck.cuh"

__device__ __forceinline__ void snk(uint32_t& s, const Fr& x) {
#pragma unroll
  for (int i = 0; i < 8; ++i) asm volatile("xor.b32 %0, %0, %1;" : "+r"(s) : "r"(x.v[i]));
}
__device__ __forceinline__ void snkw(uint32_t& s, uint32_t x) { asm volatile("xor.b32 %0, %0, %1;" : "+r"(s) : "r"(x)); }
__device__ __forceinline__ long long clk() {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t)::"memory");
  return t;
}

// stamps: 0 start, 1 loads, 2 fold, 3 eval products, 4 warp sums, 5 block sum, 6 store; [7] sink
__global__ void __launch_bounds__(128) k6_stamped(const uint32_t* __restrict__ az, const uint32_t* __restrict__ bz,
                                                  const uint32_t* __restrict__ cz, const uint32_t* __restrict__ s,
                                                  const uint32_t* __restrict__ r_mont, uint32_t* az_out,
                                                  uint32_t* bz_out, uint32_t* cz_out, uint32_t* partials,
                                                  int64_t pairs, int fold, long long* st) {
  using namespace sck;
  __shared__ Fr smem[3 * 32];
  uint32_t sk = 0;
  long long t[7];
  t[0] = clk();
  const Fr r = fold ? load8(r_mont) : fe_zero<FrParams>();
  Fr acc[3] = {fe_zero<FrParams>(), fe_zero<FrParams>(), fe_zero<FrParams>()};
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  Fr x[3][4], sb;
  const uint32_t* tabs[3] = {az, bz, cz};
  uint32_t* outs[3] = {az_out, bz_out, cz_out};
  if (b < pairs) {
    for (int k = 0; k < 3; ++k) {
      if (fold) {
        for (int j = 0; j < 4; ++j) x[k][j] = fe_load<FrParams>(tabs[k], 4 * pairs, 4 * b + j);
      } else {
        x[k][0] = fe_load<FrParams>(tabs[k], 2 * pairs, 2 * b);
        x[k][1] = fe_load<FrParams>(tabs[k], 2 * pairs, 2 * b + 1);
      }
    }
    sb = fe_load<FrParams>(s, pairs, b);
    for (int k = 0; k < 3; ++k) snk(sk, x[k][fold ? 3 : 1]);
    snk(sk, sb);
    snk(sk, r);
  }
  t[1] = clk();
  Fr e[3], o[3];
  if (b < pairs) {
    for (int k = 0; k < 3; ++k) {
      if (fold) {
        e[k] = add(x[k][0], mul(sub(x[k][1], x[k][0]), r));
        o[k] = add(x[k][2], mul(sub(x[k][3], x[k][2]), r));
        fe_store<FrParams>(outs[k], 2 * pairs, 2 * b, e[k]);
        fe_store<FrParams>(outs[k], 2 * pairs, 2 * b + 1, o[k]);
      } else {
        e[k] = x[k][0];
        o[k] = x[k][1];
      }
      snk(sk, e[k]);
      snk(sk, o[k]);
    }
  }
  t[2] = clk();
  if (b < pairs) {
    Fr a = e[0], bb = e[1], c = e[2];
    const Fr ad = sub(o[0], a), bd = sub(o[1], bb), cd = sub(o[2], c);
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      if (q > 0) {
        a = add(a, ad);
        bb = add(bb, bd);
        c = add(c, cd);
      }
      acc[q] = add(acc[q], mul(sub(mul(a, bb), c), sb));
    }
    for (int q = 0; q < 3; ++q) snk(sk, acc[q]);
  }
  t[3] = clk();
#pragma unroll
  for (int q = 0; q < 3; ++q) acc[q] = warp_sum(acc[q]);
  for (int q = 0; q < 3; ++q) snk(sk, acc[q]);
  t[4] = clk();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  if (lane == 0) {
    for (int q = 0; q < 3; ++q) smem[q * 32 + warp] = acc[q];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int q = 0; q < 3; ++q) acc[q] = warp_sum(lane < nwarps ? smem[q * 32 + lane] : fe_zero<FrParams>());
  }
  for (int q = 0; q < 3; ++q) snk(sk, acc[q]);
  t[5] = clk();
  if (threadIdx.x == 0) {
    for (int q = 0; q < 3; ++q) store8(partials + ((int64_t)q * gridDim.x + blockIdx.x) * 8, acc[q]);
  }
  t[6] = clk();
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    for (int i = 0; i < 7; ++i) st[i] = t[i];
    st[7] = sk;
  }
}

// stamps: 0 start, 1 partials summed, 2 evaluations, 3.. after each compression, then sample, pre
__global__ void __launch_bounds__(96) k5_stamped(const uint32_t* __restrict__ partials, const uint32_t* __restrict__ tor_i,
                                                 const uint32_t* __restrict__ consts, uint32_t* pre, uint32_t* state,
                                                 uint32_t* __restrict__ evals, uint32_t* __restrict__ r_out,
                                                 uint32_t* __restrict__ r_mont, int64_t nblocks, int D,
                                                 long long* st) {
  using namespace sck;
  __shared__ Fr q[3];
  __shared__ uint32_t msg[10 + 8 * fs::kMaxEvals];
  uint32_t sk = 0;
  long long t[32];
  int nt = 0;
  t[nt++] = clk();
  fs::sum_partials(partials, nblocks, q);
  snk(sk, q[0]);
  t[nt++] = clk();
  const Fr tor = load8(tor_i), p = load8(pre);
  for (int j = threadIdx.x; j < D; j += blockDim.x) {
    const Fr qt = add(mul(q[0], load8(consts + (0 * D + j) * 8)),
                      add(mul(q[1], load8(consts + (1 * D + j) * 8)), mul(q[2], load8(consts + (2 * D + j) * 8))));
    const Fr ell = add(mul(tor, load8(consts + (3 * D + j) * 8)), load8(consts + (4 * D + j) * 8));
    const Fr ev = fs::from_mont(mul(p, mul(ell, qt)));
    store8(evals + j * 8, ev);
    store8(msg + 10 + j * 8, ev);
  }
  if (threadIdx.x == 0) {
    for (int i = 0; i < 8; ++i) msg[i] = state[i];
    msg[8] = (uint32_t)D;
    msg[9] = 0u;
  }
  __syncthreads();
  t[nt++] = clk();
  if (threadIdx.x == 0) {
    const int nwords = 10 + 8 * D;
    uint32_t h[8];
    for (int i = 0; i < 8; ++i) h[i] = b2s::iv(i);
    h[0] ^= 0x01010020u;
    const int nb = (nwords + 15) / 16;
    uint32_t m[16];
    for (int k = 0; k < nb; ++k) {
      const bool last = k == nb - 1;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int w = 16 * k + j;
        m[j] = w < nwords ? msg[w] : 0u;
      }
      b2s::compress(h, m, last ? 4u * (uint32_t)nwords : 64u * (uint32_t)(k + 1), last);
      snkw(sk, h[0]);
      t[nt++] = clk();
    }
    uint32_t r[8];
    b2s::sample_fr<FrParams>(h, 0u, r);
    snkw(sk, r[0]);
    t[nt++] = clk();
    Fr rc;
    for (int i = 0; i < 8; ++i) {
      rc.v[i] = r[i];
      state[i] = h[i];
    }
    const Fr rm = fs::to_mont(rc);
    store8(r_out, rc);
    store8(r_mont, rm);
    const Fr t2 = mul(tor, rm);
    const Fr ell_r = add(sub(sub(add(t2, t2), tor), rm), load8(fs::SPK_FR_ONE_MONT));
    const Fr pn = mul(p, ell_r);
    store8(pre, pn);
    snk(sk, pn);
    t[nt++] = clk();
    for (int i = 0; i < nt; ++i) st[i] = t[i];
    st[31] = sk;
    st[30] = nt;
  }
}

// Blake2s compression variants, chained n times on one thread.
namespace v1 {
__device__ __forceinline__ uint32_t rot16(uint32_t x) { return __byte_perm(x, x, 0x1032); }
__device__ __forceinline__ uint32_t rot8(uint32_t x) { return __byte_perm(x, x, 0x0321); }
__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) { return __funnelshift_r(x, x, n); }
#define G1(a, b, c, d, x, y) \
  a = a + b + (x); d = rot16(d ^ a); c = c + d; b = rotr(b ^ c, 12); \
  a = a + b + (y); d = rot8(d ^ a);  c = c + d; b = rotr(b ^ c, 7);
#define R1(s0, s1, s2, s3, s4, s5, s6, s7, s8, s9, s10, s11, s12, s13, s14, s15) \
  G1(v0, v4, v8, v12, m[s0], m[s1]) G1(v1, v5, v9, v13, m[s2], m[s3])           \
  G1(v2, v6, v10, v14, m[s4], m[s5]) G1(v3, v7, v11, v15, m[s6], m[s7])         \
  G1(v0, v5, v10, v15, m[s8], m[s9]) G1(v1, v6, v11, v12, m[s10], m[s11])       \
  G1(v2, v7, v8, v13, m[s12], m[s13]) G1(v3, v4, v9, v14, m[s14], m[s15])
__device__ __forceinline__ void compress(uint32_t h[8], const uint32_t m[16], uint32_t t, bool last) {
  uint32_t v0 = h[0], v1 = h[1], v2 = h[2], v3 = h[3], v4 = h[4], v5 = h[5], v6 = h[6], v7 = h[7];
  uint32_t v8 = b2s::iv(0), v9 = b2s::iv(1), v10 = b2s::iv(2), v11 = b2s::iv(3);
  uint32_t v12 = b2s::iv(4) ^ t, v13 = b2s::iv(5), v14 = last ? ~b2s::iv(6) : b2s::iv(6), v15 = b2s::iv(7);
  R1(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
  R1(14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3)
  R1(11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4)
  R1(7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8)
  R1(9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13)
  R1(2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9)
  R1(12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11)
  R1(13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10)
  R1(6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5)
  R1(10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0)
  h[0] ^= v0 ^ v8;  h[1] ^= v1 ^ v9;  h[2] ^= v2 ^ v10; h[3] ^= v3 ^ v11;
  h[4] ^= v4 ^ v12; h[5] ^= v5 ^ v13; h[6] ^= v6 ^ v14; h[7] ^= v7 ^ v15;
}
}  // namespace v1

template <int V>
__global__ void b2s_chain(const uint32_t* __restrict__ msg, uint32_t* out, int n, long long* st) {
  uint32_t h[8], m[16];
  for (int i = 0; i < 8; ++i) h[i] = b2s::iv(i);
  for (int i = 0; i < 16; ++i) m[i] = msg[i];
  uint32_t sk = 0;
  snkw(sk, m[15]);
  const long long t0 = clk();
  for (int k = 0; k < n; ++k) {
    if (V == 0) b2s::compress(h, m, 64u * (k + 1), false);
    else v1::compress(h, m, 64u * (k + 1), false);
  }
  snkw(sk, h[0]);
  const long long t1 = clk();
  for (int i = 0; i < 8; ++i) out[i] = h[i];
  st[0] = t1 - t0;
  st[1] = sk;
}

extern "C" int pr_k6(const uint32_t* az, const uint32_t* bz, const uint32_t* cz, const uint32_t* s,
                     const uint32_t* r_mont, uint32_t* az_out, uint32_t* bz_out, uint32_t* cz_out,
                     uint32_t* partials, int64_t pairs, int64_t fold, int64_t blocks, long long* st,
                     cudaStream_t stream) {
  k6_stamped<<<(unsigned)blocks, 128, 0, stream>>>(az, bz, cz, s, r_mont, az_out, bz_out, cz_out, partials, pairs,
                                                   (int)fold, st);
  return (int)cudaGetLastError();
}
extern "C" int pr_k5(const uint32_t* partials, const uint32_t* tor_i, const uint32_t* consts, uint32_t* pre,
                     uint32_t* state, uint32_t* evals, uint32_t* r_out, uint32_t* r_mont, int64_t nblocks,
                     int64_t D, long long* st, cudaStream_t stream) {
  k5_stamped<<<1, 96, 0, stream>>>(partials, tor_i, consts, pre, state, evals, r_out, r_mont, nblocks, (int)D, st);
  return (int)cudaGetLastError();
}
extern "C" int pr_chain(int v, const uint32_t* msg, uint32_t* out, int64_t n, long long* st, cudaStream_t stream) {
  if (v == 0) b2s_chain<0><<<1, 32, 0, stream>>>(msg, out, (int)n, st);
  else b2s_chain<1><<<1, 32, 0, stream>>>(msg, out, (int)n, st);
  return (int)cudaGetLastError();
}
