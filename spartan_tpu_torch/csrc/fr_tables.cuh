// K1 where the prover launches it on whole tables: the eq tables in one
// launch, and the openings' quotient ladder in one launch a level plus a
// one-block tail. Montgomery Fr in (8, n) limb arrays.
//
// - eq_tables_kernel replaces spartan_tpu/ops/mle.py eq_table (:89) and
//   eq_suffix_tables_mont (:123): a loop of one fr_sub (1 - t_i, one lane)
//   and one fr_mul a variable, 2 nv launches a table set. Here every output
//   lane forms its own product of the nv factors t_i or 1 - t_i by its index
//   bits; the block forms the nv values 1 - t_i once, in shared memory.
//   Table j of the suffix set, eq(t[j..], v), holds 2^(nv-j) lanes, bit k of
//   v for variable j + k; table 0 is eq_table's (bit i for variable i), and
//   table nv is the constant one. The tables lie one after another in one
//   buffer, each (8, 2^(nv-j)) limb-major, so each is a contiguous view.
// - quot_level_kernel and quot_tail_kernel replace
//   spartan_tpu/commitment/scheme.py _quotients_and_eval (:175): per level
//   i, q = odd - even, from_mont(q) into the level's block of qcat (levels
//   largest first), r' = even + p_i q; at the end from_mont(r). The port
//   ran it as four K1 launches a level (sub, from_mont, mul, add). A level
//   launch fuses the four; from the first level of at most kTailPairs
//   pairs, one block runs every remaining level and the final from_mont,
//   with r in shared memory and __syncthreads() between levels.
//
// What bounds them on an H100. At the prover's nv = 16 an eq table set is
// 2^16 or 2^17 lanes of at most 15 products (0.02 ms of 32-bit products at
// the card's rate); a ladder level reads 2^(nv-i) elements and writes
// 2^(nv-i) (bytes, at most 4 MB). Below a few thousand lanes a launch is its
// latency: about 2 us, and a level's chain of a subtract, two products and
// an add; the tail's 11 levels are that chain 11 times over in one launch.
//
// Every product is fp_cc.cuh's fe_mul_cc<FrParams> and every value
// canonical, so the limbs equal the plain loops' (the order of an eq
// product's factors does not change its value).
#pragma once

#include "fr_sum.cuh"

namespace frt {

constexpr int kMaxVars = 30;     // variables a kernel takes
constexpr int kEqThreads = 256;  // lanes a block of the eq kernel
constexpr int kLevelThreads = 128;
constexpr int kTailPairs = 1024;  // pairs of the tail's first level, at most
constexpr int kTailThreads = 512;

__device__ __forceinline__ Fr fr_one_mont() { return sck::fr_const(sck::SPK_FR_ONE_MONT); }
// a b R^-1 with b = 1
__device__ __forceinline__ Fr from_mont(const Fr& a) { return fe_mul_cc<FrParams>(a, sck::fr_word(1u)); }

// Element k of an (8, n) limb-major array.
__device__ __forceinline__ Fr load(const uint32_t* base, int64_t n, int64_t k) {
  return fe_load<FrParams>(base, n, k);
}

// ts: the point, (8, nv) Montgomery; out: `tables` tables, table j of
// 2^(nv-j) lanes at lane offset 2^(nv+1) - 2^(nv+1-j) (limb-major within
// it); total: their lanes.
__global__ void __launch_bounds__(kEqThreads) eq_tables_kernel(const uint32_t* __restrict__ ts,
                                                              uint32_t* __restrict__ out, int nv,
                                                              int64_t total) {
  __shared__ Fr fac[2][kMaxVars];  // [0][i] = 1 - t_i, [1][i] = t_i
  for (int i = threadIdx.x; i < nv; i += blockDim.x) {
    const Fr t = load(ts, nv, i);
    fac[0][i] = fe_sub<FrParams>(fr_one_mont(), t);
    fac[1][i] = t;
  }
  __syncthreads();
  const int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= total) return;
  int j = 0;
  int64_t off = 0, m = (int64_t)1 << nv;
  while (g >= off + m) {
    off += m;
    m >>= 1;
    ++j;
  }
  const int64_t v = g - off;
  Fr acc = nv - j > 0 ? fac[v & 1][j] : fr_one_mont();
#pragma unroll 1
  for (int k = 1; k < nv - j; ++k) acc = fe_mul_cc<FrParams>(acc, fac[(v >> k) & 1][j + k]);
  fe_store<FrParams>(out + 8 * off, m, v, acc);
}

// The level's challenge p_level (column `level` of the (8, nv) point) into
// shared memory.
__device__ __forceinline__ void load_challenge(uint32_t* dst, const uint32_t* point, int nv, int level) {
  if (threadIdx.x < 8) dst[threadIdx.x] = point[threadIdx.x * nv + level];
}

// One ladder step on pair b: stores from_mont(odd - even) at lane q_off + b
// of qcat (width q_ld) and returns even + p (odd - even).
__device__ __forceinline__ Fr step(const Fr& even, const Fr& odd, const Fr& p, uint32_t* qcat, int64_t q_ld,
                                   int64_t q_off, int64_t b) {
  const Fr q = fe_sub<FrParams>(odd, even);
  fe_store<FrParams>(qcat, q_ld, q_off + b, from_mont(q));
  return fe_add<FrParams>(even, fe_mul_cc<FrParams>(q, p));
}

// Level `level` of a ladder over nv variables: r holds 2^(nv-level)
// elements, r_out takes the 2^(nv-level-1) of the next level.
__global__ void __launch_bounds__(kLevelThreads) quot_level_kernel(const uint32_t* __restrict__ r,
                                                                  const uint32_t* __restrict__ point,
                                                                  uint32_t* __restrict__ qcat,
                                                                  uint32_t* __restrict__ r_out, int nv,
                                                                  int level) {
  __shared__ Fr p;
  load_challenge(p.v, point, nv, level);
  __syncthreads();
  const int64_t pairs = (int64_t)1 << (nv - 1 - level);
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= pairs) return;
  const int64_t q_ld = ((int64_t)1 << nv) - 1, q_off = ((int64_t)1 << nv) - 2 * pairs;
  const Fr rn = step(load(r, 2 * pairs, 2 * b), load(r, 2 * pairs, 2 * b + 1), p, qcat, q_ld, q_off, b);
  fe_store<FrParams>(r_out, pairs, b, rn);
}

// Levels level0 .. nv - 1 and the evaluation, by one block: r holds the
// 2^(nv-level0) elements of level0 (at most 2 kTailPairs); ev takes
// from_mont of the last remainder, (8, 1).
__global__ void __launch_bounds__(kTailThreads) quot_tail_kernel(const uint32_t* __restrict__ r,
                                                                const uint32_t* __restrict__ point,
                                                                uint32_t* __restrict__ qcat,
                                                                uint32_t* __restrict__ ev, int nv, int level0) {
  __shared__ Fr rs[kTailPairs];
  __shared__ Fr ps[kMaxVars];
  for (int k = threadIdx.x; k < 8 * (nv - level0); k += blockDim.x)
    ps[k / 8].v[k % 8] = point[(k % 8) * nv + level0 + k / 8];
  __syncthreads();
  const int64_t q_ld = ((int64_t)1 << nv) - 1;
  for (int level = level0; level < nv; ++level) {
    const int pairs = 1 << (nv - 1 - level);
    const int64_t q_off = ((int64_t)1 << nv) - 2 * pairs;
    if (level == level0) {  // from device memory into rs: no overlap
      for (int b = threadIdx.x; b < pairs; b += blockDim.x)
        rs[b] = step(load(r, 2 * pairs, 2 * b), load(r, 2 * pairs, 2 * b + 1), ps[0], qcat, q_ld, q_off, b);
    } else {  // in place: pairs <= kTailPairs / 2 <= blockDim, one pair a thread
      const int b = threadIdx.x;
      Fr rn;
      if (b < pairs) rn = step(rs[2 * b], rs[2 * b + 1], ps[level - level0], qcat, q_ld, q_off, b);
      __syncthreads();  // every read of rs before any write
      if (b < pairs) rs[b] = rn;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) fe_store<FrParams>(ev, 1, 0, from_mont(level0 < nv ? rs[0] : load(r, 1, 0)));
}

#ifdef __CUDACC__
static int eq_tables_launch(const uint32_t* ts, uint32_t* out, int64_t nv, int64_t tables, cudaStream_t stream) {
  if (nv < 0 || nv > kMaxVars || tables < 1 || tables > nv + 1) return (int)cudaErrorInvalidValue;
  const int64_t total = ((int64_t)2 << nv) - ((int64_t)1 << (nv + 1 - tables));
  eq_tables_kernel<<<(unsigned)((total + kEqThreads - 1) / kEqThreads), kEqThreads, 0, stream>>>(ts, out, (int)nv,
                                                                                               total);
  return (int)cudaGetLastError();
}

static int quot_level_launch(const uint32_t* r, const uint32_t* point, uint32_t* qcat, uint32_t* r_out, int64_t nv,
                             int64_t level, cudaStream_t stream) {
  if (nv < 1 || nv > kMaxVars || level < 0 || level >= nv) return (int)cudaErrorInvalidValue;
  const int64_t pairs = (int64_t)1 << (nv - 1 - level);
  quot_level_kernel<<<(unsigned)((pairs + kLevelThreads - 1) / kLevelThreads), kLevelThreads, 0, stream>>>(
      r, point, qcat, r_out, (int)nv, (int)level);
  return (int)cudaGetLastError();
}

static int quot_tail_launch(const uint32_t* r, const uint32_t* point, uint32_t* qcat, uint32_t* ev, int64_t nv,
                            int64_t level0, cudaStream_t stream) {
  if (nv < 0 || nv > kMaxVars || level0 < 0 || level0 > nv || (nv - 1 - level0 >= 0 &&
      ((int64_t)1 << (nv - 1 - level0)) > kTailPairs))
    return (int)cudaErrorInvalidValue;
  const int64_t pairs0 = level0 < nv ? (int64_t)1 << (nv - 1 - level0) : 1;
  const int threads = (int)(pairs0 < 32 ? 32 : pairs0 > kTailThreads ? kTailThreads : pairs0);
  quot_tail_kernel<<<1, threads, 0, stream>>>(r, point, qcat, ev, (int)nv, (int)level0);
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__

}  // namespace frt
