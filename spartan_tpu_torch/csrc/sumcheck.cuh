// K6 and K7: one sumcheck round of each phase in one launch, the fold by the
// last challenge and the round's three evaluations together.
//
// K6 (sc1_round_kernel) replaces spartan_tpu/ops/sumcheck.py: sc1_round
// (:77) with sc1_evals3 (:54), and K7 (prod2_round_kernel) prod2_round (:97)
// with prod2_evals3; on the TPU their products, sums and differences are the
// Pallas kernels mont_mul, add and sub (pallas_field.py:254/258/262), one
// launch each and a reduction over the table for every evaluation. Here one
// thread takes an output pair b: when the round is past the first it reads
// entries 4b..4b+3 of each table, folds them by r (t[2b] + r (t[2b+1] -
// t[2b])) and writes the folded pair at 2b, 2b+1; then it adds its terms at
// t = 0, 1, 2 to three sums, S[b] (Az_t Bz_t - Cz_t) for K6 and W_t z_t for
// K7. A block reduces its sums mod r (a warp by shuffles, then the warps)
// and writes one partial a block and evaluation; the transcript kernel
// (fs.cuh) adds the partials. Every sum is mod r, so the order does not
// change a bit of the result.
//
// What bounds it: a folding round of K6 reads 13 Fr elements a pair and
// writes 6 (608 bytes) and does 12 Fr products (1,536 32x32->64 products);
// on an H100 (3.35 TB/s, 132 SMs at 1.98 GHz) the two bounds are about equal
// (chip_smoke.py prints both), and from a few thousand pairs down a round is
// the launch's latency. Tables are (8, N) limb-major Montgomery, as
// everywhere in the port; the products are fp_cc.cuh's carry-flag CIOS, the
// sums and differences field.cuh's.
#pragma once

#include "fr_sum.cuh"

namespace sck {

constexpr int kThreads = 128;   // a round kernel's block
constexpr int kMaxBlocks = 256;  // partials a round at most; a thread loops over the pairs beyond

// Pair b of a table, entering the round: folded by r from entries 4b..4b+3
// of the (8, 4 pairs) input and written at 2b, 2b+1 of the (8, 2 pairs)
// output, or, in the first round, read at 2b, 2b+1 as it is.
__device__ __forceinline__ void pair(const uint32_t* in, uint32_t* out, int64_t pairs, int64_t b, bool fold,
                                     const Fr& r, Fr& e, Fr& o) {
  if (fold) {
    const int64_t n_in = 4 * pairs, n_out = 2 * pairs;
    const Fr x0 = fe_load<FrParams>(in, n_in, 4 * b), x1 = fe_load<FrParams>(in, n_in, 4 * b + 1);
    const Fr x2 = fe_load<FrParams>(in, n_in, 4 * b + 2), x3 = fe_load<FrParams>(in, n_in, 4 * b + 3);
    e = add(x0, mul(sub(x1, x0), r));
    o = add(x2, mul(sub(x3, x2), r));
    fe_store<FrParams>(out, n_out, 2 * b, e);
    fe_store<FrParams>(out, n_out, 2 * b + 1, o);
  } else {
    e = fe_load<FrParams>(in, 2 * pairs, 2 * b);
    o = fe_load<FrParams>(in, 2 * pairs, 2 * b + 1);
  }
}

// The block's sums as its partials: partial (t, block) at (t gridDim + block) x 8.
template <int NV>
__device__ __forceinline__ void write_partials(Fr (&acc)[NV], Fr* smem, uint32_t* partials) {
  block_sum<NV>(acc, smem);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int t = 0; t < NV; ++t) store8(partials + ((int64_t)t * gridDim.x + blockIdx.x) * 8, acc[t]);
  }
}

}  // namespace sck

// K6: sum_b S[b] (Az_t Bz_t - Cz_t)[b] at t = 0, 1, 2 over `pairs` pairs,
// after the fold by r_mont (8 words, Montgomery) when `fold` is set.
__global__ void __launch_bounds__(sck::kThreads)
sc1_round_kernel(const uint32_t* __restrict__ az, const uint32_t* __restrict__ bz,
                 const uint32_t* __restrict__ cz, const uint32_t* __restrict__ s,
                 const uint32_t* __restrict__ r_mont, uint32_t* __restrict__ az_out,
                 uint32_t* __restrict__ bz_out, uint32_t* __restrict__ cz_out,
                 uint32_t* __restrict__ partials, int64_t pairs, int fold) {
  using namespace sck;
  __shared__ Fr smem[3 * 32];
  const Fr r = fold ? load8(r_mont) : fe_zero<FrParams>();
  Fr acc[3] = {fe_zero<FrParams>(), fe_zero<FrParams>(), fe_zero<FrParams>()};
  for (int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; b < pairs;
       b += (int64_t)gridDim.x * blockDim.x) {
    Fr a, ao, bb, bo, c, co;
    pair(az, az_out, pairs, b, fold, r, a, ao);
    pair(bz, bz_out, pairs, b, fold, r, bb, bo);
    pair(cz, cz_out, pairs, b, fold, r, c, co);
    const Fr ad = sub(ao, a), bd = sub(bo, bb), cd = sub(co, c);
    const Fr sb = fe_load<FrParams>(s, pairs, b);
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      if (t > 0) {
        a = add(a, ad);
        bb = add(bb, bd);
        c = add(c, cd);
      }
      acc[t] = add(acc[t], mul(sub(mul(a, bb), c), sb));
    }
  }
  write_partials<3>(acc, smem, partials);
}

// K7: sum_b W_t[b] z_t[b] at t = 0, 1, 2, after the fold as above.
__global__ void __launch_bounds__(sck::kThreads)
prod2_round_kernel(const uint32_t* __restrict__ w, const uint32_t* __restrict__ z,
                   const uint32_t* __restrict__ r_mont, uint32_t* __restrict__ w_out,
                   uint32_t* __restrict__ z_out, uint32_t* __restrict__ partials, int64_t pairs, int fold) {
  using namespace sck;
  __shared__ Fr smem[3 * 32];
  const Fr r = fold ? load8(r_mont) : fe_zero<FrParams>();
  Fr acc[3] = {fe_zero<FrParams>(), fe_zero<FrParams>(), fe_zero<FrParams>()};
  for (int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; b < pairs;
       b += (int64_t)gridDim.x * blockDim.x) {
    Fr x, xo, y, yo;
    pair(w, w_out, pairs, b, fold, r, x, xo);
    pair(z, z_out, pairs, b, fold, r, y, yo);
    const Fr xd = sub(xo, x), yd = sub(yo, y);
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      if (t > 0) {
        x = add(x, xd);
        y = add(y, yd);
      }
      acc[t] = add(acc[t], mul(x, y));
    }
  }
  write_partials<3>(acc, smem, partials);
}
