// Fr elements one a thread for the sumcheck-phase kernels (sumcheck.cuh,
// fs.cuh): the products on fp_cc.cuh's carry flag, the canonical sums and
// differences of field.cuh, an element as 8 consecutive words, and sums mod r
// across a warp (shuffles) and a block (the warps' sums through shared
// memory). A sum mod r is the same in any order, so these are bit-exact
// against a sum taken in any other order.
#pragma once

#include "fp_cc.cuh"
#include "fr.cuh"

using Fr = Fe<FrParams>;

namespace sck {

__device__ __forceinline__ Fr mul(const Fr& a, const Fr& b) { return fe_mul_cc<FrParams>(a, b); }
__device__ __forceinline__ Fr add(const Fr& a, const Fr& b) { return fe_add<FrParams>(a, b); }
__device__ __forceinline__ Fr sub(const Fr& a, const Fr& b) { return fe_sub<FrParams>(a, b); }

// An element stored as 8 consecutive words, and back.
__device__ __forceinline__ Fr load8(const uint32_t* p) {
  Fr x;
#pragma unroll
  for (int i = 0; i < 8; ++i) x.v[i] = p[i];
  return x;
}
__device__ __forceinline__ void store8(uint32_t* p, const Fr& x) {
#pragma unroll
  for (int i = 0; i < 8; ++i) p[i] = x.v[i];
}

// x summed mod r over the 32 lanes of a full warp; the sum lands in lane 0.
__device__ __forceinline__ Fr warp_sum(Fr x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Fr y;
#pragma unroll
    for (int i = 0; i < 8; ++i) y.v[i] = __shfl_down_sync(0xffffffffu, x.v[i], off);
    x = add(x, y);
  }
  return x;
}

// The NV sums of every thread of the block summed mod r; thread 0 gets them.
template <int NV>
__device__ __forceinline__ void block_sum(Fr (&x)[NV], Fr* smem /* NV x 32 */) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
#pragma unroll
  for (int t = 0; t < NV; ++t) x[t] = warp_sum(x[t]);
  if (lane == 0) {
#pragma unroll
    for (int t = 0; t < NV; ++t) smem[t * 32 + warp] = x[t];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int t = 0; t < NV; ++t) x[t] = warp_sum(lane < nwarps ? smem[t * 32 + lane] : fe_zero<FrParams>());
  }
}

}  // namespace sck
