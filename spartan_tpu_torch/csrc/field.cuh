// Montgomery arithmetic over a prime field held in N 32-bit limbs, one
// element per thread. R = 2^(32N): 2^256 for Fr (N=8), 2^384 for Fp (N=12),
// the same R as the JAX package's 16-bit-limb layout, so Montgomery values
// carry over by packing limb pairs.
//
// Arrays are limb-major, (N, n) with limb i of lane j at [i * n + j]:
// neighbouring threads touch neighbouring words, so every limb load is
// coalesced.
//
// What bounds this on an H100: integer multiply-add issue. A CIOS multiply is
// 2 N^2 32x32->64 products (128 for Fr, 288 for Fp) with a carry chain that
// the compiler lowers to mad.lo/mad.hi pairs, and each carry is built from a
// 64-bit sum: two dependent instructions a limb. The design keeps every
// operand in registers (limb counts are compile-time constants, loops fully
// unrolled), does one exact carry chain per product row and a single
// conditional subtract at the end, and reads the modulus from constant
// memory, which is uniform across a warp.
//
// This file's product runs the yardsticks (the one-thread point kernels,
// fr_mul_sum64, fp_mul_sum64); fr_mul, fp_mul and the team point kernels run
// fp_cc.cuh's product on the carry flag, one instruction a limb. The adds
// and subtracts run the Fr and Fp field kernels and fr_tables.cuh's ladder.
#pragma once

#include <cstdint>
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

template <class P>
struct Fe {
  uint32_t v[P::N];
};

template <class P>
__device__ __forceinline__ Fe<P> fe_load(const uint32_t* base, int64_t n, int64_t lane) {
  Fe<P> r;
#pragma unroll
  for (int i = 0; i < P::N; ++i) r.v[i] = base[i * n + lane];
  return r;
}

template <class P>
__device__ __forceinline__ void fe_store(uint32_t* base, int64_t n, int64_t lane, const Fe<P>& a) {
#pragma unroll
  for (int i = 0; i < P::N; ++i) base[i * n + lane] = a.v[i];
}

template <class P>
__device__ __forceinline__ Fe<P> fe_zero() {
  Fe<P> r;
#pragma unroll
  for (int i = 0; i < P::N; ++i) r.v[i] = 0u;
  return r;
}

template <class P>
__device__ __forceinline__ bool fe_is_zero(const Fe<P>& a) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < P::N; ++i) acc |= a.v[i];
  return acc == 0u;
}

// (t - m) over N limbs; returns the final borrow (1 if t < m).
template <class P>
__device__ __forceinline__ uint32_t fe_sub_mod_raw(const uint32_t* t, Fe<P>& d) {
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < P::N; ++i) {
    uint64_t s = (uint64_t)t[i] - (uint64_t)P::mod(i) - borrow;
    d.v[i] = (uint32_t)s;
    borrow = (s >> 63) & 1u;
  }
  return (uint32_t)borrow;
}

// (a + b) mod m, canonical in and out.
template <class P>
__device__ __forceinline__ Fe<P> fe_add(const Fe<P>& a, const Fe<P>& b) {
  Fe<P> s, d;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < P::N; ++i) {
    uint64_t t = (uint64_t)a.v[i] + b.v[i] + c;
    s.v[i] = (uint32_t)t;
    c = t >> 32;
  }
  uint32_t borrow = fe_sub_mod_raw<P>(s.v, d);
  return (c != 0u || borrow == 0u) ? d : s;
}

// (a - b) mod m, canonical in and out.
template <class P>
__device__ __forceinline__ Fe<P> fe_sub(const Fe<P>& a, const Fe<P>& b) {
  Fe<P> d;
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < P::N; ++i) {
    uint64_t s = (uint64_t)a.v[i] - (uint64_t)b.v[i] - borrow;
    d.v[i] = (uint32_t)s;
    borrow = (s >> 63) & 1u;
  }
  if (borrow) {
    uint64_t c = 0;
#pragma unroll
    for (int i = 0; i < P::N; ++i) {
      uint64_t t = (uint64_t)d.v[i] + P::mod(i) + c;
      d.v[i] = (uint32_t)t;
      c = t >> 32;
    }
  }
  return d;
}

// a * b * 2^(-32N) mod m: CIOS (coarsely integrated operand scanning), one
// b-limb per outer step, exact 64-bit carries, one conditional subtract.
template <class P>
__device__ __forceinline__ Fe<P> fe_mul(const Fe<P>& a, const Fe<P>& b) {
  constexpr int N = P::N;
  uint32_t t[N + 2];
#pragma unroll
  for (int i = 0; i < N + 2; ++i) t[i] = 0u;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    uint64_t c = 0;
    const uint32_t bi = b.v[i];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      uint64_t s = (uint64_t)a.v[j] * bi + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[N] + c;
    t[N] = (uint32_t)s;
    t[N + 1] = (uint32_t)(s >> 32);

    const uint32_t m = t[0] * P::INV;
    s = (uint64_t)m * P::mod(0) + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < N; ++j) {
      s = (uint64_t)m * P::mod(j) + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[N] + c;
    t[N - 1] = (uint32_t)s;
    t[N] = t[N + 1] + (uint32_t)(s >> 32);
  }
  // t < 2m: subtract m once if t >= m
  Fe<P> r, d;
#pragma unroll
  for (int i = 0; i < N; ++i) r.v[i] = t[i];
  uint32_t borrow = fe_sub_mod_raw<P>(t, d);
  return (t[N] != 0u || borrow == 0u) ? d : r;
}

#ifdef __CUDACC__
// Elementwise launcher over (N, n) arrays.
template <class P, int OP>
__global__ void fe_binary_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                                 uint32_t* __restrict__ out, int64_t n) {
  int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  Fe<P> x = fe_load<P>(a, n, lane);
  Fe<P> y = fe_load<P>(b, n, lane);
  Fe<P> r;
  if constexpr (OP == 0) r = fe_mul<P>(x, y);
  else if constexpr (OP == 1) r = fe_add<P>(x, y);
  else r = fe_sub<P>(x, y);
  fe_store<P>(out, n, lane, r);
}

template <class P, int OP>
static int fe_binary_launch(const uint32_t* a, const uint32_t* b, uint32_t* out, int64_t n,
                            cudaStream_t stream) {
  const int threads = 128;
  const int64_t blocks = (n + threads - 1) / threads;
  fe_binary_kernel<P, OP><<<(unsigned)blocks, threads, 0, stream>>>(a, b, out, n);
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__
