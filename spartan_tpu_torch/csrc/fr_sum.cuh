// Fr elements one a thread for the sumcheck-phase kernels (sumcheck.cuh,
// fs.cuh): the products on fp_cc.cuh's carry flag, the canonical sums and
// differences of field.cuh, an element as 8 consecutive words, and sums of
// many elements kept unreduced.
//
// A sum of canonical elements (each < r < 2^255) is kept exact in 9 words,
// `Acc`, on the carry flag: 2^32 terms stay below 2^287. Adding an element
// is one 9-word carry chain, where a canonical add mod r (field.cuh's
// fe_add) is a chain, a trial subtraction and a select, about 50 dependent
// instructions; a warp's sum is 9 shuffles and one chain a step. The sum is
// reduced to canonical once, where it is consumed (`acc_mul`).
// Every exact reduction gives the same canonical value, so the kernels stay
// bit-exact against a sum mod r taken in any order.
#pragma once

#include "fp_cc.cuh"
#include "fr.cuh"

using Fr = Fe<FrParams>;

namespace sck {

// The product is one function, not inlined at each of the sumcheck kernels'
// few dozen call sites: a round runs each site once or a few times, and
// inlined copies (about 5 KB of code each) cost more in instruction-cache
// misses than the call (PERF.md). Static: each file of entry points that
// includes this header (sumcheck_ops.cu, fr_ops.cu) compiles its own copy.
static __device__ __noinline__ Fr mul_fn(Fr a, Fr b) { return fe_mul_cc<FrParams>(a, b); }
__device__ __forceinline__ Fr mul(const Fr& a, const Fr& b) { return mul_fn(a, b); }
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

// R^2 mod r (Montgomery form of R) and 1 in Montgomery form (R mod r).
static __constant__ uint32_t SPK_FR_R2[8] = {0xf3f29c6du, 0xc999e990u, 0x87925c23u, 0x2b6cedcbu,
                                             0x7254398fu, 0x05d31496u, 0x9f59ff11u, 0x0748d9d9u};
static __constant__ uint32_t SPK_FR_ONE_MONT[8] = {0xfffffffeu, 0x00000001u, 0x00034802u, 0x5884b7fau,
                                                   0xecbc4ff5u, 0x998c4fefu, 0xacc5056fu, 0x1824b159u};

__device__ __forceinline__ Fr fr_const(const uint32_t* c) { return load8(c); }
__device__ __forceinline__ Fr fr_word(uint32_t w) {
  Fr x = fe_zero<FrParams>();
  x.v[0] = w;
  return x;
}

// A sum of canonical elements, exact in 9 words (v[8] the top).
struct Acc {
  uint32_t v[9];
};

__device__ __forceinline__ Acc acc_zero() {
  Acc s;
#pragma unroll
  for (int i = 0; i < 9; ++i) s.v[i] = 0u;
  return s;
}

__device__ __forceinline__ void acc_add(Acc& s, const Fr& x) {
  s.v[0] = add_cc(s.v[0], x.v[0]);
#pragma unroll
  for (int i = 1; i < 8; ++i) s.v[i] = addc_cc(s.v[i], x.v[i]);
  s.v[8] = addc(s.v[8], 0u);
}

__device__ __forceinline__ void acc_add(Acc& s, const Acc& x) {
  s.v[0] = add_cc(s.v[0], x.v[0]);
#pragma unroll
  for (int i = 1; i < 8; ++i) s.v[i] = addc_cc(s.v[i], x.v[i]);
  s.v[8] = addc(s.v[8], x.v[8]);
}

// s summed over the lanes of a full warp whose lane index differs only in
// the bits of `from` and up (from = 1: all 32 lanes; from = 4: the lanes
// that agree in the low two bits). Every lane gets its set's sum.
__device__ __forceinline__ Acc acc_warp_sum(Acc s, int from) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    if (off < from) break;
    Acc y;
#pragma unroll
    for (int i = 0; i < 9; ++i) y.v[i] = __shfl_xor_sync(0xffffffffu, s.v[i], off);
    acc_add(s, y);
  }
  return s;
}

// The low 256 bits of s mod r, canonical: they are below 2^256 < 3r, so at
// most two subtractions of r.
__device__ __forceinline__ Fr acc_lo(const Acc& s) {
  Fr x;
#pragma unroll
  for (int i = 0; i < 8; ++i) x.v[i] = s.v[i];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    Fr d;
    d.v[0] = sub_cc(x.v[0], FrParams::mod(0));
#pragma unroll
    for (int i = 1; i < 8; ++i) d.v[i] = subc_cc(x.v[i], FrParams::mod(i));
    const uint32_t borrow = subc(0u, 0u);  // 0xffffffff when x < r
    x = borrow ? x : d;
  }
  return x;
}

// y s R^-1 mod r, canonical, for canonical y and y_r2 = y R (that is
// mul(y, R^2)): s = lo + hi 2^256 with 2^256 = R, so y s R^-1 = y lo R^-1 +
// y R hi R^-1. Two products side by side, then one add mod r.
__device__ __forceinline__ Fr acc_mul(const Fr& y, const Fr& y_r2, const Acc& s) {
  return add(mul(y, acc_lo(s)), mul(y_r2, fr_word(s.v[8])));
}

}  // namespace sck
