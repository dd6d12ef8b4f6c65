// Field arithmetic on the PTX carry flag (add.cc, mad.lo.cc, madc.hi.cc):
// field.cuh's CIOS product, written once over the limb count, and Fp's
// canonical add and subtract, one instruction a limb where field.cuh's 64-bit
// sums take two dependent ones. Same results; faster at every width
// measured on the H100 (PERF.md). The product runs Fr's fr_mul (fr_ops.cu),
// and over Fp the team point kernels (team.cuh), the one-thread G1 mixed add
// (point.cuh) and the one-thread Fermat inversion (fp_ops.cu). The host
// branch runs the same code on a software carry flag, for the host pass of
// nvcc and for g++.
#pragma once

#include "fp.cuh"

#if defined(__CUDA_ARCH__)
#define SPK_CC(op, ...) asm volatile(op : __VA_ARGS__)
__device__ __forceinline__ uint32_t add_cc(uint32_t a, uint32_t b) {
  uint32_t r; SPK_CC("add.cc.u32 %0, %1, %2;", "=r"(r) : "r"(a), "r"(b)); return r;
}
__device__ __forceinline__ uint32_t addc_cc(uint32_t a, uint32_t b) {
  uint32_t r; SPK_CC("addc.cc.u32 %0, %1, %2;", "=r"(r) : "r"(a), "r"(b)); return r;
}
__device__ __forceinline__ uint32_t addc(uint32_t a, uint32_t b) {
  uint32_t r; SPK_CC("addc.u32 %0, %1, %2;", "=r"(r) : "r"(a), "r"(b)); return r;
}
__device__ __forceinline__ uint32_t sub_cc(uint32_t a, uint32_t b) {
  uint32_t r; SPK_CC("sub.cc.u32 %0, %1, %2;", "=r"(r) : "r"(a), "r"(b)); return r;
}
__device__ __forceinline__ uint32_t subc_cc(uint32_t a, uint32_t b) {
  uint32_t r; SPK_CC("subc.cc.u32 %0, %1, %2;", "=r"(r) : "r"(a), "r"(b)); return r;
}
__device__ __forceinline__ uint32_t subc(uint32_t a, uint32_t b) {
  uint32_t r; SPK_CC("subc.u32 %0, %1, %2;", "=r"(r) : "r"(a), "r"(b)); return r;
}
__device__ __forceinline__ uint32_t madlo_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r; SPK_CC("mad.lo.cc.u32 %0, %1, %2, %3;", "=r"(r) : "r"(a), "r"(b), "r"(c)); return r;
}
__device__ __forceinline__ uint32_t madclo_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r; SPK_CC("madc.lo.cc.u32 %0, %1, %2, %3;", "=r"(r) : "r"(a), "r"(b), "r"(c)); return r;
}
__device__ __forceinline__ uint32_t madhi_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r; SPK_CC("mad.hi.cc.u32 %0, %1, %2, %3;", "=r"(r) : "r"(a), "r"(b), "r"(c)); return r;
}
__device__ __forceinline__ uint32_t madchi_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r; SPK_CC("madc.hi.cc.u32 %0, %1, %2, %3;", "=r"(r) : "r"(a), "r"(b), "r"(c)); return r;
}
__device__ __forceinline__ uint32_t madchi(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r; SPK_CC("madc.hi.u32 %0, %1, %2, %3;", "=r"(r) : "r"(a), "r"(b), "r"(c)); return r;
}
#undef SPK_CC
#else  // the carry flag on the host, where the device code is compiled for tests
inline thread_local uint32_t spk_cf;
inline uint32_t cc_set(uint64_t s) { spk_cf = (uint32_t)(s >> 32) & 1u; return (uint32_t)s; }
inline uint32_t add_cc(uint32_t a, uint32_t b) { return cc_set((uint64_t)a + b); }
inline uint32_t addc_cc(uint32_t a, uint32_t b) { return cc_set((uint64_t)a + b + spk_cf); }
inline uint32_t addc(uint32_t a, uint32_t b) { return a + b + spk_cf; }
inline uint32_t sub_cc(uint32_t a, uint32_t b) { return cc_set((uint64_t)a - b); }
inline uint32_t subc_cc(uint32_t a, uint32_t b) { return cc_set((uint64_t)a - b - spk_cf); }
inline uint32_t subc(uint32_t a, uint32_t b) { return a - b - spk_cf; }
inline uint32_t madlo_cc(uint32_t a, uint32_t b, uint32_t c) {
  return cc_set((uint64_t)(uint32_t)((uint64_t)a * b) + c);
}
inline uint32_t madclo_cc(uint32_t a, uint32_t b, uint32_t c) {
  return cc_set((uint64_t)(uint32_t)((uint64_t)a * b) + c + spk_cf);
}
inline uint32_t madhi_cc(uint32_t a, uint32_t b, uint32_t c) {
  return cc_set((((uint64_t)a * b) >> 32) + c);
}
inline uint32_t madchi_cc(uint32_t a, uint32_t b, uint32_t c) {
  return cc_set((((uint64_t)a * b) >> 32) + c + spk_cf);
}
inline uint32_t madchi(uint32_t a, uint32_t b, uint32_t c) {
  return (uint32_t)(((uint64_t)a * b) >> 32) + c + spk_cf;
}
#endif

// (a + b) mod p and (a - b) mod p on the carry flag, canonical in and out.
__device__ __forceinline__ Fp fp_add_cc(const Fp& a, const Fp& b) {
  constexpr int N = FpParams::N;
  Fp s, d;
  s.v[0] = add_cc(a.v[0], b.v[0]);
#pragma unroll
  for (int i = 1; i < N; ++i) s.v[i] = addc_cc(a.v[i], b.v[i]);
  const uint32_t carry = addc(0u, 0u);
  d.v[0] = sub_cc(s.v[0], FpParams::mod(0));
#pragma unroll
  for (int i = 1; i < N; ++i) d.v[i] = subc_cc(s.v[i], FpParams::mod(i));
  const uint32_t borrow = subc(carry, 0u);  // 0xffffffff when s < p
  return borrow ? s : d;
}

__device__ __forceinline__ Fp fp_sub_cc(const Fp& a, const Fp& b) {
  constexpr int N = FpParams::N;
  Fp d, e;
  d.v[0] = sub_cc(a.v[0], b.v[0]);
#pragma unroll
  for (int i = 1; i < N; ++i) d.v[i] = subc_cc(a.v[i], b.v[i]);
  const uint32_t borrow = subc(0u, 0u);  // 0xffffffff when a < b
  e.v[0] = add_cc(d.v[0], FpParams::mod(0));
#pragma unroll
  for (int i = 1; i < N; ++i) e.v[i] = addc_cc(d.v[i], FpParams::mod(i));
  return borrow ? e : d;
}

// a * b * 2^(-32N) mod m for canonical a, b < m: CIOS as in field.cuh, on
// the carry flag and with two accumulators, after the even/odd split of
// sppark's mont_t. The products a_j b_i of even j fill words j, j + 1 of one
// array with no carry between them, those of odd j another array one word
// up (and the same for q m_j), so each row runs two carry chains that do not
// depend on each other and ptxas interleaves them; with one accumulator
// every product of a row waits for the one before (PERF.md, PR 5: on the
// H100 that product was the slower one at every width measured). T = x +
// y 2^32, x N words from word 0, y N words from word 1. After a row's
// reduction x[0] = 0 and T / 2^32 = (y + x[1]) + (x >> 64) 2^32, so the
// arrays swap roles every row (N even).
//
// field.cuh keeps N + 2 words of T; here 2N words in two arrays do, because
// the modulus's top bit is clear (m < 2^(32N-1): Fr's top limb is
// 0x73eda753, Fp's 0x1a0111ea; P::TOP, checked below). A row starts from
// T < 2m and adds a b_i < 2^32 m and q m < 2^32 m, so every partial sum
// stays below 2^33 m < 2^(32N+32): y < 2^(32N), and a chain into y's top
// word needs no carry out. After the last row T < 2m < 2^(32N), so one
// conditional subtract over N words makes it canonical.
namespace eo {
__device__ __forceinline__ uint32_t mul_hi(uint32_t a, uint32_t b) {
  return (uint32_t)(((uint64_t)a * b) >> 32);
}
// acc[j], acc[j + 1] = a[j] * bi for even j < N
template <int N>
__device__ __forceinline__ void mul_n(uint32_t* acc, const uint32_t* a, uint32_t bi) {
#pragma unroll
  for (int j = 0; j < N; j += 2) {
    acc[j] = a[j] * bi;
    acc[j + 1] = mul_hi(a[j], bi);
  }
}
// acc += sum over even j of a[j] * bi 2^(32j); the carry out stays in the flag
template <int N>
__device__ __forceinline__ void cmad_n(uint32_t* acc, const uint32_t* a, uint32_t bi) {
  acc[0] = madlo_cc(a[0], bi, acc[0]);
  acc[1] = madchi_cc(a[0], bi, acc[1]);
#pragma unroll
  for (int j = 2; j < N; j += 2) {
    acc[j] = madclo_cc(a[j], bi, acc[j]);
    acc[j + 1] = madchi_cc(a[j], bi, acc[j + 1]);
  }
}
// One row: T = (T + a bi + q m) / 2^32 with x, y as above (x holds the
// previous row's y, y its x), or T = a bi + q m on the first.
template <int N>
__device__ __forceinline__ void row(uint32_t* x, uint32_t* y, const uint32_t* a, const uint32_t* md,
                                    uint32_t inv, uint32_t bi, bool first) {
  if (first) {
    mul_n<N>(y, a + 1, bi);
    mul_n<N>(x, a, bi);
  } else {
    x[0] = add_cc(x[0], y[1]);  // its carry is word 1's: y[0]'s
#pragma unroll
    for (int j = 0; j < N - 2; j += 2) {  // y = (old x >> 64) + odd products
      y[j] = madclo_cc(a[j + 1], bi, y[j + 2]);
      y[j + 1] = madchi_cc(a[j + 1], bi, y[j + 3]);
    }
    y[N - 2] = madclo_cc(a[N - 1], bi, 0u);
    y[N - 1] = madchi(a[N - 1], bi, 0u);
    cmad_n<N>(x, a, bi);
    y[N - 1] = addc(y[N - 1], 0u);
  }
  const uint32_t q = x[0] * inv;
  cmad_n<N>(y, md + 1, q);
  cmad_n<N>(x, md, q);  // x[0] = 0
  y[N - 1] = addc(y[N - 1], 0u);
}
}  // namespace eo

template <class P>
__device__ __forceinline__ Fe<P> fe_mul_cc(const Fe<P>& a, const Fe<P>& b) {
  constexpr int N = P::N;
  static_assert(P::TOP < 0x80000000u && N % 2 == 0, "fe_mul_cc needs the top bit clear, N even");
  uint32_t md[N], e[N], o[N];
#pragma unroll
  for (int i = 0; i < N; ++i) md[i] = P::mod(i);
#pragma unroll
  for (int i = 0; i < N; i += 2) {
    eo::row<N>(e, o, a.v, md, P::INV, b.v[i], i == 0);
    eo::row<N>(o, e, a.v, md, P::INV, b.v[i + 1], false);
  }
  Fe<P> r, d;  // T / 2^32 = e + (o >> 32) < 2m: subtract m once if >= m
  r.v[0] = add_cc(e[0], o[1]);
#pragma unroll
  for (int k = 1; k < N - 1; ++k) r.v[k] = addc_cc(e[k], o[k + 1]);
  r.v[N - 1] = addc(e[N - 1], 0u);
  d.v[0] = sub_cc(r.v[0], P::mod(0));
#pragma unroll
  for (int k = 1; k < N; ++k) d.v[k] = subc_cc(r.v[k], P::mod(k));
  const uint32_t borrow = subc(0u, 0u);  // 0xffffffff when r < m
  return borrow ? r : d;
}

__device__ __forceinline__ Fp fp_mul_cc(const Fp& a, const Fp& b) { return fe_mul_cc<FpParams>(a, b); }

// out = a * b (Montgomery) over (N, n) limb arrays, one lane a thread.
template <class P>
__global__ void fe_mul_cc_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                                 uint32_t* __restrict__ out, int64_t n) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  fe_store<P>(out, n, lane, fe_mul_cc<P>(fe_load<P>(a, n, lane), fe_load<P>(b, n, lane)));
}
