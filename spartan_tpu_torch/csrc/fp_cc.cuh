// Fp arithmetic on the PTX carry flag (add.cc, mad.lo.cc, madc.hi.cc):
// field.cuh's CIOS product and its canonical add and subtract, one
// instruction a limb where field.cuh's 64-bit sums take two dependent ones.
// Same results; faster at every width measured on the H100 (PERF.md). Used by the
// team G2 kernels (g2_team.cuh) and the one-thread Fermat inversion
// (fp_ops.cu). The host branch runs the same code on a software carry flag,
// for the host pass of nvcc and for g++.
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

// a * b * 2^-384 mod p: CIOS as in field.cuh, each row's low and high
// halves added along the carry flag.
__device__ __forceinline__ Fp fp_mul_cc(const Fp& a, const Fp& b) {
  constexpr int N = FpParams::N;
  uint32_t t[N + 2];
#pragma unroll
  for (int i = 0; i < N + 2; ++i) t[i] = 0u;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const uint32_t bi = b.v[i];
    t[0] = madlo_cc(a.v[0], bi, t[0]);
#pragma unroll
    for (int j = 1; j < N; ++j) t[j] = madclo_cc(a.v[j], bi, t[j]);
    t[N] = addc_cc(t[N], 0u);
    t[N + 1] = addc(t[N + 1], 0u);
    t[1] = madhi_cc(a.v[0], bi, t[1]);
#pragma unroll
    for (int j = 1; j < N; ++j) t[j + 1] = madchi_cc(a.v[j], bi, t[j + 1]);
    t[N + 1] = addc(t[N + 1], 0u);

    const uint32_t m = t[0] * FpParams::INV;
    t[0] = madlo_cc(m, FpParams::mod(0), t[0]);  // 0, and a carry
#pragma unroll
    for (int j = 1; j < N; ++j) t[j] = madclo_cc(m, FpParams::mod(j), t[j]);
    t[N] = addc_cc(t[N], 0u);
    t[N + 1] = addc(t[N + 1], 0u);
    t[1] = madhi_cc(m, FpParams::mod(0), t[1]);
#pragma unroll
    for (int j = 1; j < N; ++j) t[j + 1] = madchi_cc(m, FpParams::mod(j), t[j + 1]);
    t[N + 1] = addc(t[N + 1], 0u);
#pragma unroll
    for (int j = 0; j < N + 1; ++j) t[j] = t[j + 1];  // divide by 2^32
    t[N + 1] = 0u;
  }
  Fp r, d;  // t < 2p: subtract p once if t >= p
#pragma unroll
  for (int k = 0; k < N; ++k) r.v[k] = t[k];
  d.v[0] = sub_cc(t[0], FpParams::mod(0));
#pragma unroll
  for (int k = 1; k < N; ++k) d.v[k] = subc_cc(t[k], FpParams::mod(k));
  const uint32_t borrow = subc(t[N], 0u);  // 0xffffffff when t < p
  return borrow ? r : d;
}
