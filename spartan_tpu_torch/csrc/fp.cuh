// BLS12-381 base field Fp (381 bits, 12 x 32-bit limbs, R = 2^384) and its
// quadratic extension Fp2 = Fp[u]/(u^2 + 1). Shared by the Fp field kernels
// (fp_ops.cu) and both point kernels (g1_ops.cu, g2_ops.cu).
#pragma once

#include "field.cuh"

static __constant__ uint32_t SPK_FP_MOD[12] = {
    0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu, 0xf6b0f624u, 0x6730d2a0u,
    0xf38512bfu, 0x64774b84u, 0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};

struct FpParams {
  static constexpr int N = 12;
  static constexpr uint32_t INV = 0xfffcfffdu;  // -p^-1 mod 2^32
  static constexpr uint32_t TOP = 0x1a0111eau;  // the top limb, SPK_FP_MOD[11]
  static __device__ __forceinline__ uint32_t mod(int i) { return SPK_FP_MOD[i]; }
};

using Fp = Fe<FpParams>;

struct Fp2 {
  Fp c0, c1;
};

// -- the field interface the point formulas (point.cuh) are written against --

__device__ __forceinline__ Fp f_add(const Fp& a, const Fp& b) { return fe_add<FpParams>(a, b); }
__device__ __forceinline__ Fp f_sub(const Fp& a, const Fp& b) { return fe_sub<FpParams>(a, b); }
__device__ __forceinline__ Fp f_mul(const Fp& a, const Fp& b) { return fe_mul<FpParams>(a, b); }
__device__ __forceinline__ Fp f_sqr(const Fp& a) { return fe_mul<FpParams>(a, a); }
__device__ __forceinline__ bool f_is_zero(const Fp& a) { return fe_is_zero<FpParams>(a); }

__device__ __forceinline__ Fp2 f_add(const Fp2& a, const Fp2& b) {
  return {f_add(a.c0, b.c0), f_add(a.c1, b.c1)};
}
__device__ __forceinline__ Fp2 f_sub(const Fp2& a, const Fp2& b) {
  return {f_sub(a.c0, b.c0), f_sub(a.c1, b.c1)};
}
// Karatsuba: 3 Fp multiplies.
__device__ __forceinline__ Fp2 f_mul(const Fp2& a, const Fp2& b) {
  Fp t0 = f_mul(a.c0, b.c0);
  Fp t1 = f_mul(a.c1, b.c1);
  Fp t2 = f_mul(f_add(a.c0, a.c1), f_add(b.c0, b.c1));
  return {f_sub(t0, t1), f_sub(f_sub(t2, t0), t1)};
}
// Complex squaring: (a0 + a1)(a0 - a1) + 2 a0 a1 u, 2 Fp multiplies.
__device__ __forceinline__ Fp2 f_sqr(const Fp2& a) {
  Fp t0 = f_mul(f_add(a.c0, a.c1), f_sub(a.c0, a.c1));
  Fp t1 = f_mul(a.c0, a.c1);
  return {t0, f_add(t1, t1)};
}
__device__ __forceinline__ bool f_is_zero(const Fp2& a) {
  return f_is_zero(a.c0) && f_is_zero(a.c1);
}

// -- coordinate load/store for the (C, 12, n) point layout --

__device__ __forceinline__ void coord_load(Fp& out, const uint32_t* base, int64_t n, int c,
                                           int64_t lane) {
  out = fe_load<FpParams>(base + (int64_t)c * FpParams::N * n, n, lane);
}
__device__ __forceinline__ void coord_store(uint32_t* base, int64_t n, int c, int64_t lane,
                                            const Fp& a) {
  fe_store<FpParams>(base + (int64_t)c * FpParams::N * n, n, lane, a);
}
__device__ __forceinline__ void coord_load(Fp2& out, const uint32_t* base, int64_t n, int c,
                                           int64_t lane) {
  coord_load(out.c0, base, n, 2 * c, lane);
  coord_load(out.c1, base, n, 2 * c + 1, lane);
}
__device__ __forceinline__ void coord_store(uint32_t* base, int64_t n, int c, int64_t lane,
                                            const Fp2& a) {
  coord_store(base, n, 2 * c, lane, a.c0);
  coord_store(base, n, 2 * c + 1, lane, a.c1);
}
