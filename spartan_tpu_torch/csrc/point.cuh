// Short-Weierstrass (a = 0) Jacobian point formulas, written once over the
// coordinate field F, one thread per point: Fp (field.cuh's arithmetic) and
// FpC (the same field on the carry flag, fp_cc.cuh) for the G1 kernels
// (g1_ops.cu), Fp2 for the G2 ones (g2_ops.cu). Of these, the main path runs
// the G1 mixed add over FpC (one launch a prove, about a million lanes);
// its other point kernels are team programs (team.cuh), and g1_ops.cu and
// g2_ops.cu keep this file's versions of them only as yardsticks.
// The formulas and the edge-lane rules are those of the JAX package's
// spartan_tpu/ops/curve.py (double :149, add :171, add_mixed :216), so a
// kernel and the plain PyTorch version return the same Jacobian limbs.
//
// Infinity is Z = 0. add/madd resolve, in this order: P = inf -> Q;
// Q = inf -> P; P == Q -> double(P); otherwise the generic sum (P == -Q then
// has Z = 0). The edge lanes branch, which diverges only on the rare lanes
// that take them.
//
// Point layout: a (C, 12, n) uint32 array, C = 3 coordinates for G1
// (x, y, z) and C = 6 for G2 (x.c0, x.c1, y.c0, y.c1, z.c0, z.c1), one
// point per lane.
//
// What bounds these kernels on an H100: integer multiply-add issue inside
// the Fp multiply at wide widths, and the latency of one thread's chain of
// dependent products at narrow ones; registers: one thread holds every live
// temporary of the formula. Over Fp the formulas fit in a thread's 255
// registers (112 to 250 over field.cuh's Fp, PERF.md), so few warps fit on
// an SM; over Fp2 they need more and ptxas spills to local memory. 128
// threads per block, so a block never runs out of registers; a kernel's
// MINB (__launch_bounds__) caps its registers at 65,536 / (128 MINB). At a
// million lanes the G1 mixed add over FpC is multiply-bound; its product
// keeps two carry chains going in each thread (fp_cc.cuh).
#pragma once

#include "fp_cc.cuh"

// Fp on the carry flag as a coordinate field of its own, so that the
// formulas below run over it.
struct FpC {
  Fp v;
};
__device__ __forceinline__ FpC f_add(const FpC& a, const FpC& b) { return {fp_add_cc(a.v, b.v)}; }
__device__ __forceinline__ FpC f_sub(const FpC& a, const FpC& b) { return {fp_sub_cc(a.v, b.v)}; }
__device__ __forceinline__ FpC f_mul(const FpC& a, const FpC& b) { return {fp_mul_cc(a.v, b.v)}; }
__device__ __forceinline__ FpC f_sqr(const FpC& a) { return {fp_mul_cc(a.v, a.v)}; }
__device__ __forceinline__ bool f_is_zero(const FpC& a) { return fe_is_zero<FpParams>(a.v); }
__device__ __forceinline__ void coord_load(FpC& out, const uint32_t* base, int64_t n, int c,
                                           int64_t lane) {
  coord_load(out.v, base, n, c, lane);
}
__device__ __forceinline__ void coord_store(uint32_t* base, int64_t n, int c, int64_t lane,
                                            const FpC& a) {
  coord_store(base, n, c, lane, a.v);
}

template <class F>
struct Jac {
  F x, y, z;
};

template <class F>
__device__ __forceinline__ F f_dbl(const F& a) {
  return f_add(a, a);
}

// dbl-2009-l: 2M + 5S. Infinity (Z = 0) maps to Z = 0.
template <class F>
__device__ __forceinline__ Jac<F> pt_double(const Jac<F>& p) {
  F a = f_sqr(p.x);
  F b = f_sqr(p.y);
  F c = f_sqr(b);
  F d = f_sub(f_sqr(f_add(p.x, b)), f_add(a, c));
  d = f_dbl(d);
  F e = f_add(f_dbl(a), a);
  F g = f_sqr(e);
  Jac<F> r;
  r.x = f_sub(g, f_dbl(d));
  F c8 = f_dbl(f_dbl(f_dbl(c)));
  r.y = f_sub(f_mul(e, f_sub(d, r.x)), c8);
  r.z = f_dbl(f_mul(p.y, p.z));
  return r;
}

// Full Jacobian add (add-2007-bl shape), complete by the edge rules above.
template <class F>
__device__ __forceinline__ Jac<F> pt_add(const Jac<F>& p, const Jac<F>& q) {
  const bool p_inf = f_is_zero(p.z);
  const bool q_inf = f_is_zero(q.z);
  if (p_inf) return q;
  if (q_inf) return p;
  F z1z1 = f_sqr(p.z);
  F z2z2 = f_sqr(q.z);
  F u1 = f_mul(p.x, z2z2);
  F u2 = f_mul(q.x, z1z1);
  F s1 = f_mul(f_mul(p.y, q.z), z2z2);
  F s2 = f_mul(f_mul(q.y, p.z), z1z1);
  F h = f_sub(u2, u1);
  F r = f_sub(s2, s1);
  if (f_is_zero(h) && f_is_zero(r)) return pt_double(p);
  F h2 = f_sqr(h);
  F h3 = f_mul(h, h2);
  F u1h2 = f_mul(u1, h2);
  F r2 = f_sqr(r);
  Jac<F> o;
  o.x = f_sub(f_sub(r2, h3), f_dbl(u1h2));
  o.y = f_sub(f_mul(r, f_sub(u1h2, o.x)), f_mul(s1, h3));
  o.z = f_mul(f_mul(p.z, q.z), h);
  return o;
}

// Jacobian P + affine-encoded Q (Q.z is one in Montgomery form, or zero for
// infinity): madd-2007-bl, 8M + 3S.
template <class F>
__device__ __forceinline__ Jac<F> pt_madd(const Jac<F>& p, const Jac<F>& q) {
  const bool p_inf = f_is_zero(p.z);
  const bool q_inf = f_is_zero(q.z);
  if (p_inf) return q;
  if (q_inf) return p;
  F z1z1 = f_sqr(p.z);
  F u2 = f_mul(q.x, z1z1);
  F s2 = f_mul(f_mul(q.y, p.z), z1z1);
  F h = f_sub(u2, p.x);
  F r = f_sub(s2, p.y);
  if (f_is_zero(h) && f_is_zero(r)) return pt_double(p);
  F h2 = f_sqr(h);
  F h3 = f_mul(h, h2);
  F u1h2 = f_mul(p.x, h2);
  F r2 = f_sqr(r);
  Jac<F> o;
  o.x = f_sub(f_sub(r2, h3), f_dbl(u1h2));
  o.y = f_sub(f_mul(r, f_sub(u1h2, o.x)), f_mul(p.y, h3));
  o.z = f_mul(p.z, h);
  return o;
}

template <class F>
__device__ __forceinline__ Jac<F> pt_load(const uint32_t* base, int64_t n, int64_t lane) {
  Jac<F> p;
  coord_load(p.x, base, n, 0, lane);
  coord_load(p.y, base, n, 1, lane);
  coord_load(p.z, base, n, 2, lane);
  return p;
}

template <class F>
__device__ __forceinline__ void pt_store(uint32_t* base, int64_t n, int64_t lane, const Jac<F>& p) {
  coord_store(base, n, 0, lane, p.x);
  coord_store(base, n, 1, lane, p.y);
  coord_store(base, n, 2, lane, p.z);
}

// OP: 0 = madd, 1 = add, 2 = double (q unused); MINB: blocks an SM holds.
template <class F, int OP, int MINB = 1>
__global__ void __launch_bounds__(128, MINB) pt_kernel(const uint32_t* __restrict__ p,
                                                       const uint32_t* __restrict__ q,
                                                       uint32_t* __restrict__ out, int64_t n) {
  int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  Jac<F> a = pt_load<F>(p, n, lane);
  Jac<F> r;
  if constexpr (OP == 2) {
    r = pt_double(a);
  } else if constexpr (OP == 0) {
    r = pt_madd(a, pt_load<F>(q, n, lane));
  } else {
    r = pt_add(a, pt_load<F>(q, n, lane));
  }
  pt_store<F>(out, n, lane, r);
}

#ifdef __CUDACC__
template <class F, int OP, int MINB = 1>
static int pt_launch(const uint32_t* p, const uint32_t* q, uint32_t* out, int64_t n,
                     cudaStream_t stream) {
  const int threads = 128;
  const int64_t blocks = (n + threads - 1) / threads;
  pt_kernel<F, OP, MINB><<<(unsigned)blocks, threads, 0, stream>>>(p, q, out, n);
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__
