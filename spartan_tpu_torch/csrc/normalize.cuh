// K2 Jacobian -> affine normalization of G1 and G2 points in one launch:
// (x, y, z) -> (x z^-2, y z^-3, 1), and infinity (z = 0) -> (0, 0, 0), over
// (C, 12, n) Montgomery Fp limbs, C = 3 (G1) or 6 (G2: c0, c1 of x, y, z).
// Replaces spartan_tpu/ops/curve.py normalize (:270) and the affine
// encoding around it (spartan_tpu/commitment/scheme.py _normalize_g1 :48,
// _normalize_g2 :59): a batched inversion (field.py inv :299 over the
// Pallas mont_mul, pallas_field.py:254) and Fp2 products and sums, which
// the port first ran as about 21 launches of fp_mul, fp_add, fp_sub and
// fp_inv a call (batch_inv's product tree, then fp2's products).
//
// What bounds it on an H100. The prover normalizes 1 G1 point (the
// commitment) and 16 G2 points (an opening's proofs) at a time: each lane
// is one chain of about 490 dependent Fp products, so a call takes one
// chain's latency whatever the width, and the launch count is what the
// design can cut. Setup normalizes 8,192 to 131,070 points a call; there the
// chains' products are the work (about 490 x 288 32-bit products a lane).
//
// What the design does about it. Each lane inverts its own z by Fermat,
// z^(p-2), with fp_inv.cuh's chains, then forms z^-2, z^-3 and the affine
// coordinates in the same launch; G2 inverts the norm z0^2 + z1^2 and takes
// z^-1 = conj(z) / norm, one chain a point. No product tree across lanes:
// with one chain a lane the 16 G2 points' chains run side by side.
// - Below kThreadFrom lanes, one warp a lane (fp_inv.cuh's warp_mul: limb j
//   of the left factor in lane j, every lane all of the right one); values
//   are held whole in every lane (wfull: 12 shuffles) between products,
//   and the sums and differences run on whole values in every lane.
// - From kThreadFrom lanes, one thread a lane on fp_cc.cuh's product
//   (thread_inv), the faster chain at those widths (PERF.md, fp_inv).
// Every value is canonical, so the limbs equal the plain version's (the
// JAX package's formulas over the plain Fp ops), whatever the formulas.
#pragma once

#include "fp_inv.cuh"

namespace aff {

using fpinv::kFull;
constexpr int kWarps = 4;              // points (warps) a block of the warp kernels
constexpr int64_t kThreadFrom = 4096;  // from here one thread a point

// The whole value whose limb j lane j holds (lanes >= 12 hold 0).
__device__ __forceinline__ Fp wfull(uint32_t vj) {
  Fp r;
#pragma unroll
  for (int i = 0; i < 12; ++i) r.v[i] = __shfl_sync(kFull, vj, i);
  return r;
}

// Limb `lane` of a whole value (0 from lane 12 on).
__device__ __forceinline__ uint32_t wlimb(const Fp& a, int lane) {
  uint32_t r = 0u;
#pragma unroll
  for (int i = 0; i < 12; ++i) r = lane == i ? a.v[i] : r;
  return r;
}

// a b R^-1 of whole values, whole, by the warp. One called copy, not
// inlined at each of the 4 (G1) to 16 (G2) products after the chain: the
// code after the chain runs once a launch, so each of its instruction-cache
// lines is a miss, and on the H100 four inlined copies cost a 1-point G1
// launch 0.06 ms where the calls cost nothing measurable (PERF.md).
static __device__ __noinline__ Fp wmul(Fp a, Fp b, uint32_t pj, int lane) {
  return wfull(fpinv::warp_mul(wlimb(a, lane), b.v, pj, lane));
}

// Karatsuba over Fp2 = Fp[u]/(u^2 + 1), as fp2.mul2, over the product mul.
template <class Mul>
__device__ __forceinline__ Fp2 karatsuba(const Mul& mul, const Fp2& a, const Fp2& b) {
  const Fp t0 = mul(a.c0, b.c0), t1 = mul(a.c1, b.c1);
  const Fp t2 = mul(fp_add_cc(a.c0, a.c1), fp_add_cc(b.c0, b.c1));
  return {fp_sub_cc(t0, t1), fp_sub_cc(t2, fp_add_cc(t0, t1))};
}

// The Fp2 product by the warp, one called copy as wmul.
static __device__ __noinline__ Fp2 wmul2(Fp2 a, Fp2 b, uint32_t pj, int lane) {
  return karatsuba([&](const Fp& x, const Fp& y) { return wmul(x, y, pj, lane); }, a, b);
}

// a^(p-2) by the warp (fp_inv.cuh's chain), whole; T the warp's table in
// shared memory. One called copy too: inlined into the G2 kernel, whose
// point stays live across it, the chain took 0.07 ms more (PERF.md).
static __device__ __noinline__ Fp winv(Fp a, uint32_t (*T)[12], uint32_t pj, int lane) {
  uint32_t b[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) b[i] = a.v[i];
  return wfull(fpinv::warp_inv(wlimb(a, lane), b, T, pj, lane));
}

// The field interface the formulas below are written against: one thread a
// lane (Thread) or one warp a lane (Warp), values whole in every thread.
struct Thread {
  __device__ __forceinline__ Fp mul(const Fp& a, const Fp& b) const { return fp_mul_cc(a, b); }
  __device__ __forceinline__ Fp2 mul2(const Fp2& a, const Fp2& b) const {
    return karatsuba([](const Fp& x, const Fp& y) { return fp_mul_cc(x, y); }, a, b);
  }
  __device__ __forceinline__ Fp inv(const Fp& a) const { return fpinv::thread_inv(a); }
};

struct Warp {
  uint32_t (*T)[12];  // the warp's table of the chain, in shared memory
  uint32_t pj;
  int lane;
  __device__ __forceinline__ Fp mul(const Fp& a, const Fp& b) const { return wmul(a, b, pj, lane); }
  __device__ __forceinline__ Fp2 mul2(const Fp2& a, const Fp2& b) const { return wmul2(a, b, pj, lane); }
  __device__ __forceinline__ Fp inv(const Fp& a) const { return winv(a, T, pj, lane); }
};

__device__ __forceinline__ Fp one_mont() {
  Fp r;
#pragma unroll
  for (int i = 0; i < 12; ++i) r.v[i] = fpinv::SPK_FP_ONE[i];
  return r;
}


// (x, y, z) of one point -> its affine encoding, in place; fe_zero for infinity.
template <class F>
__device__ __forceinline__ void affine_g1(const F& f, Fp& x, Fp& y, Fp& z) {
  const bool inf = fe_is_zero<FpParams>(z);
  const Fp zi = f.inv(z);
  const Fp zi2 = f.mul(zi, zi);
  const Fp zi3 = f.mul(zi2, zi);
  x = f.mul(x, zi2);
  y = f.mul(y, zi3);
  z = one_mont();
  if (inf) x = y = z = fe_zero<FpParams>();
}

template <class F>
__device__ __forceinline__ void affine_g2(const F& f, Fp2& x, Fp2& y, Fp2& z) {
  const bool inf = fe_is_zero<FpParams>(z.c0) && fe_is_zero<FpParams>(z.c1);
  const Fp ninv = f.inv(fp_add_cc(f.mul(z.c0, z.c0), f.mul(z.c1, z.c1)));
  const Fp2 zi = {f.mul(z.c0, ninv), fp_sub_cc(fe_zero<FpParams>(), f.mul(z.c1, ninv))};
  const Fp2 zi2 = f.mul2(zi, zi);
  const Fp2 zi3 = f.mul2(zi2, zi);
  x = f.mul2(x, zi2);
  y = f.mul2(y, zi3);
  z = {one_mont(), fe_zero<FpParams>()};
  if (inf) x = y = z = {fe_zero<FpParams>(), fe_zero<FpParams>()};
}

// Coordinate c of lane e of a (C, 12, n) point array, whole.
__device__ __forceinline__ Fp load_coord(const uint32_t* p, int64_t n, int c, int64_t e) {
  return fe_load<FpParams>(p + (int64_t)c * 12 * n, n, e);
}

// The C = 3 (G1) or 6 (G2) coordinates of a point -> its affine encoding.
template <int C, class F>
__device__ __forceinline__ void affine(Fp (&v)[C], const F& f) {
  if constexpr (C == 3) {
    affine_g1(f, v[0], v[1], v[2]);
  } else {
    Fp2 x = {v[0], v[1]}, y = {v[2], v[3]}, z = {v[4], v[5]};
    affine_g2(f, x, y, z);
    v[0] = x.c0, v[1] = x.c1, v[2] = y.c0, v[3] = y.c1, v[4] = z.c0, v[5] = z.c1;
  }
}

template <int C>
__global__ void __launch_bounds__(128) normalize_thread_kernel(const uint32_t* __restrict__ p,
                                                               uint32_t* __restrict__ out, int64_t n) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  Fp v[C];
#pragma unroll
  for (int c = 0; c < C; ++c) v[c] = load_coord(p, n, c, e);
  affine(v, Thread{});
#pragma unroll
  for (int c = 0; c < C; ++c) fe_store<FpParams>(out + (int64_t)c * 12 * n, n, e, v[c]);
}

template <int C>
__global__ void __launch_bounds__(32 * kWarps) normalize_warp_kernel(const uint32_t* __restrict__ p,
                                                                     uint32_t* __restrict__ out, int64_t n) {
  __shared__ uint32_t tab[kWarps][16][12];
  const int lane = threadIdx.x % 32, wid = threadIdx.x / 32;
  const int64_t e = (int64_t)blockIdx.x * kWarps + wid;
  if (e >= n) return;  // the whole warp
  const bool mine = lane < 12;
  Fp v[C];
#pragma unroll
  for (int c = 0; c < C; ++c) v[c] = load_coord(p, n, c, e);
  affine(v, Warp{tab[wid], mine ? FpParams::mod(lane) : 0u, lane});
  if (mine) {
#pragma unroll
    for (int c = 0; c < C; ++c) out[((int64_t)c * 12 + lane) * n + e] = wlimb(v[c], lane);
  }
}

#ifdef __CUDACC__
// path: 0 by width, 1 one warp a point, 2 one thread a point
template <int C>
static int launch(const uint32_t* p, uint32_t* out, int64_t n, int64_t path, cudaStream_t stream) {
  if (n < 1 || path < 0 || path > 2) return (int)cudaErrorInvalidValue;
  if (path == 2 || (path == 0 && n >= kThreadFrom))
    normalize_thread_kernel<C><<<(unsigned)((n + 127) / 128), 128, 0, stream>>>(p, out, n);
  else
    normalize_warp_kernel<C><<<(unsigned)((n + kWarps - 1) / kWarps), 32 * kWarps, 0, stream>>>(p, out, n);
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__

}  // namespace aff
