// K2 Fermat inversion: a^(p-2) mod p for every lane in one launch,
// Montgomery form in and out (a R -> a^-1 R; 0 -> 0). Replaces
// spartan_tpu/ops/field.py inv (:299), the pow_const scan (:276) over the
// Pallas product pallas_field.mont_mul (:254), which the port first ran as
// one fp_mul launch per step: 609 launches per inversion.
//
// What bounds it on an H100. The prover inverts one element at a time (the
// root of batch_inv's product tree), so the card is idle but for one chain
// of dependent Fp products: latency, not multiply issue or bytes.
//
// What the design does about it. The exponent is fixed, so the chain is a
// fixed window of 4 bits over p - 2: 14 products for the table a^2..a^15,
// then 380 squares and 91 table products, 485 in all against 609 for
// square-and-multiply. Two versions of the product run the chain:
//
// - inv_warp_kernel, the one fp_inv launches: one warp per lane, limb j of
//   every value in lane j (warp_mul). A CIOS row is one multiply-add per
//   lane plus two shuffles: the broadcast of the low word that sets the
//   row's Montgomery factor, and the shift down one limb. Limbs stay in
//   64-bit redundant form across the 12 rows; the carries are resolved once
//   per product, by one shuffle and two ballots (carry-lookahead over the
//   ballot masks). 0.30 ms a chain on the H100 (PERF.md).
// - inv_thread_kernel, a yardstick: one thread per lane, fp_cc.cuh's CIOS
//   product, a chain of about 600 dependent carry-flag instructions a
//   product; 0.65 ms a chain. It is the faster one from 4,096 lanes on,
//   where normalize.cuh runs its chain (thread_inv).
//
// normalize.cuh runs both chains (warp_inv, thread_inv) inside its
// Jacobian-to-affine kernels, one chain a point.
//
// Results are canonical, so both give the limbs of the plain chain
// (field.pow_const over mont_mul_plain) whatever the addition chain.
#pragma once

#include "fp_cc.cuh"

namespace fpinv {

constexpr int kWindows = 96;  // 4-bit windows of a 384-bit exponent
constexpr int kWarps = 4;     // lanes (warps) per block of the warp kernel
constexpr uint32_t kFull = 0xffffffffu;

// R mod p (Montgomery one), the table's entry 0.
static __constant__ uint32_t SPK_FP_ONE[12] = {
    0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu, 0x53c758bau, 0x5f489857u,
    0x70525745u, 0x77ce5853u, 0xa256ec6du, 0x5c071a97u, 0xfa80e493u, 0x15f65ec3u};

// Window w (0 = least significant) of p - 2. Windows do not straddle limbs,
// and p's low limb is above 2, so only limb 0 differs from p's.
__device__ __forceinline__ uint32_t digit(int w) {
  const uint32_t limb = FpParams::mod(w / 8) - (w < 8 ? 2u : 0u);
  return (limb >> (4 * (w % 8))) & 15u;
}

// a^(p-2) by one thread: the fixed-window chain over fp_cc.cuh's product.
__device__ __forceinline__ Fp thread_inv(const Fp& a) {
  Fp tab[16];
#pragma unroll
  for (int i = 0; i < 12; ++i) tab[0].v[i] = SPK_FP_ONE[i];
  tab[1] = a;
#pragma unroll 1
  for (int k = 2; k < 16; ++k) tab[k] = fp_mul_cc(tab[k - 1], tab[1]);
  Fp acc = tab[digit(kWindows - 1)];
#pragma unroll 1
  for (int w = kWindows - 2; w >= 0; --w) {
#pragma unroll 1
    for (int s = 0; s < 4; ++s) acc = fp_mul_cc(acc, acc);
    const uint32_t d = digit(w);
    if (d) acc = fp_mul_cc(acc, tab[d]);
  }
  return acc;
}

__global__ void __launch_bounds__(128) inv_thread_kernel(const uint32_t* __restrict__ a,
                                                         uint32_t* __restrict__ out, int64_t n) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  fe_store<FpParams>(out, n, lane, thread_inv(fe_load<FpParams>(a, n, lane)));
}

// The canonical 32-bit limbs of a value held as 64-bit limbs t (lane j:
// limb j, lanes >= 12 zero; the value below 2p). One shuffle passes each
// limb's high word up (limbs then below 2^32 + 2^6, carries single bits);
// two ballots resolve the single-bit carries' ripple, and two more the
// borrows of the subtraction of p: for generate bits G and propagate bits
// P, the carry into bit j is bit j of ((G | P) + G) ^ P.
__device__ __forceinline__ uint32_t warp_canon(uint64_t t, uint32_t pj, int lane) {
  uint32_t c = __shfl_up_sync(kFull, (uint32_t)(t >> 32), 1);
  const uint64_t u = (uint64_t)(uint32_t)t + (lane ? c : 0u);
  uint32_t x = __shfl_up_sync(kFull, (uint32_t)(u >> 32), 1);
  x = lane ? x : 0u;
  uint32_t r = (uint32_t)u + x;
  const uint32_t gen = __ballot_sync(kFull, x != 0u && r == 0u);
  const uint32_t prop = __ballot_sync(kFull, r == 0xffffffffu);
  r += ((((gen | prop) + gen) ^ prop) >> lane) & 1u;
  const uint32_t bgen = __ballot_sync(kFull, r < pj) & 0xfffu;
  const uint32_t bprop = __ballot_sync(kFull, r == pj) & 0xfffu;
  const uint32_t borrow = ((bgen | bprop) + bgen) ^ bprop;  // bit 12: r < p
  const uint32_t d = r - pj - ((borrow >> lane) & 1u);
  return ((borrow >> 12) & 1u) || lane >= 12 ? r : d;
}

// a * b * 2^-384 mod p by one warp: lane j holds limb j of a (aj) and of p
// (pj), lanes >= 12 zero; every lane holds all of b. Returns limb j of the
// canonical product in lane j. t holds the row's limb j, h what the row
// adds to limb j + 1; both are below 2^38 through the 12 rows.
__device__ __forceinline__ uint32_t warp_mul(uint32_t aj, const uint32_t (&b)[12], uint32_t pj,
                                             int lane) {
  uint64_t t = 0;
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    const uint64_t ab = (uint64_t)aj * b[i];
    t += (uint32_t)ab;
    const uint32_t m = __shfl_sync(kFull, (uint32_t)t, 0) * FpParams::INV;
    const uint64_t mp = (uint64_t)m * pj;
    t += (uint32_t)mp;  // limb 0 is now 0 mod 2^32
    const uint64_t h = (ab >> 32) + (mp >> 32);
    const uint64_t up = __shfl_down_sync(kFull, t, 1);
    t = up + h + (lane == 0 ? t >> 32 : 0u);  // divide by 2^32
  }
  return warp_canon(t, pj, lane);
}

// a^(p-2) by one warp: lane j holds limb j of a (aj, lanes >= 12 zero) and
// every lane all of a (b, overwritten); T is the warp's table of 16 values
// in shared memory. Returns limb j of the result in lane j.
__device__ __forceinline__ uint32_t warp_inv(uint32_t aj, uint32_t (&b)[12], uint32_t (*T)[12], uint32_t pj,
                                          int lane) {
  const bool mine = lane < 12;
  uint32_t acc = aj;
  if (mine) {
    T[0][lane] = SPK_FP_ONE[lane];
    T[1][lane] = acc;
  }
#pragma unroll 1
  for (int k = 2; k < 16; ++k) {
    acc = warp_mul(acc, b, pj, lane);
    if (mine) T[k][lane] = acc;
  }
  __syncwarp();
  acc = mine ? T[digit(kWindows - 1)][lane] : 0u;
#pragma unroll 1
  for (int w = kWindows - 2; w >= 0; --w) {
#pragma unroll 1
    for (int s = 0; s < 4; ++s) {
#pragma unroll
      for (int i = 0; i < 12; ++i) b[i] = __shfl_sync(kFull, acc, i);
      acc = warp_mul(acc, b, pj, lane);
    }
    const uint32_t d = digit(w);
    if (d) {
#pragma unroll
      for (int i = 0; i < 12; ++i) b[i] = T[d][i];
      acc = warp_mul(acc, b, pj, lane);
    }
  }
  return acc;
}

__global__ void __launch_bounds__(32 * kWarps) inv_warp_kernel(const uint32_t* __restrict__ a,
                                                               uint32_t* __restrict__ out,
                                                               int64_t n) {
  __shared__ uint32_t tab[kWarps][16][12];
  const int lane = threadIdx.x % 32, wid = threadIdx.x / 32;
  const int64_t e = (int64_t)blockIdx.x * kWarps + wid;
  if (e >= n) return;  // the whole warp
  const bool mine = lane < 12;
  const uint32_t pj = mine ? FpParams::mod(lane) : 0u;
  uint32_t b[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) b[i] = a[(int64_t)i * n + e];
  const uint32_t acc = warp_inv(mine ? a[(int64_t)lane * n + e] : 0u, b, tab[wid], pj, lane);
  if (mine) out[(int64_t)lane * n + e] = acc;
}

#ifdef __CUDACC__
static int launch_thread(const uint32_t* a, uint32_t* out, int64_t n, cudaStream_t stream) {
  inv_thread_kernel<<<(unsigned)((n + 127) / 128), 128, 0, stream>>>(a, out, n);
  return (int)cudaGetLastError();
}

static int launch_warp(const uint32_t* a, uint32_t* out, int64_t n, cudaStream_t stream) {
  inv_warp_kernel<<<(unsigned)((n + kWarps - 1) / kWarps), 32 * kWarps, 0, stream>>>(a, out, n);
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__

}  // namespace fpinv
