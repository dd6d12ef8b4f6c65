// What inlined copies of the warp product cost after the Fermat chain, on
// one point (csrc/normalize.cuh). Each kernel runs the chain of fp_inv.cuh
// on z of one G1 point and then: nothing more (the chain alone), one inlined
// product, four inlined products (x z^-2, y z^-3 and the powers, as
// normalize's G1 path did), four calls of one copy (normalize's wmul); and
// the entry point's own kernel. Device ms a launch, CUDA events over 20
// launches, twice; and G2: the entry point's kernel (the chain one called
// copy, winv, and the products, wmul and wmul2), and the same work stage by
// stage. Run on a card:
//   bash scripts/warp_product_copies/run.sh
#include <cstdio>

#include "normalize.cuh"

using namespace aff;

__device__ __forceinline__ Fp wmul_inline(const Fp& a, const Fp& b, uint32_t pj, int lane) {
  return wfull(fpinv::warp_mul(wlimb(a, lane), b.v, pj, lane));
}

// products after the chain: 0, 1 or 4, inlined (INLINE) or called (wmul)
template <int PRODUCTS, bool INLINE>
__global__ void __launch_bounds__(32 * kWarps) chain_then(const uint32_t* p, uint32_t* out, int64_t n) {
  __shared__ uint32_t tab[kWarps][16][12];
  const int lane = threadIdx.x % 32, wid = threadIdx.x / 32;
  const int64_t e = (int64_t)blockIdx.x * kWarps + wid;
  if (e >= n) return;
  const bool mine = lane < 12;
  const uint32_t pj = mine ? FpParams::mod(lane) : 0u;
  Fp v[3];
  for (int c = 0; c < 3; ++c) v[c] = load_coord(p, n, c, e);
  uint32_t b[12];
  for (int i = 0; i < 12; ++i) b[i] = v[2].v[i];
  Fp x = wfull(fpinv::warp_inv(wlimb(v[2], lane), b, tab[wid], pj, lane)), y = v[1];
  auto mul = [&](const Fp& a, const Fp& c) { return INLINE ? wmul_inline(a, c, pj, lane) : wmul(a, c, pj, lane); };
  if (PRODUCTS == 1) x = mul(v[0], x);
  if (PRODUCTS == 4) {
    const Fp zi2 = mul(x, x), zi3 = mul(zi2, x);
    x = mul(v[0], zi2);
    y = mul(v[1], zi3);
  }
  if (mine) {
    out[lane * n + e] = wlimb(x, lane);
    out[(12 + lane) * n + e] = wlimb(y, lane);
  }
}

// G2 up to a stage, the chain as Warp::inv runs it: 0 the norm and the
// chain, 1 and z^-1, 2 and z^-2, z^-3, 3 and the affine x, y
template <int STAGE>
__global__ void __launch_bounds__(32 * kWarps) g2_stage(const uint32_t* p, uint32_t* out, int64_t n) {
  __shared__ uint32_t tab[kWarps][16][12];
  const int lane = threadIdx.x % 32, wid = threadIdx.x / 32;
  const int64_t e = (int64_t)blockIdx.x * kWarps + wid;
  if (e >= n) return;
  const bool mine = lane < 12;
  const Warp f{tab[wid], mine ? FpParams::mod(lane) : 0u, lane};
  Fp v[6];
  for (int c = 0; c < 6; ++c) v[c] = load_coord(p, n, c, e);
  Fp2 x = {v[0], v[1]}, y = {v[2], v[3]}, z = {v[4], v[5]};
  const Fp ninv = f.inv(fp_add_cc(f.mul(z.c0, z.c0), f.mul(z.c1, z.c1)));
  Fp2 r = {ninv, ninv};
  if (STAGE >= 1) r = {f.mul(z.c0, ninv), fp_sub_cc(fe_zero<FpParams>(), f.mul(z.c1, ninv))};
  if (STAGE >= 2) {
    const Fp2 zi2 = f.mul2(r, r);
    r = f.mul2(zi2, r);
    if (STAGE >= 3) {
      x = f.mul2(x, zi2);
      y = f.mul2(y, r);
      r = {fp_add_cc(x.c0, y.c0), fp_add_cc(x.c1, y.c1)};
    }
  }
  if (mine) {
    out[lane * n + e] = wlimb(r.c0, lane);
    out[(12 + lane) * n + e] = wlimb(r.c1, lane);
  }
}

template <class K>
float time_it(K k, const uint32_t* p, uint32_t* out) {
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  k<<<1, 32 * kWarps>>>(p, out, 1);
  cudaEventRecord(a);
  for (int i = 0; i < 20; ++i) k<<<1, 32 * kWarps>>>(p, out, 1);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms;
  cudaEventElapsedTime(&ms, a, b);
  return ms / 20;
}

int main() {
  uint32_t h[36];  // one point, each coordinate below p
  for (int i = 0; i < 36; ++i) h[i] = 0x1234567u * (i + 1);
  for (int c = 0; c < 3; ++c) h[c * 12 + 11] &= 0x0fffffffu;
  uint32_t *p, *p6, *out;
  cudaMalloc(&p, sizeof h);
  cudaMalloc(&p6, 2 * sizeof h);  // one G2 point: the six coordinates, each below p
  cudaMalloc(&out, 2 * sizeof h);
  cudaMemcpy(p, h, sizeof h, cudaMemcpyHostToDevice);
  cudaMemcpy(p6, h, sizeof h, cudaMemcpyHostToDevice);
  cudaMemcpy(p6 + 36, h, sizeof h, cudaMemcpyHostToDevice);
  for (int rep = 0; rep < 2; ++rep) {
    printf("fp_inv's warp kernel (the chain)      %.4f ms\n", time_it(fpinv::inv_warp_kernel, p + 24, out));
    printf("chain, no product                     %.4f ms\n", time_it(chain_then<0, true>, p, out));
    printf("chain, one inlined product            %.4f ms\n", time_it(chain_then<1, true>, p, out));
    printf("chain, four inlined products          %.4f ms\n", time_it(chain_then<4, true>, p, out));
    printf("chain, four calls of one copy (wmul)  %.4f ms\n", time_it(chain_then<4, false>, p, out));
    printf("normalize_warp_kernel<3> (the entry)  %.4f ms\n", time_it(normalize_warp_kernel<3>, p, out));
    printf("normalize_warp_kernel<6> (G2 entry)   %.4f ms\n", time_it(normalize_warp_kernel<6>, p6, out));
    printf("G2: the norm and the chain            %.4f ms\n", time_it(g2_stage<0>, p6, out));
    printf("G2: and z^-1                          %.4f ms\n", time_it(g2_stage<1>, p6, out));
    printf("G2: and z^-2, z^-3                    %.4f ms\n", time_it(g2_stage<2>, p6, out));
    printf("G2: and x z^-2, y z^-3                %.4f ms\n", time_it(g2_stage<3>, p6, out));
  }
  const cudaError_t err = cudaGetLastError();
  printf("cuda: %s\n", cudaGetErrorString(err));
  return err == cudaSuccess ? 0 : 1;
}
