// K2: BLS12-381 base field Fp (381 bits, 12 x 32-bit limbs, R = 2^384):
// Montgomery multiply, add and sub over (12, n) limb arrays, the Fermat
// inversion of every lane in one launch (fp_inv.cuh), and Jacobian ->
// affine normalization of G1 and G2 points in one launch (normalize.cuh).
//
// Replaces spartan_tpu/ops/pallas_field.py mont_mul/add/sub (:254-262,
// bodies _mont_mul_arr :106, _add_arr :169, _sub_arr :176) built for FP,
// and the same arithmetic inlined as _Fp in spartan_tpu/ops/pallas_curve.py
// (:40-73). The device functions live in fp.cuh, field.cuh and fp_cc.cuh and
// are shared with the point kernels K3 and K4. The prover launches the
// subtraction alone, for point negation (ops/msm.py _neg_y); the product,
// the sum and the inversion run inside the normalization kernels, and their
// own entry points stay for any caller of ops/field.py. The product runs
// fp_cc.cuh's carry-flag CIOS, one lane a thread, as fr_mul does; field.cuh's
// 64-bit-carry product, which it ran before, stays as the yardstick
// fp_mul_sum64 for chip_smoke.py. Bounds and design: see field.cuh.
#include "fp_inv.cuh"
#include "normalize.cuh"

extern "C" int spk_fp_mul(const uint32_t* a, const uint32_t* b, uint32_t* out, int64_t n,
                          cudaStream_t stream) {
  fe_mul_cc_kernel<FpParams><<<(unsigned)((n + 127) / 128), 128, 0, stream>>>(a, b, out, n);
  return (int)cudaGetLastError();
}

extern "C" int spk_fp_mul_sum64(const uint32_t* a, const uint32_t* b, uint32_t* out, int64_t n,
                                cudaStream_t stream) {
  return fe_binary_launch<FpParams, 0>(a, b, out, n, stream);
}

extern "C" int spk_fp_add(const uint32_t* a, const uint32_t* b, uint32_t* out, int64_t n,
                          cudaStream_t stream) {
  return fe_binary_launch<FpParams, 1>(a, b, out, n, stream);
}

extern "C" int spk_fp_sub(const uint32_t* a, const uint32_t* b, uint32_t* out, int64_t n,
                          cudaStream_t stream) {
  return fe_binary_launch<FpParams, 2>(a, b, out, n, stream);
}

// One warp a lane (fp_inv.cuh). The one-thread version stays only so that
// chip_smoke.py can time the warp against it: on the H100 it is the faster
// of the two up to 1,024 lanes.
extern "C" int spk_fp_inv(const uint32_t* a, uint32_t* out, int64_t n, cudaStream_t stream) {
  return fpinv::launch_warp(a, out, n, stream);
}

extern "C" int spk_fp_inv_thread(const uint32_t* a, uint32_t* out, int64_t n, cudaStream_t stream) {
  return fpinv::launch_thread(a, out, n, stream);
}

// Jacobian -> affine, (3, 12, n) G1 or (6, 12, n) G2 points; path 0 picks
// one warp or one thread a point by width, 1 and 2 force them (for
// chip_smoke.py's timings).
extern "C" int spk_g1_normalize(const uint32_t* p, uint32_t* out, int64_t n, int64_t path,
                                cudaStream_t stream) {
  return aff::launch<3>(p, out, n, path, stream);
}

extern "C" int spk_g2_normalize(const uint32_t* p, uint32_t* out, int64_t n, int64_t path,
                                cudaStream_t stream) {
  return aff::launch<6>(p, out, n, path, stream);
}
