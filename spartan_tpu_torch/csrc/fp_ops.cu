// K2: BLS12-381 base field Fp (381 bits, 12 x 32-bit limbs, R = 2^384):
// Montgomery multiply, add and sub over (12, n) limb arrays, and the
// Fermat inversion of every lane in one launch (fp_inv.cuh).
//
// Replaces spartan_tpu/ops/pallas_field.py mont_mul/add/sub (:254-262,
// bodies _mont_mul_arr :106, _add_arr :169, _sub_arr :176) built for FP,
// and the same arithmetic inlined as _Fp in spartan_tpu/ops/pallas_curve.py
// (:40-73). The device functions live in fp.cuh/field.cuh and are shared
// with the point kernels K3 and K4; this file launches them alone, for the
// batched inversions of Jacobian -> affine normalization and point negation.
// Bounds and design: see field.cuh.
#include "fp_inv.cuh"

extern "C" int spk_fp_mul(const uint32_t* a, const uint32_t* b, uint32_t* out, int64_t n,
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
// of the two up to 1,024 lanes, and the prover inverts one lane at a time.
extern "C" int spk_fp_inv(const uint32_t* a, uint32_t* out, int64_t n, cudaStream_t stream) {
  return fpinv::launch_warp(a, out, n, stream);
}

extern "C" int spk_fp_inv_thread(const uint32_t* a, uint32_t* out, int64_t n, cudaStream_t stream) {
  return fpinv::launch_thread(a, out, n, stream);
}
