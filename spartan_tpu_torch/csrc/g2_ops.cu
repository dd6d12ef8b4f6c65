// K4: the G2 mixed add over (6, 12, n) Jacobian point arrays, one thread
// per point: point.cuh's formulas over Fp2 (Karatsuba multiply, complex
// square). Replaces spartan_tpu/ops/pallas_curve.py g2_madd (:410,
// _g2_madd_kernel :240). Register-bound: 255 registers a thread, with
// spills (point.cuh).
//
// The one-thread G2 add and double of point.cuh stay here only so that
// chip_smoke.py can time the team kernels (g2_team.cu) against them; the
// prover never calls them.
#include "point.cuh"

extern "C" int spk_g2_madd(const uint32_t* p, const uint32_t* q, uint32_t* out, int64_t n,
                           cudaStream_t stream) {
  return pt_launch<Fp2, 0>(p, q, out, n, stream);
}

extern "C" int spk_g2_add_onethread(const uint32_t* p, const uint32_t* q, uint32_t* out,
                                    int64_t n, cudaStream_t stream) {
  return pt_launch<Fp2, 1>(p, q, out, n, stream);
}

extern "C" int spk_g2_double_onethread(const uint32_t* p, uint32_t* out, int64_t n,
                                       cudaStream_t stream) {
  return pt_launch<Fp2, 2>(p, nullptr, out, n, stream);
}
