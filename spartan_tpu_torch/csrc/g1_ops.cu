// K3's one-thread G1 kernels: point.cuh's formulas over Fp, one thread per
// point. The mixed add (spartan_tpu/ops/pallas_curve.py g1_madd :385,
// _g1_madd_kernel :228 / _madd_rows_pts :172) still runs here on the main
// path: the prover launches it once, at about a million lanes (the commit
// MSM's first bucket level), where a thread a point fills the card and the
// one-thread latency that the team kernels cut does not show. No team
// program for it is written yet. The add and the double run as team
// kernels (g1_team.cu); their one-thread versions stay here only so that
// chip_smoke.py can time the team kernels against them.
#include "point.cuh"

extern "C" int spk_g1_madd(const uint32_t* p, const uint32_t* q, uint32_t* out, int64_t n,
                           cudaStream_t stream) {
  return pt_launch<Fp, 0>(p, q, out, n, stream);
}

extern "C" int spk_g1_add_onethread(const uint32_t* p, const uint32_t* q, uint32_t* out,
                                    int64_t n, cudaStream_t stream) {
  return pt_launch<Fp, 1>(p, q, out, n, stream);
}

extern "C" int spk_g1_double_onethread(const uint32_t* p, uint32_t* out, int64_t n,
                                       cudaStream_t stream) {
  return pt_launch<Fp, 2>(p, nullptr, out, n, stream);
}
