// K3's G1 mixed add and the one-thread G1 yardsticks: point.cuh's formulas,
// one thread per point.
//
// The mixed add replaces spartan_tpu/ops/pallas_curve.py g1_madd (:385,
// _g1_madd_kernel :228 / _madd_rows_pts :172). The prover launches it once
// a prove, at the commit MSM's first bucket level (about a million lanes;
// keygen's fixed-base MSM launches it too), where the card is full and the
// kernel is bound by 32-bit multiply throughput: 11 Fp products a point.
// It runs point.cuh's madd-2007-bl over Fp on the carry flag (FpC, whose
// product keeps two independent carry chains, fp_cc.cuh), every value in
// registers, capped at 168 registers so that three blocks of 128 fit on an
// SM (four blocks cost 344 bytes of spills and were no faster, two were
// slower; PERF.md, PR 5). On the H100 that beat the team program
// (g1_team.cu) at every width measured from 65,536 lanes up.
//
// PR 1's add, mixed add and double over field.cuh's Fp stay here only so
// that chip_smoke.py can time the kernels that replaced them against them;
// the prover never calls them.
#include "point.cuh"

extern "C" int spk_g1_madd(const uint32_t* p, const uint32_t* q, uint32_t* out, int64_t n,
                           cudaStream_t stream) {
  return pt_launch<FpC, 0, 3>(p, q, out, n, stream);
}

extern "C" int spk_g1_madd_onethread(const uint32_t* p, const uint32_t* q, uint32_t* out,
                                     int64_t n, cudaStream_t stream) {
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
