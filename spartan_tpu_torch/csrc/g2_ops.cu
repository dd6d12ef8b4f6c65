// The one-thread G2 kernels: point.cuh's formulas over Fp2 (Karatsuba
// multiply, complex square), one thread per point, 255 registers with
// spills. The team kernels of g2_team.cu (team.cuh) replaced them on the
// main path; they stay here only so that chip_smoke.py can time the team
// kernels against them. The prover never calls them.
#include "point.cuh"

extern "C" int spk_g2_madd_onethread(const uint32_t* p, const uint32_t* q, uint32_t* out,
                                     int64_t n, cudaStream_t stream) {
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
