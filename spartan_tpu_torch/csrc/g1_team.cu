// K3: the G1 add and 2^k-fold double, one team of threads per point
// (team.cuh says what bounds them and what the team design does about it).
// They replace spartan_tpu/ops/pallas_curve.py g1_add (:378,
// _g1_add_kernel :216 / _add_rows_pts :134) and g1_double (:392,
// _g1_double_kernel :255 / _double_rows :118).
//
// The team sizes come from measurements on the H100 (chip_smoke.py phase 2,
// PERF.md). The add picks it by lane count: 8 threads a point while the
// card has lanes to spare, fewer as the points fill it (the prove's bucket
// sums launch it at up to 521,701 lanes). The double runs 8 threads a point
// at every width: the prove launches it at 1 and 32 lanes only. The *_team
// entry points take the team size, for those measurements; the prover
// never calls them.
#include "team.cuh"

using team::G1;
using team::kAdd;
using team::kDouble;

static int add_team(int64_t n) { return n <= 4096 ? 8 : n <= 16384 ? 4 : 2; }

extern "C" int spk_g1_add(const uint32_t* p, const uint32_t* q, uint32_t* out, int64_t n,
                          cudaStream_t stream) {
  return team::launch<G1, kAdd>(p, q, out, n, 0, add_team(n), stream);
}

extern "C" int spk_g1_double(const uint32_t* p, uint32_t* out, int64_t n, int k,
                             cudaStream_t stream) {
  return team::launch<G1, kDouble>(p, nullptr, out, n, k, 8, stream);
}

extern "C" int spk_g1_add_team(const uint32_t* p, const uint32_t* q, uint32_t* out, int64_t n,
                               int team_size, cudaStream_t stream) {
  return team::launch<G1, kAdd>(p, q, out, n, 0, team_size, stream);
}

extern "C" int spk_g1_double_team(const uint32_t* p, uint32_t* out, int64_t n, int k,
                                  int team_size, cudaStream_t stream) {
  return team::launch<G1, kDouble>(p, nullptr, out, n, k, team_size, stream);
}
