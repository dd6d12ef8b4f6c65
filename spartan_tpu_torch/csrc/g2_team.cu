// K4: the G2 add, mixed add and 2^k-fold double, one team of threads per
// point (team.cuh says what bounds them and what the team design does about
// it). They replace spartan_tpu/ops/pallas_curve.py g2_add (:399,
// _g2_add_kernel :264), g2_madd (:410, _g2_madd_kernel :240) and g2_double
// (:421, _g2_double_kernel :279).
//
// The entry points pick the team size by lane count, from measurements on
// the H100 (chip_smoke.py phase 2, PERF.md): 16 threads a point while the
// card has lanes to spare, fewer as the points fill it. The *_team entry
// points take the team size, for those measurements; the prover never
// calls them.
#include "team.cuh"

using team::G2;
using team::kAdd;
using team::kDouble;
using team::kMadd;

static int add_team(int64_t n) { return n <= 2048 ? 16 : 8; }
static int madd_team(int64_t n) { return n <= 2048 ? 16 : n <= 65536 ? 8 : 4; }
static int double_team(int64_t n) { return n <= 2048 ? 16 : n <= 8192 ? 8 : 4; }

extern "C" int spk_g2_add(const uint32_t* p, const uint32_t* q, uint32_t* out, int64_t n,
                          cudaStream_t stream) {
  return team::launch<G2, kAdd>(p, q, out, n, 0, add_team(n), stream);
}

extern "C" int spk_g2_madd(const uint32_t* p, const uint32_t* q, uint32_t* out, int64_t n,
                           cudaStream_t stream) {
  return team::launch<G2, kMadd>(p, q, out, n, 0, madd_team(n), stream);
}

extern "C" int spk_g2_double(const uint32_t* p, uint32_t* out, int64_t n, int k,
                             cudaStream_t stream) {
  return team::launch<G2, kDouble>(p, nullptr, out, n, k, double_team(n), stream);
}

extern "C" int spk_g2_add_team(const uint32_t* p, const uint32_t* q, uint32_t* out, int64_t n,
                               int team_size, cudaStream_t stream) {
  return team::launch<G2, kAdd>(p, q, out, n, 0, team_size, stream);
}

extern "C" int spk_g2_madd_team(const uint32_t* p, const uint32_t* q, uint32_t* out, int64_t n,
                                int team_size, cudaStream_t stream) {
  return team::launch<G2, kMadd>(p, q, out, n, 0, team_size, stream);
}

extern "C" int spk_g2_double_team(const uint32_t* p, uint32_t* out, int64_t n, int k,
                                  int team_size, cudaStream_t stream) {
  return team::launch<G2, kDouble>(p, nullptr, out, n, k, team_size, stream);
}
