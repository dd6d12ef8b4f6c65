// K6 and K7: a sumcheck round of each phase in one launch (sumcheck.cuh).
// `blocks` (at most sck::kMaxBlocks) is the grid and the number of partials
// a round writes, (3, blocks, 8); the caller sizes the partials by it. With
// `fold` unset the output tables are not written.
#include "sumcheck.cuh"

extern "C" int spk_sc1_round(const uint32_t* az, const uint32_t* bz, const uint32_t* cz, const uint32_t* s,
                             const uint32_t* r_mont, uint32_t* az_out, uint32_t* bz_out, uint32_t* cz_out,
                             uint32_t* partials, int64_t pairs, int64_t fold, int64_t blocks,
                             cudaStream_t stream) {
  if (pairs < 1 || blocks < 1 || blocks > sck::kMaxBlocks) return (int)cudaErrorInvalidValue;
  sc1_round_kernel<<<(unsigned)blocks, sck::kThreads, 0, stream>>>(az, bz, cz, s, r_mont, az_out, bz_out,
                                                                    cz_out, partials, pairs, (int)fold);
  return (int)cudaGetLastError();
}

extern "C" int spk_prod2_round(const uint32_t* w, const uint32_t* z, const uint32_t* r_mont, uint32_t* w_out,
                               uint32_t* z_out, uint32_t* partials, int64_t pairs, int64_t fold, int64_t blocks,
                               cudaStream_t stream) {
  if (pairs < 1 || blocks < 1 || blocks > sck::kMaxBlocks) return (int)cudaErrorInvalidValue;
  prod2_round_kernel<<<(unsigned)blocks, sck::kThreads, 0, stream>>>(w, z, r_mont, w_out, z_out, partials,
                                                                      pairs, (int)fold);
  return (int)cudaGetLastError();
}
