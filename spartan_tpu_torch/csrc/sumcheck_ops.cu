// K5-K7: the device-resident sumcheck phases' entry points (sumcheck.cuh):
// a round of each phase with its transcript step and the one-block tails,
// each for B instances of one circuit (one instance is B = 1), and the
// Blake2s yardstick (blake2s.cuh). Each launches on the caller's stream and
// returns cudaGetLastError().
//
// A round launch: `blocks` (at most sck::kMaxBlocks) is an instance's grid,
// the launch's (blocks, B); sums (27 64-bit words) and the ticket counter
// ctr are 0 between launches. With `fold` unset the output tables are not
// written. A tail: B blocks, pairs0 (at most sck::kTailPairs) pairs in its
// first round, `rounds` = log2(pairs0) + 1 rounds down to one pair. The
// pointers are instance 0's, the tables (B, 8, n) contiguous, the weights
// at s_stride words an instance and every transcript array at ist words
// (even: sums are 64-bit words at the same offset).
#include "sumcheck.cuh"

namespace {
int tail_threads(int64_t pairs0) {
  const int64_t t = 4 * pairs0;
  return (int)(t < 32 ? 32 : t > sck::kTailThreads ? sck::kTailThreads : t);
}
size_t tail_smem(int nt, int64_t pairs0, int64_t fold) {
  const int64_t cap = fold ? 2 * pairs0 : pairs0;
  return (size_t)nt * 8 * (cap + (cap / 2 > 0 ? cap / 2 : 1)) * sizeof(uint32_t);
}
// The tails' dynamic shared memory beside their static (the step's
// coefficients and message) passes 48 KiB: opt in once, for the largest.
template <class K>
int tail_opt_in(K kernel, int nt) {
  static bool done = false;
  if (!done) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)tail_smem(nt, sck::kTailPairs, 1));
    if (e != cudaSuccess) return (int)e;
    done = true;
  }
  return 0;
}
bool tail_ok(int64_t pairs0, int64_t rounds) {
  return pairs0 >= 1 && pairs0 <= sck::kTailPairs && rounds >= 1 && rounds <= 31 &&
         (pairs0 >> (rounds - 1)) == 1 && (pairs0 & (pairs0 - 1)) == 0;
}
bool batch_ok(int64_t B, int64_t ist) { return B >= 1 && B <= 65535 && ist >= 0 && ist % 2 == 0; }
}  // namespace

extern "C" int spk_sc1_round(const uint32_t* az, const uint32_t* bz, const uint32_t* cz, const uint32_t* s,
                             const uint32_t* consts, const uint32_t* tor_i, const uint32_t* tor_next,
                             uint32_t* pre, uint32_t* coef, uint32_t* state, uint32_t* evals, uint32_t* r_out,
                             uint32_t* r_mont, uint32_t* ctr, uint32_t* az_out, uint32_t* bz_out, uint32_t* cz_out,
                             unsigned long long* sums, int64_t pairs, int64_t fold, int64_t blocks, int64_t D,
                             int64_t B, int64_t s_stride, int64_t ist, cudaStream_t stream) {
  if (pairs < 1 || blocks < 1 || blocks > sck::kMaxBlocks || D < 3 || D > fs::kMaxEvals || !batch_ok(B, ist))
    return (int)cudaErrorInvalidValue;
  sc1_round_kernel<<<dim3((unsigned)blocks, (unsigned)B), sck::kThreads, 0, stream>>>(
      az, bz, cz, s, consts, tor_i, tor_next, pre, coef, state, evals, r_out, r_mont, ctr, az_out, bz_out, cz_out,
      sums, pairs, (int)fold, (int)D, s_stride, ist);
  return (int)cudaGetLastError();
}

extern "C" int spk_prod2_round(const uint32_t* w, const uint32_t* z, uint32_t* state, uint32_t* evals,
                               uint32_t* r_out, uint32_t* r_mont, uint32_t* ctr, uint32_t* w_out, uint32_t* z_out,
                               unsigned long long* sums, int64_t pairs, int64_t fold, int64_t blocks, int64_t B,
                               int64_t ist, cudaStream_t stream) {
  if (pairs < 1 || blocks < 1 || blocks > sck::kMaxBlocks || !batch_ok(B, ist)) return (int)cudaErrorInvalidValue;
  prod2_round_kernel<<<dim3((unsigned)blocks, (unsigned)B), sck::kThreads, 0, stream>>>(
      w, z, state, evals, r_out, r_mont, ctr, w_out, z_out, sums, pairs, (int)fold, ist);
  return (int)cudaGetLastError();
}

extern "C" int spk_sc1_tail(const uint32_t* az, const uint32_t* bz, const uint32_t* cz, const uint32_t* s_cat,
                            const uint32_t* consts, const uint32_t* tor, uint32_t* pre, const uint32_t* coef,
                            uint32_t* state, uint32_t* evals, uint32_t* rs, uint32_t* r_mont, uint32_t* vabc,
                            uint32_t* rabc, int64_t pairs0, int64_t fold, int64_t rounds, int64_t D, int64_t B,
                            int64_t s_stride, int64_t ist, cudaStream_t stream) {
  if (!tail_ok(pairs0, rounds) || D < 3 || D > fs::kMaxEvals || !batch_ok(B, ist)) return (int)cudaErrorInvalidValue;
  if (const int e = tail_opt_in(sc1_tail_kernel, 3)) return e;
  sc1_tail_kernel<<<(unsigned)B, tail_threads(pairs0), tail_smem(3, pairs0, fold), stream>>>(
      az, bz, cz, s_cat, consts, tor, pre, coef, state, evals, rs, r_mont, vabc, rabc, pairs0, (int)fold,
      (int)rounds, (int)D, s_stride, ist);
  return (int)cudaGetLastError();
}

extern "C" int spk_sc2_tail(const uint32_t* w, const uint32_t* z, uint32_t* state, uint32_t* evals, uint32_t* rs,
                            uint32_t* r_mont, int64_t pairs0, int64_t fold, int64_t rounds, int64_t B, int64_t ist,
                            cudaStream_t stream) {
  if (!tail_ok(pairs0, rounds) || !batch_ok(B, ist)) return (int)cudaErrorInvalidValue;
  if (const int e = tail_opt_in(sc2_tail_kernel, 2)) return e;
  sc2_tail_kernel<<<(unsigned)B, tail_threads(pairs0), tail_smem(2, pairs0, fold), stream>>>(
      w, z, state, evals, rs, r_mont, pairs0, (int)fold, (int)rounds, ist);
  return (int)cudaGetLastError();
}

extern "C" int spk_blake2s_batch(const uint32_t* msgs, uint32_t* out, int64_t count, int64_t nwords,
                                 cudaStream_t stream) {
  if (count < 1 || nwords < 0) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  blake2s_batch_kernel<<<(unsigned)((count + threads - 1) / threads), threads, 0, stream>>>(
      msgs, out, count, (int)nwords);
  return (int)cudaGetLastError();
}
