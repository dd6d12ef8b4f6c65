// K5: the transcript kernels of the device-resident sumcheck phases (fs.cuh)
// and the Blake2s yardstick (blake2s.cuh). Each entry point launches one
// block on the caller's stream and returns cudaGetLastError().
#include "fs.cuh"

extern "C" int spk_fs_sc1_emit(const uint32_t* partials, const uint32_t* tor_i, const uint32_t* consts,
                               uint32_t* pre, uint32_t* state, uint32_t* evals, uint32_t* r_out,
                               uint32_t* r_mont, int64_t nblocks, int64_t D, cudaStream_t stream) {
  if (nblocks < 1 || D < 3 || D > fs::kMaxEvals) return (int)cudaErrorInvalidValue;
  fs_sc1_emit_kernel<<<1, fs::kThreads, 0, stream>>>(partials, tor_i, consts, pre, state, evals, r_out,
                                                     r_mont, nblocks, (int)D);
  return (int)cudaGetLastError();
}

extern "C" int spk_fs_sc1_final(const uint32_t* az, const uint32_t* bz, const uint32_t* cz,
                                const uint32_t* r_mont, uint32_t* state, uint32_t* vabc, uint32_t* rabc,
                                cudaStream_t stream) {
  fs_sc1_final_kernel<<<1, 32, 0, stream>>>(az, bz, cz, r_mont, state, vabc, rabc);
  return (int)cudaGetLastError();
}

extern "C" int spk_fs_sc2_emit(const uint32_t* partials, uint32_t* state, uint32_t* evals, uint32_t* r_out,
                               uint32_t* r_mont, int64_t nblocks, cudaStream_t stream) {
  if (nblocks < 1) return (int)cudaErrorInvalidValue;
  fs_sc2_emit_kernel<<<1, fs::kThreads, 0, stream>>>(partials, state, evals, r_out, r_mont, nblocks);
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
