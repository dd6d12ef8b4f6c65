// K1: BLS12-381 scalar field Fr (255 bits, 8 x 32-bit limbs, R = 2^256):
// Montgomery multiply, add and sub over (8, n) limb arrays.
//
// Replaces spartan_tpu/ops/pallas_field.py: mont_mul (:254, body
// _mont_mul_arr :106), add (:258, _add_arr :169) and sub (:262, _sub_arr
// :176), built for FR. The TPU kernel worked in 16-bit limbs because the TPU
// has no 32x32->64 multiply; Hopper has one, so the limbs are 32 bits and
// the carry chains are exact per row instead of lazy Kogge-Stone passes.
//
// The product runs fp_cc.cuh's CIOS on the carry flag, one lane a thread,
// 128 threads a block (the best of 32 to 512 at the prove's widths, within
// a few per cent; PERF.md). The prover launches it at 1 to 196,596
// lanes, where a launch takes 2 to 7 us of device time: about 2 us
// is the launch itself, the rest the latency of a thread's chain of 128
// products and, from about 50,000 lanes, the 96 bytes a lane moves. The add
// and the sub run field.cuh's 64-bit sums. field.cuh's product, which
// fr_mul ran before, stays as the yardstick fr_mul_sum64 for chip_smoke.py.
//
// The prover's eq tables and its openings' quotient ladder run whole in
// fr_tables.cuh's kernels (eq_tables, quot_level, quot_tail), each a fused
// subtraction, product and sum: one launch a table set or a ladder level.
#include "fp_cc.cuh"
#include "fr.cuh"
#include "fr_tables.cuh"

extern "C" int spk_fr_mul(const uint32_t* a, const uint32_t* b, uint32_t* out, int64_t n,
                          cudaStream_t stream) {
  const int threads = 128;
  const int64_t blocks = (n + threads - 1) / threads;
  fe_mul_cc_kernel<FrParams><<<(unsigned)blocks, threads, 0, stream>>>(a, b, out, n);
  return (int)cudaGetLastError();
}

extern "C" int spk_fr_add(const uint32_t* a, const uint32_t* b, uint32_t* out, int64_t n,
                          cudaStream_t stream) {
  return fe_binary_launch<FrParams, 1>(a, b, out, n, stream);
}

extern "C" int spk_fr_sub(const uint32_t* a, const uint32_t* b, uint32_t* out, int64_t n,
                          cudaStream_t stream) {
  return fe_binary_launch<FrParams, 2>(a, b, out, n, stream);
}

extern "C" int spk_fr_mul_sum64(const uint32_t* a, const uint32_t* b, uint32_t* out, int64_t n,
                                cudaStream_t stream) {
  return fe_binary_launch<FrParams, 0>(a, b, out, n, stream);
}

// The eq tables 0 .. tables - 1 of the (8, nv) point ts into out, one after
// another (fr_tables.cuh): tables = 1 gives eq_table, nv + 1 the suffix set.
extern "C" int spk_eq_tables(const uint32_t* ts, uint32_t* out, int64_t nv, int64_t tables, cudaStream_t stream) {
  return frt::eq_tables_launch(ts, out, nv, tables, stream);
}

// Level `level` of the quotient ladder over nv variables: r (8, 2^(nv-level))
// -> qcat's block of the level (qcat (8, 2^nv - 1)) and r_out (8,
// 2^(nv-level-1)).
extern "C" int spk_quot_level(const uint32_t* r, const uint32_t* point, uint32_t* qcat, uint32_t* r_out, int64_t nv,
                              int64_t level, cudaStream_t stream) {
  return frt::quot_level_launch(r, point, qcat, r_out, nv, level, stream);
}

// Levels level0 .. nv - 1 by one block, and the evaluation into ev (8, 1);
// level0 leaves at most frt::kTailPairs pairs.
extern "C" int spk_quot_tail(const uint32_t* r, const uint32_t* point, uint32_t* qcat, uint32_t* ev, int64_t nv,
                             int64_t level0, cudaStream_t stream) {
  return frt::quot_tail_launch(r, point, qcat, ev, nv, level0, stream);
}
