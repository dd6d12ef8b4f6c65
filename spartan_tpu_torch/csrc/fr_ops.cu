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
// a few per cent; PERF.md). The prover launches it 283 times a prove at 1 to
// 196,596 lanes, where a launch takes 2 to 7 us of device time: about 2 us
// is the launch itself, the rest the latency of a thread's chain of 128
// products and, from about 50,000 lanes, the 96 bytes a lane moves. The add
// and the sub run field.cuh's 64-bit sums. field.cuh's product, which
// fr_mul ran before, stays as the yardstick fr_mul_sum64 for chip_smoke.py.
#include "fp_cc.cuh"
#include "fr.cuh"

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
