// BLS12-381 scalar field Fr (255 bits, 8 x 32-bit limbs, R = 2^256), the
// parameters of field.cuh's and fp_cc.cuh's arithmetic for K1 (fr_ops.cu).
#pragma once

#include "field.cuh"

static __constant__ uint32_t SPK_FR_MOD[8] = {0x00000001u, 0xffffffffu, 0xfffe5bfeu, 0x53bda402u,
                                              0x09a1d805u, 0x3339d808u, 0x299d7d48u, 0x73eda753u};

struct FrParams {
  static constexpr int N = 8;
  static constexpr uint32_t INV = 0xffffffffu;  // -r^-1 mod 2^32
  static constexpr uint32_t TOP = 0x73eda753u;  // the top limb, SPK_FR_MOD[7]
  static __device__ __forceinline__ uint32_t mod(int i) { return SPK_FR_MOD[i]; }
};
