// Team point kernels: the Jacobian add and 2^k-fold double of K3 (G1) and
// the add, mixed add and 2^k-fold double of K4 (G2), one team of T threads
// per point, one kernel template over both groups. They replace
// spartan_tpu/ops/pallas_curve.py g1_add (:378, _g1_add_kernel :216),
// g1_double (:392, _g1_double_kernel :255), g2_add (:399, _g2_add_kernel
// :264), g2_madd (:410, _g2_madd_kernel :240) and g2_double (:421,
// _g2_double_kernel :279); the port's doubles repeat k times in one launch,
// as the JAX MSM's fori_loop over the window's doublings does
// (spartan_tpu/ops/msm.py:618). Entry points: g1_team.cu, g2_team.cu.
//
// What bounds them on an H100. At the width of the Horner steps (1 point
// for the commitment's G1 MSM, 7-9 for the openings' G2 ones) the card is
// idle but for one chain of dependent Fp products when one thread computes
// the point (point.cuh): 7 for a G1 double, 16 for a G1 add or a G2
// double, 44 for a G2 add, each a 288-product CIOS chain. At tens of
// thousands of points, and at the mixed add's 1 M points, they are bound by
// 32-bit multiply throughput (2 IMADs per 32x32->64 product, 64 IMADs per SM
// per clock).
//
// What the design does about it. The formulas are written as stages of
// independent Fp operations (ops/team.py, tables in team_prog.cuh): over
// Fp2, Karatsuba's three products per multiply and the complex square's
// two, and in both groups the formula's independent operations. A team's
// threads share out each stage's operations and meet at a __syncwarp(team
// mask); values live in the team's slice of shared memory, 12 limbs a
// slot. The chain of dependent products is then 3 deep for a double and 5
// for an add. Each thread computes whole Fp products in its registers (no
// spills, a few dozen registers), so at wide widths far more warps fit on
// an SM than the one-thread kernels' registers allowed. The Fp arithmetic
// runs its carries on the PTX carry flag (fp_cc.cuh). The block loads and
// stores the points with neighbouring threads on neighbouring lanes.
//
// Edge lanes, in the order of point.cuh: P = inf -> Q; Q = inf -> P;
// H = R = 0 (P == Q) -> double(P); P == -Q gives Z = 0 by the formula. So
// the kernels return the same Jacobian limbs as the plain PyTorch versions.
#pragma once

#include "fp_cc.cuh"

// One operation of a stage program, 16 bytes. mul: d = t0 * t1 (Montgomery);
// otherwise d = scale * (sum of nterm terms). A term is a slot, bit 7 set
// for a minus sign.
struct alignas(16) TeamOp {
  uint8_t dst, scale, nterm, mul;
  uint8_t term[12];
};

#include "team_prog.cuh"

namespace team {

constexpr int kBlock = 128;

__device__ __forceinline__ Fp sh_load(const uint4* sh, uint32_t slot) {
  Fp r;
  const uint4* s = sh + 3 * slot;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const uint4 v = s[k];
    r.v[4 * k] = v.x;
    r.v[4 * k + 1] = v.y;
    r.v[4 * k + 2] = v.z;
    r.v[4 * k + 3] = v.w;
  }
  return r;
}

__device__ __forceinline__ void sh_store(uint4* sh, uint32_t slot, const Fp& a) {
  uint4* s = sh + 3 * slot;
#pragma unroll
  for (int k = 0; k < 3; ++k)
    s[k] = make_uint4(a.v[4 * k], a.v[4 * k + 1], a.v[4 * k + 2], a.v[4 * k + 3]);
}

__device__ __forceinline__ bool sh_is_zero(const uint4* sh, uint32_t slot) {
  return fe_is_zero<FpParams>(sh_load(sh, slot));
}

__device__ __forceinline__ void run_op(uint4* sh, const TeamOp* ops, int j) {
  const uint4 w = reinterpret_cast<const uint4*>(ops)[j];
  const uint32_t dst = w.x & 0xffu, scale = (w.x >> 8) & 0xffu, nterm = (w.x >> 16) & 0xffu;
  if (w.x >> 24) {
    sh_store(sh, dst, fp_mul_cc(sh_load(sh, w.y & 0x7fu), sh_load(sh, (w.y >> 8) & 0x7fu)));
    return;
  }
  // the 12 term bytes as a 96-bit shift register
  uint32_t t0 = w.y, t1 = w.z, t2 = w.w;
  Fp acc = sh_load(sh, t0 & 0x7fu);
  if (t0 & 0x80u) acc = fp_sub_cc(fe_zero<FpParams>(), acc);
  for (uint32_t i = 1; i < nterm; ++i) {
    t0 = (t0 >> 8) | (t1 << 24);
    t1 = (t1 >> 8) | (t2 << 24);
    t2 >>= 8;
    const Fp x = sh_load(sh, t0 & 0x7fu);
    if (t0 & 0x80u) acc = fp_sub_cc(acc, x);
    else acc = fp_add_cc(acc, x);
  }
  if (scale > 1) {  // double-and-add over the bits of scale
    const Fp base = acc;
    for (int b = 30 - __clz(scale); b >= 0; --b) {
      acc = fp_add_cc(acc, acc);
      if ((scale >> b) & 1u) acc = fp_add_cc(acc, base);
    }
  }
  sh_store(sh, dst, acc);
}

// Stages [s0, s1) of a program: rank r of the team runs operations
// r, r + T, ... of each stage, then the team meets.
template <int T>
__device__ __forceinline__ void run_stages(uint4* sh, const TeamOp* ops, const uint8_t* ends,
                                           int s0, int s1, int rank, unsigned mask) {
  int j = s0 == 0 ? 0 : ends[s0 - 1];
  for (int s = s0; s < s1; ++s) {
    const int end = ends[s];
    for (int k = j + rank; k < end; k += T) run_op(sh, ops, k);
    j = end;
    __syncwarp(mask);
  }
}

// The kernels' operations. The adds load P and Q, the double P alone.
enum Op { kDouble = 0, kAdd = 1, kMadd = 2 };

// The groups: NC Fp coordinates a point (x, y, z over Fp or Fp2), Z in the
// last third; Q's slots follow P's.
struct G1 {
  static constexpr int NC = 3;
  static constexpr int kCheckStage = G1T_CHECK_STAGE, kNCheck = G1T_NCHECK;
  static __device__ __forceinline__ const TeamOp* dbl_ops() { return G1T_DBL_OPS; }
  static __device__ __forceinline__ const uint8_t* dbl_ends() { return G1T_DBL_END; }
  static constexpr int kDblStages = G1T_DBL_NSTAGE;
};
struct G2 {
  static constexpr int NC = 6;
  static constexpr int kCheckStage = G2T_CHECK_STAGE, kNCheck = G2T_NCHECK;
  static __device__ __forceinline__ const TeamOp* dbl_ops() { return G2T_DBL_OPS; }
  static __device__ __forceinline__ const uint8_t* dbl_ends() { return G2T_DBL_END; }
  static constexpr int kDblStages = G2T_DBL_NSTAGE;
};

template <class G, int OP>
struct Prog;  // the stage program an operation runs, and its team slice
#define SPK_TEAM_PROG(G, OP, NAME)                                                          \
  template <>                                                                              \
  struct Prog<G, OP> {                                                                     \
    static constexpr int kSlots = G##T_##NAME##_SLOTS;                                     \
    static __device__ __forceinline__ const TeamOp* ops() { return G##T_##NAME##_OPS; }    \
    static __device__ __forceinline__ const uint8_t* ends() { return G##T_##NAME##_END; }  \
    static __device__ __forceinline__ const uint8_t* check() { return G##T_##NAME##_CHECK; } \
    static constexpr int kStages = G##T_##NAME##_NSTAGE;                                   \
  };
template <>
struct Prog<G1, kDouble> {
  static constexpr int kSlots = G1T_DBL_SLOTS;
};
template <>
struct Prog<G2, kDouble> {
  static constexpr int kSlots = G2T_DBL_SLOTS;
};
SPK_TEAM_PROG(G1, kAdd, ADD)
SPK_TEAM_PROG(G2, kAdd, ADD)
SPK_TEAM_PROG(G2, kMadd, MADD)
#undef SPK_TEAM_PROG

// Slots first, first + 1, ... of P's (or Q's) Z all zero: the point at infinity.
template <class G>
__device__ __forceinline__ bool z_is_zero(const uint4* sh, int first) {
  bool z = true;
#pragma unroll
  for (int c = 2 * G::NC / 3; c < G::NC; ++c) z = z && sh_is_zero(sh, first + c);
  return z;
}

// OP = kAdd: out = p + q; kMadd: out = p + q with q affine-encoded (G2);
// kDouble: out = 2^k p. Points are (G::NC, 12, n) limb-major.
template <class G, int T, int OP>
__global__ void __launch_bounds__(kBlock) team_kernel(const uint32_t* __restrict__ p,
                                                      const uint32_t* __restrict__ q,
                                                      uint32_t* __restrict__ out, int64_t n,
                                                      int k) {
  constexpr int PTS = kBlock / T;  // points per block
  constexpr int STRIDE = 3 * Prog<G, OP>::kSlots + 1;  // uint4 per team
  constexpr int PW = 12 * G::NC;  // words of one point
  constexpr int NIN = OP == kDouble ? PW : 2 * PW;  // words loaded per lane
  extern __shared__ uint4 smem[];  // PTS team slices, then out_slot
  int* out_slot = reinterpret_cast<int*>(smem + PTS * STRIDE);  // result's first slot
  const int team = threadIdx.x / T, rank = threadIdx.x % T;
  const int64_t first = (int64_t)blockIdx.x * PTS;
  const int npts = (int)(n - first < PTS ? n - first : PTS);
  uint32_t* words = reinterpret_cast<uint32_t*>(smem);

  for (int i = threadIdx.x; i < NIN * PTS; i += kBlock) {
    const int t = i % PTS, w = i / PTS;  // w = coordinate * 12 + limb
    if (t < npts) {
      const uint32_t* src = w < PW ? p : q;
      words[t * STRIDE * 4 + w] = src[(int64_t)(w % PW) * n + first + t];
    }
  }
  __syncthreads();

  if (team < npts) {
    uint4* sh = smem + team * STRIDE;
    const unsigned mask = (T == 32 ? 0xffffffffu : ((1u << T) - 1u) << (threadIdx.x % 32 / T * T));
    int res = 0;
    if constexpr (OP == kDouble) {
      for (int r = 0; r < k; ++r)
        run_stages<T>(sh, G::dbl_ops(), G::dbl_ends(), 0, G::kDblStages, rank, mask);
    } else {
      using Pr = Prog<G, OP>;
      if (z_is_zero<G>(sh, 0)) {
        res = G::NC;  // P = inf: the result is Q
      } else if (!z_is_zero<G>(sh, G::NC)) {
        run_stages<T>(sh, Pr::ops(), Pr::ends(), 0, G::kCheckStage + 1, rank, mask);
        bool same = true;
#pragma unroll
        for (int c = 0; c < G::kNCheck; ++c) same = same && sh_is_zero(sh, Pr::check()[c]);
        if (same)
          run_stages<T>(sh, G::dbl_ops(), G::dbl_ends(), 0, G::kDblStages, rank, mask);
        else
          run_stages<T>(sh, Pr::ops(), Pr::ends(), G::kCheckStage + 1, Pr::kStages, rank, mask);
      }
    }
    if (rank == 0) out_slot[team] = res;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < PW * PTS; i += kBlock) {
    const int t = i % PTS, w = i / PTS;
    if (t < npts) out[(int64_t)w * n + first + t] = words[t * STRIDE * 4 + out_slot[t] * 12 + w];
  }
}

#ifdef __CUDACC__
template <class G, int T, int OP>
static int launch_t(const uint32_t* p, const uint32_t* q, uint32_t* out, int64_t n, int k,
                    cudaStream_t stream) {
  constexpr int PTS = kBlock / T;
  constexpr size_t smem = ((size_t)PTS * (3 * Prog<G, OP>::kSlots + 1) + PTS) * 16;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        team_kernel<G, T, OP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int64_t blocks = (n + PTS - 1) / PTS;
  team_kernel<G, T, OP><<<(unsigned)blocks, kBlock, smem, stream>>>(p, q, out, n, k);
  return (int)cudaGetLastError();
}

// Team size T in {2, 4, 8} for G1 and {4, 8, 16} for G2 (the widest stages
// hold 5 and 17 operations); any other value is refused
// (cudaErrorInvalidValue).
template <class G, int OP>
static int launch(const uint32_t* p, const uint32_t* q, uint32_t* out, int64_t n, int k, int T,
                  cudaStream_t stream) {
  if constexpr (G::NC == 3) {
    switch (T) {
      case 2: return launch_t<G, 2, OP>(p, q, out, n, k, stream);
      case 4: return launch_t<G, 4, OP>(p, q, out, n, k, stream);
      case 8: return launch_t<G, 8, OP>(p, q, out, n, k, stream);
    }
  } else {
    switch (T) {
      case 4: return launch_t<G, 4, OP>(p, q, out, n, k, stream);
      case 8: return launch_t<G, 8, OP>(p, q, out, n, k, stream);
      case 16: return launch_t<G, 16, OP>(p, q, out, n, k, stream);
    }
  }
  return (int)cudaErrorInvalidValue;
}
#endif  // __CUDACC__

}  // namespace team
