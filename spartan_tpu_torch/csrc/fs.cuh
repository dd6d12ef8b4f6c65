// K5: the transcript kernels of the device-resident sumcheck phases. Each is
// one block; the chain state (8 words), the running product `pre` and the
// challenge stay in device memory from one round to the next, so a phase
// launches a round kernel (K6 or K7, sumcheck.cuh) and one of these a round
// and never waits for the host.
//
// Replaces spartan_tpu/protocol/fused.py: _sc1_emit_core (:111), the final
// round of sumcheck 1 _sc1_final_core (:137) and _sc2_emit_core (:154), with
// the transcript of spartan_tpu/ops/fs_device.py (fs_feed :48, fs_sample_fr
// :108) and Blake2s (blake2s.cuh).
//
// A round's emit step: the three warps add up the round kernel's per-block
// partials of q(0), q(1), q(2) (mod r, so in any order); the threads extend
// them to the wire's evaluations; one thread absorbs the message
// (state || ser_fr_vec(evals): a u64 length prefix and 32 bytes an element)
// and samples the challenge from block 0 of the new stream, rejecting values
// >= r. What bounds it is that one thread's chain: 11 Blake2s compressions
// for a sumcheck-1 round at 2^16 (648 bytes of message), about 12,000
// dependent integer operations, plus the rejection draws; the arithmetic is
// a few dozen Fr products. It is a latency, which the launch of the next
// round's kernel hides only in part.
#pragma once

#include "blake2s.cuh"
#include "fr_sum.cuh"

namespace fs {

constexpr int kThreads = 96;    // three warps: warp t adds the partials of q(t)
constexpr int kMaxEvals = 64;   // evaluations a round: log_n + 3 in sumcheck 1

static __constant__ uint32_t SPK_FR_R2[8] = {0xf3f29c6du, 0xc999e990u, 0x87925c23u, 0x2b6cedcbu,
                                             0x7254398fu, 0x05d31496u, 0x9f59ff11u, 0x0748d9d9u};
static __constant__ uint32_t SPK_FR_ONE_MONT[8] = {0xfffffffeu, 0x00000001u, 0x00034802u, 0x5884b7fau,
                                                   0xecbc4ff5u, 0x998c4fefu, 0xacc5056fu, 0x1824b159u};

__device__ __forceinline__ Fr from_mont(const Fr& x) {
  Fr one = fe_zero<FrParams>();
  one.v[0] = 1u;
  return sck::mul(x, one);
}

// A canonical value to Montgomery form: x R^2 R^-1.
__device__ __forceinline__ Fr to_mont(const Fr& x) { return sck::mul(x, sck::load8(SPK_FR_R2)); }

// q[t] = the sum mod r of the nblocks partials of evaluation t, laid out
// (3, nblocks, 8); warp t of the block adds those of t.
__device__ __forceinline__ void sum_partials(const uint32_t* partials, int64_t nblocks, Fr* q) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Fr x = fe_zero<FrParams>();
  for (int64_t k = lane; k < nblocks; k += 32) x = sck::add(x, sck::load8(partials + (warp * nblocks + k) * 8));
  x = sck::warp_sum(x);
  if (lane == 0) q[warp] = x;
  __syncthreads();
}

// Thread 0: absorb the message msg (nwords words, the chain state first),
// sample the challenge r, write it canonical to r_out and in Montgomery form
// to r_mont, and the new chain state to state. Returns r in Montgomery form.
__device__ __forceinline__ Fr absorb_sample(const uint32_t* msg, int nwords, uint32_t* state, uint32_t* r_out,
                                            uint32_t* r_mont) {
  uint32_t st[8], r[8];
  b2s::hash_words(msg, nwords, st);
  b2s::sample_fr<FrParams>(st, 0u, r);
  Fr rc;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    rc.v[i] = r[i];
    state[i] = st[i];
  }
  const Fr rm = to_mont(rc);
  sck::store8(r_out, rc);
  sck::store8(r_mont, rm);
  return rm;
}

}  // namespace fs

// One sumcheck-1 round's emit step. consts (5, D, 8): the Montgomery rows
// c0, c1, c2 (Lagrange through t = 0, 1, 2) and ea, eb (l_i(t) = tor_i ea(t)
// + eb(t)) at t = 0..D-1. The D wire evaluations pre l_i(t) q(t), canonical,
// go to evals (D, 8); then r_i to r_out (canonical) and r_mont, pre becomes
// pre l_i(r_i) and state the new chain state.
__global__ void __launch_bounds__(fs::kThreads)
fs_sc1_emit_kernel(const uint32_t* __restrict__ partials, const uint32_t* __restrict__ tor_i,
                   const uint32_t* __restrict__ consts, uint32_t* pre, uint32_t* state,
                   uint32_t* __restrict__ evals, uint32_t* __restrict__ r_out,
                   uint32_t* __restrict__ r_mont, int64_t nblocks, int D) {
  using namespace sck;
  __shared__ Fr q[3];
  __shared__ uint32_t msg[10 + 8 * fs::kMaxEvals];
  fs::sum_partials(partials, nblocks, q);
  const Fr tor = load8(tor_i), p = load8(pre);
  for (int j = threadIdx.x; j < D; j += blockDim.x) {
    const Fr qt = add(mul(q[0], load8(consts + (0 * D + j) * 8)),
                      add(mul(q[1], load8(consts + (1 * D + j) * 8)), mul(q[2], load8(consts + (2 * D + j) * 8))));
    const Fr ell = add(mul(tor, load8(consts + (3 * D + j) * 8)), load8(consts + (4 * D + j) * 8));
    const Fr ev = fs::from_mont(mul(p, mul(ell, qt)));
    store8(evals + j * 8, ev);
    store8(msg + 10 + j * 8, ev);
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) msg[i] = state[i];
    msg[8] = (uint32_t)D;  // ser_fr_vec's u64 length prefix
    msg[9] = 0u;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const Fr r = fs::absorb_sample(msg, 10 + 8 * D, state, r_out, r_mont);
    const Fr t2 = mul(tor, r);  // l_i(r) = 2 tor_i r - tor_i - r + 1
    const Fr ell_r = add(sub(sub(add(t2, t2), tor), r), load8(fs::SPK_FR_ONE_MONT));
    store8(pre, mul(p, ell_r));
  }
}

// Round 4 after sumcheck 1's last round: fold the width-2 Az, Bz, Cz tables
// ((8, 2) limb-major, Montgomery) by the last challenge, write va, vb, vc
// canonical to vabc (3, 8), absorb them (3 x 32 bytes, no prefix) and sample
// r_a, r_b, r_c from one running counter into rabc (3, 8). One thread.
__global__ void fs_sc1_final_kernel(const uint32_t* __restrict__ az, const uint32_t* __restrict__ bz,
                                    const uint32_t* __restrict__ cz, const uint32_t* __restrict__ r_mont,
                                    uint32_t* state, uint32_t* __restrict__ vabc,
                                    uint32_t* __restrict__ rabc) {
  using namespace sck;
  if (threadIdx.x != 0) return;
  uint32_t msg[32];
  const Fr r = load8(r_mont);
  const uint32_t* tabs[3] = {az, bz, cz};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const Fr x0 = fe_load<FrParams>(tabs[k], 2, 0), x1 = fe_load<FrParams>(tabs[k], 2, 1);
    const Fr v = fs::from_mont(add(x0, mul(sub(x1, x0), r)));
    store8(vabc + 8 * k, v);
    store8(msg + 8 + 8 * k, v);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) msg[i] = state[i];
  uint32_t st[8];
  b2s::hash_words(msg, 32, st);
  uint32_t ctr = 0u;
#pragma unroll 1
  for (int k = 0; k < 3; ++k) ctr = b2s::sample_fr<FrParams>(st, ctr, rabc + 8 * k);
#pragma unroll
  for (int i = 0; i < 8; ++i) state[i] = st[i];
}

// One sumcheck-2 round's emit step: the three evaluations q(0), q(1), q(2),
// canonical, to evals (3, 8); absorb them with their prefix; sample r.
__global__ void __launch_bounds__(fs::kThreads)
fs_sc2_emit_kernel(const uint32_t* __restrict__ partials, uint32_t* state, uint32_t* __restrict__ evals,
                   uint32_t* __restrict__ r_out, uint32_t* __restrict__ r_mont, int64_t nblocks) {
  using namespace sck;
  __shared__ Fr q[3];
  __shared__ uint32_t msg[10 + 8 * 3];
  fs::sum_partials(partials, nblocks, q);
  if (threadIdx.x < 3) {
    const Fr ev = fs::from_mont(q[threadIdx.x]);
    store8(evals + threadIdx.x * 8, ev);
    store8(msg + 10 + threadIdx.x * 8, ev);
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) msg[i] = state[i];
    msg[8] = 3u;
    msg[9] = 0u;
  }
  __syncthreads();
  if (threadIdx.x == 0) fs::absorb_sample(msg, 10 + 8 * 3, state, r_out, r_mont);
}
