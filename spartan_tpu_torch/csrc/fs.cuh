// K5: the transcript step of the device-resident sumcheck phases, run inside
// the round kernels (sumcheck.cuh): by the block that finishes a round last,
// and by the one-block tail after each of its rounds. The chain state, the
// running product `pre` and the challenge never leave the card between
// rounds, and a round is one launch.
//
// Replaces spartan_tpu/protocol/fused.py: _sc1_emit_core (:111), the final
// round of sumcheck 1 _sc1_final_core (:137) and _sc2_emit_core (:154), with
// the transcript of spartan_tpu/ops/fs_device.py (fs_feed :48, fs_sample_fr
// :108) and Blake2s (blake2s.cuh).
//
// A round's step: the round's three sums q(0), q(1), q(2) (unreduced, Acc)
// become the wire's evaluations; one thread absorbs the message (state ||
// ser_fr_vec(evals): a u64 length prefix and 32 bytes an element) and
// samples the challenge from block 0 of the new stream, rejecting values
// >= r. What bounds it on the H100 (PERF.md): that thread's chain, 11
// Blake2s compressions for a sumcheck-1 round at 2^16 (648 bytes of
// message), about 0.9 us each, and the sampler's one or more; and Fr
// products, which cost one thread 1,000-1,500 cycles each. So a sumcheck-1
// evaluation is spread over four lanes, ev(t) = sum_k K_k(t) q(k) with
// K_k(t) = pre c_k(t) l_i(t), which does not depend on the sums: once they
// are there an evaluation is one product deep (sc1_evals). K comes ready
// from the round before: while one thread absorbs, the other warps form the
// next round's brackets (sc1_brackets), which take the next pre factor
// l_i(r_i) in one product after the sample (sc1_next, one product a
// thread); round 0's K comes from the host.
#pragma once

#include "blake2s.cuh"
#include "fr_sum.cuh"

namespace fs {

constexpr int kMaxEvals = 64;                  // evaluations a round: log_n + 3 in sumcheck 1
constexpr int kMsgWords = 10 + 8 * kMaxEvals;  // state, prefix, evaluations

using sck::Acc;

// A sumcheck-1 step's coefficients, in shared memory: this round's K_k(t)
// canonical and K_k(t) R; the next round's brackets pre c_k(t) l'(t) R and
// its R multiple (l' the next round's eq factor); tor_i canonical, pre R,
// and after the sample r and tor_i r canonical.
struct Sc1Coeffs {
  Fr k[3][kMaxEvals], kr[3][kMaxEvals];
  Fr b[3][kMaxEvals], br[3][kMaxEvals];
  Fr tor_c, p_r, r, t2;
};

// This round's K and K R from coef (6, D, 8): every thread from `first` on.
__device__ __forceinline__ void sc1_load_coef(Sc1Coeffs& c, const uint32_t* coef, int D, int first) {
  for (int idx = (int)threadIdx.x - first; idx >= 0 && idx < 6 * D; idx += (int)blockDim.x - first) {
    const int m = idx / D, j = idx - m * D;
    const Fr x = sck::load8(coef + idx * 8);
    if (m < 3) c.k[m][j] = x;
    else c.kr[m - 3][j] = x;
  }
}

// The next round's brackets from p = pre R and tor_next (Montgomery): with
// l' = tor_next ea(t) + eb(t) in Montgomery form, mul(mul(p, c_k(t)), l') =
// pre c_k(t) l' R, and its product by R^2. They take the next round's pre
// factor l_i(r_i) in one product once r_i is drawn (sc1_next), so the next
// round's K costs one product after the sample. consts (5, D, 8): the
// Montgomery rows c0, c1, c2 (Lagrange through t = 0, 1, 2) and ea, eb.
// Threads from `first` on, four an evaluation (k = idx & 3); lane 3 of
// evaluation 0 takes tor_i canonical and pre R. Run beside the absorb.
__device__ __forceinline__ void sc1_brackets(Sc1Coeffs& c, const Fr& p, const Fr& tor, const Fr& tor_next,
                                             const uint32_t* __restrict__ consts, int D, int first, bool next) {
  using namespace sck;
  for (int idx = (int)threadIdx.x - first; idx >= 0 && idx < 4 * D; idx += (int)blockDim.x - first) {
    const int j = idx >> 2, k = idx & 3;
    if (k < 3 && next) {
      const Fr ell = add(mul(tor_next, load8(consts + (3 * D + j) * 8)), load8(consts + (4 * D + j) * 8));
      const Fr bb = mul(mul(p, load8(consts + (k * D + j) * 8)), ell);
      c.b[k][j] = bb;
      c.br[k][j] = mul(bb, fr_const(SPK_FR_R2));
    } else if (k == 3 && j == 0) {
      c.tor_c = mul(tor, fr_word(1u));
      c.p_r = mul(p, fr_const(SPK_FR_R2));
    }
  }
}

// The D wire evaluations ev(t) = sum_k K_k(t) q(k), canonical, to evals (D,
// 8) and msg: every thread of the block (full warps), four lanes an
// evaluation; acc_mul takes each unreduced sum in one product.
__device__ __forceinline__ void sc1_evals(const Sc1Coeffs& c, const Acc* q, int D, uint32_t* evals, uint32_t* msg) {
  using namespace sck;
  for (int base = 0; base < 4 * D; base += blockDim.x) {
    const int idx = base + (int)threadIdx.x, j = idx >> 2, k = idx & 3;
    Fr x = fe_zero<FrParams>();
    if (idx < 4 * D && k < 3) x = acc_mul(c.k[k][j], c.kr[k][j], q[k]);
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      Fr y;
#pragma unroll
      for (int i = 0; i < 8; ++i) y.v[i] = __shfl_xor_sync(0xffffffffu, x.v[i], off);
      x = add(x, y);
    }
    if (idx < 4 * D && k == 0) {
      store8(evals + j * 8, x);
      store8(msg + 10 + j * 8, x);
    }
  }
}

// One thread: absorb msg (nwords words, the chain state first) into st and
// sample the challenge r (canonical).
__device__ __forceinline__ void absorb_sample(const uint32_t* msg, int nwords, uint32_t st[8], Fr& r) {
  b2s::hash_words(msg, nwords, st);
  b2s::sample_fr<FrParams>(st, 0u, r.v);
}

// The message's head: the chain state and ser_fr_vec's u64 length prefix.
__device__ __forceinline__ void msg_head(uint32_t* msg, const uint32_t st[8], int n) {
#pragma unroll
  for (int i = 0; i < 8; ++i) msg[i] = st[i];
  msg[8] = (uint32_t)n;
  msg[9] = 0u;
}

// Thread 0 after sc1_evals: absorb (msg's head written here), sample r_i
// (canonical, into r and c.r) and leave tor_i r (canonical, mul(tor R, r))
// in c for sc1_next.
__device__ __forceinline__ void sc1_sample(Sc1Coeffs& c, const Fr& tor, uint32_t* msg, int D, uint32_t st[8], Fr& r) {
  msg_head(msg, st, D);
  absorb_sample(msg, 10 + 8 * D, st, r);
  c.r = r;
  c.t2 = sck::mul(tor, r);
}

// After the sample, every thread, one product each: r_i in Montgomery form
// into rm (index 6D), pre l_i(r_i) = mul(pre R, l) into p_next (index 6D +
// 1), with l = l_i(r_i) = 2 tor_i r - tor_i - r + 1 canonical, and when
// `next` the next round's K = mul(bracket, l) and K R (indices below 6D)
// into c.k, c.kr and, when coef is set, coef (6, D, 8).
__device__ __forceinline__ void sc1_next(Sc1Coeffs& c, int D, uint32_t* coef, uint32_t* rm, uint32_t* p_next,
                                         bool next) {
  using namespace sck;
  const Fr ell = add(sub(sub(add(c.t2, c.t2), c.tor_c), c.r), fr_word(1u));
  for (int idx = next ? (int)threadIdx.x : 6 * D + (int)threadIdx.x; idx < 6 * D + 2; idx += blockDim.x) {
    if (idx >= 6 * D) {
      if (idx == 6 * D) store8(rm, mul(c.r, fr_const(SPK_FR_R2)));
      else store8(p_next, mul(c.p_r, ell));
      continue;
    }
    const int m = idx / D, j = idx - m * D;
    const Fr x = mul(m < 3 ? c.b[m][j] : c.br[m - 3][j], ell);
    if (m < 3) c.k[m][j] = x;
    else c.kr[m - 3][j] = x;
    if (coef != nullptr) store8(coef + idx * 8, x);
  }
}

// A sumcheck-2 step, warp 0: the three evaluations q(t) R^-1, canonical, to
// evals (3, 8) and msg (acc_mul with y = 1 and y R = R mod r), then thread 0
// absorbs them with their prefix and samples r.
__device__ __forceinline__ void sc2_step(const Acc* q, uint32_t st[8], uint32_t* evals, uint32_t* msg, Fr& r,
                                         Fr& rm) {
  using namespace sck;
  const int lane = threadIdx.x & 31;
  if (lane < 3) {
    const Fr ev = acc_mul(fr_word(1u), fr_const(SPK_FR_ONE_MONT), q[lane]);
    store8(evals + lane * 8, ev);
    store8(msg + 10 + lane * 8, ev);
  }
  __syncwarp();
  if (lane == 0) {
    msg_head(msg, st, 3);
    absorb_sample(msg, 10 + 8 * 3, st, r);
    rm = mul(r, fr_const(SPK_FR_R2));
  }
}

// Round 4 after sumcheck 1's last round, warp 0: fold the width-2 tables
// (ta, tb, tc of stride n, Montgomery) by the last challenge r (canonical),
// lane k the table k: v = x0 + (x1 - x0) r, canonical (a product by 1 and a
// product by the canonical r leave Montgomery form), to vabc (3, 8); lane 0
// absorbs va, vb, vc (3 x 32 bytes, no prefix) and samples r_a, r_b, r_c
// from one running counter into rabc (3, 8).
__device__ __forceinline__ void sc1_final(const uint32_t* ta, const uint32_t* tb, const uint32_t* tc, int64_t n,
                                          const Fr& r, uint32_t st[8], uint32_t* vabc, uint32_t* rabc,
                                          uint32_t* msg) {
  using namespace sck;
  const int lane = threadIdx.x & 31;
  if (lane < 3) {
    const uint32_t* t = lane == 0 ? ta : lane == 1 ? tb : tc;
    const Fr x0 = fe_load<FrParams>(t, n, 0), x1 = fe_load<FrParams>(t, n, 1);
    const Fr v = add(mul(x0, fr_word(1u)), mul(sub(x1, x0), r));
    store8(vabc + 8 * lane, v);
    store8(msg + 8 + 8 * lane, v);
  }
  __syncwarp();
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) msg[i] = st[i];
    b2s::hash_words(msg, 32, st);
    uint32_t ctr = 0u;
#pragma unroll 1
    for (int k = 0; k < 3; ++k) ctr = b2s::sample_fr<FrParams>(st, ctr, rabc + 8 * k);
  }
}

}  // namespace fs
