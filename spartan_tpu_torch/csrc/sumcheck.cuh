// K6 and K7: the sumcheck rounds of the device-resident phases, each round
// with its transcript step (K5, fs.cuh) in the same launch, and a one-block
// tail that runs every round of a phase from the first that fits one block.
//
// K6 (sc1) replaces spartan_tpu/ops/sumcheck.py: sc1_round (:77) with
// sc1_evals3 (:54), K7 (prod2) prod2_round (:97) with prod2_evals3; the tails
// replace spartan_tpu/protocol/fused.py's _sc1_tail_phase (:166, with round
// 4, _sc1_final_core :137) and _sc2_tail_phase (:205). On the TPU the
// products, sums and differences are the Pallas kernels mont_mul, add and sub
// (pallas_field.py:254/258/262) and a reduction over the table for every
// evaluation.
//
// What bounds a round on the H100 (PERF.md, from clock64() stamps taken at
// its stages): below a few thousand pairs, latency. One thread's
// Fr product (fp_cc.cuh) is about 1,000-1,500 cycles, and the two-launch
// design's kernel ran twelve of them a pair on one thread: at one pair the
// fold took 8,900 cycles and the three evaluations 7,100 of 22,600; the sums
// mod r 4,700.
// So here a pair is a group of four lanes. Lane k < NT folds table k
// (entries 4b..4b+3 -> t[2b] + r (t[2b+1] - t[2b]), two products) and
// writes the folded pair at 2b, 2b+1; the group exchanges the pairs by
// shuffles; lane t < 3 forms the tables' values at t (e, o, 2o - e) and adds
// its term, S[b] (Az_t Bz_t - Cz_t) for K6 (two products deep) and W_t z_t
// for K7, to an unreduced sum (fr_sum.cuh's Acc). A warp sums the lanes of
// each t by 3 xor-shuffle steps, a block its warps. A block adds its partial
// (3 x 9 words) word by word to 64-bit sums in device memory with atomics
// and takes a ticket from a counter (round_sums); the block with the last
// ticket reads the sums, resets them and the counter and runs the
// transcript step, which samples the challenge the next launch folds by
// (stream order hands it over). Every sum is exact and is reduced once, so
// the order does not change a bit of the result.
//
// The tail: from the first round of at most kTailPairs pairs one block runs
// the remaining rounds (and, for sumcheck 1, round 4), round after round,
// the folded tables in shared memory (two buffers, the first fold reading
// the entering tables from device memory). At 2^16 a phase is 8 round
// launches and one tail. Tables are (8, N) limb-major Montgomery, as
// everywhere in the port.
//
// The batch axis: every kernel runs B instances of one circuit in one launch,
// each with its own tables, weights, transcript and ticket (one instance is
// B = 1). A round's grid is (blocks, B) with blockIdx.y the instance, so
// gridDim.x, which round_sums counts tickets against, is the blocks of one
// instance; a tail's grid is B blocks, one an instance, each with its own
// dynamic shared memory. The bodies run one instance on pointers offset to
// it: a table by its (8, n) size, the weights by s_stride words, and every
// transcript array (pre, coef, state, evals, r_out or rs, r_mont, tor, vabc,
// rabc, ctr, sums) by ist words, the size of one instance's copy of the
// phase's buffer.
#pragma once

#include "fs.cuh"

namespace sck {

constexpr int kThreads = 128;      // a round kernel's block: 32 pairs, four lanes a pair
constexpr int kMaxBlocks = 1024;   // a round kernel's grid at most; a block loops over the pairs beyond
constexpr int kTailPairs = 128;    // the tail takes over at the first round of at most this many pairs
constexpr int kTailThreads = 256;  // the tail's block at most

template <int NT, class T>
__device__ __forceinline__ T pick(const T (&a)[NT], int k) {
  T x = a[0];
#pragma unroll
  for (int m = 1; m < NT; ++m)
    if (k == m) x = a[m];
  return x;
}

// The tables entering a round: NT inputs of n_in entries and, when the round
// folds, NT outputs of stride n_out.
template <int NT>
struct Tabs {
  const uint32_t* in[NT];
  uint32_t* out[NT];
  int64_t n_in, n_out;
};

// Lane k's table pair b: folded by r from entries 4b..4b+3 (and written at
// 2b, 2b+1 of the output), or read at 2b, 2b+1 as it is.
template <int NT>
__device__ __forceinline__ void pair_of(const Tabs<NT>& tb, int k, int64_t b, bool fold, const Fr& r, Fr& e, Fr& o) {
  const uint32_t* in = pick<NT>(tb.in, k);
  if (fold) {
    const Fr x0 = fe_load<FrParams>(in, tb.n_in, 4 * b), x1 = fe_load<FrParams>(in, tb.n_in, 4 * b + 1);
    const Fr x2 = fe_load<FrParams>(in, tb.n_in, 4 * b + 2), x3 = fe_load<FrParams>(in, tb.n_in, 4 * b + 3);
    e = add(x0, mul(sub(x1, x0), r));
    o = add(x2, mul(sub(x3, x2), r));
    uint32_t* out = pick<NT>(tb.out, k);
    fe_store<FrParams>(out, tb.n_out, 2 * b, e);
    fe_store<FrParams>(out, tb.n_out, 2 * b + 1, o);
  } else {
    e = fe_load<FrParams>(in, tb.n_in, 2 * b);
    o = fe_load<FrParams>(in, tb.n_in, 2 * b + 1);
  }
}

// The value at t of the line through (0, e), (1, o): e, o, 2o - e.
__device__ __forceinline__ Fr at_t(const Fr& e, const Fr& o, int t) {
  const Fr x2 = add(o, sub(o, e));
  return t == 0 ? e : t == 1 ? o : x2;
}

// One pass of a round over pairs base + (thread >> 2): every lane of the
// block takes part (the shuffles need full warps). Lane t < 3 of a live pair
// adds its term at t to acc. s: K6's weights S (8, pairs), null for K7.
template <int NT>
__device__ __forceinline__ void pair_pass(const Tabs<NT>& tb, const uint32_t* __restrict__ s, int64_t pairs,
                                          int64_t base, bool fold, const Fr& r, Acc& acc) {
  const int lane = threadIdx.x & 31, k = lane & 3;
  const int64_t b = base + (threadIdx.x >> 2);
  const bool live = b < pairs;
  Fr e = fe_zero<FrParams>(), o = fe_zero<FrParams>(), sb = fe_zero<FrParams>();
  if (NT == 3 && live) sb = fe_load<FrParams>(s, pairs, b);
  if (live && k < NT) pair_of<NT>(tb, k, b, fold, r, e, o);
  Fr E[NT], O[NT];
  const int src = lane & ~3;
#pragma unroll
  for (int m = 0; m < NT; ++m) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      E[m].v[i] = __shfl_sync(0xffffffffu, e.v[i], src + m);
      O[m].v[i] = __shfl_sync(0xffffffffu, o.v[i], src + m);
    }
  }
  if (live && k < 3) {
    Fr term;
    if constexpr (NT == 3) {
      term = mul(sub(mul(at_t(E[0], O[0], k), at_t(E[1], O[1], k)), at_t(E[2], O[2], k)), sb);
    } else {
      term = mul(at_t(E[0], O[0], k), at_t(E[1], O[1], k));
    }
    acc_add(acc, term);
  }
}

// The round kernels' reduction and hand-over. Each thread's acc holds its
// lanes' terms (t = lane & 3). A block adds its sums; with more than one
// block, 27 lanes add the block's 3 x 9 words each to its own 64-bit word of
// `sums` (device memory, zero between launches; a word's total stays below
// 2^32 x blocks, so no carry is lost and the order does not matter), and
// lane 0 takes a ticket. The block with the last ticket reads the 27 words,
// carries them into q(0), q(1), q(2) and zeroes them, while its other warps
// run `side` (the step's coefficients). Returns true, in every thread of the
// block that runs the transcript step, with the sums in qs (shared memory).
template <class Side>
__device__ __forceinline__ bool round_sums(Acc acc, unsigned long long* sums, uint32_t* ctr, Acc* qs, Side side) {
  __shared__ Acc red[kThreads / 32][3];
  __shared__ unsigned long long words[27];
  __shared__ int last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  acc = acc_warp_sum(acc, 4);  // lanes 0..3: this warp's sums at t = lane
  if (lane < 3) red[warp][lane] = acc;
  __syncthreads();
  if (threadIdx.x < 3) {
    Acc s = red[0][threadIdx.x];
    for (int w = 1; w < nwarps; ++w) acc_add(s, red[w][threadIdx.x]);
    qs[threadIdx.x] = s;
  }
  if (gridDim.x > 1) {
    if (warp == 0) {
      __syncwarp();
      if (lane < 27) {
        atomicAdd(sums + lane, (unsigned long long)qs[lane / 9].v[lane % 9]);
        __threadfence();
      }
      __syncwarp();
      if (lane == 0) last = atomicAdd(ctr, 1u) == gridDim.x - 1;
    }
    __syncthreads();
    if (!last) return false;
    __threadfence();
    if (warp == 0) {
      if (lane < 27) {
        words[lane] = __ldcg(sums + lane);
        sums[lane] = 0ull;  // for the next round's launch
      }
      __syncwarp();
      if (lane < 3) {
        Acc q;
        unsigned long long c = 0;
#pragma unroll
        for (int i = 0; i < 9; ++i) {
          c += words[9 * lane + i];
          q.v[i] = (uint32_t)c;
          c >>= 32;
        }
        qs[lane] = q;
      }
      if (lane == 0) *ctr = 0u;
    } else {
      side();
    }
  } else if (warp != 0) {
    side();
  }
  __syncthreads();
  return true;
}

// K6 with its transcript step: sum_b S[b] (Az_t Bz_t - Cz_t)[b] at t = 0, 1,
// 2 over `pairs` pairs, after the fold by r_mont when `fold` is set; then
// (fs.cuh) the wire evaluations to evals (D, 8) from this round's
// coefficients coef (6, D, 8), r_i to r_out and r_mont, the chain state, and
// the next round's pre and coef (tor_next: tor_{i+1}). sums and ctr: zero
// between launches.
__device__ __forceinline__ void sc1_round_body(const uint32_t* az, const uint32_t* bz, const uint32_t* cz,
                                               const uint32_t* __restrict__ s, const uint32_t* __restrict__ consts,
                                               const uint32_t* __restrict__ tor_i,
                                               const uint32_t* __restrict__ tor_next, uint32_t* pre, uint32_t* coef,
                                               uint32_t* state, uint32_t* evals, uint32_t* r_out, uint32_t* r_mont,
                                               uint32_t* ctr, uint32_t* az_out, uint32_t* bz_out, uint32_t* cz_out,
                                               unsigned long long* sums, int64_t pairs, int fold, int D) {
  __shared__ uint32_t msg[fs::kMsgWords];
  __shared__ Acc qs[3];
  __shared__ fs::Sc1Coeffs co;
  const Fr r = fold ? load8(r_mont) : fe_zero<FrParams>();
  const Tabs<3> tb{{az, bz, cz}, {az_out, bz_out, cz_out}, (fold ? 4 : 2) * pairs, 2 * pairs};
  const int64_t groups = blockDim.x >> 2;
  Acc acc = acc_zero();
  for (int64_t base = (int64_t)blockIdx.x * groups; base < pairs; base += (int64_t)gridDim.x * groups)
    pair_pass<3>(tb, s, pairs, base, fold, r, acc);
  if (!round_sums(acc, sums, ctr, qs, [&] { fs::sc1_load_coef(co, coef, D, 32); })) return;
  fs::sc1_evals(co, qs, D, evals, msg);
  __syncthreads();
  const Fr tor = load8(tor_i);
  if (threadIdx.x == 0) {
    uint32_t st[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) st[i] = state[i];
    Fr rc;
    fs::sc1_sample(co, tor, msg, D, st, rc);
    store8(r_out, rc);
#pragma unroll
    for (int i = 0; i < 8; ++i) state[i] = st[i];
  } else {
    fs::sc1_brackets(co, load8(pre), tor, load8(tor_next), consts, D, 32, true);
  }
  __syncthreads();
  fs::sc1_next(co, D, coef, r_mont, pre, true);
}

// K7 with its transcript step: sum_b W_t[b] z_t[b] at t = 0, 1, 2 after the
// fold as above; the three evaluations to evals (3, 8), r to r_out, r_mont.
__device__ __forceinline__ void prod2_round_body(const uint32_t* w, const uint32_t* z, uint32_t* state,
                                                 uint32_t* evals, uint32_t* r_out, uint32_t* r_mont, uint32_t* ctr,
                                                 uint32_t* w_out, uint32_t* z_out, unsigned long long* sums,
                                                 int64_t pairs, int fold) {
  __shared__ uint32_t msg[10 + 8 * 3];
  __shared__ Acc qs[3];
  const Fr r = fold ? load8(r_mont) : fe_zero<FrParams>();
  const Tabs<2> tb{{w, z}, {w_out, z_out}, (fold ? 4 : 2) * pairs, 2 * pairs};
  const int64_t groups = blockDim.x >> 2;
  Acc acc = acc_zero();
  for (int64_t base = (int64_t)blockIdx.x * groups; base < pairs; base += (int64_t)gridDim.x * groups)
    pair_pass<2>(tb, nullptr, pairs, base, fold, r, acc);
  if (!round_sums(acc, sums, ctr, qs, [] {}) || threadIdx.x >= 32) return;
  uint32_t st[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) st[i] = state[i];
  Fr rc, rm;
  fs::sc2_step(qs, st, evals, msg, rc, rm);
  if (threadIdx.x == 0) {
    store8(r_out, rc);
    store8(r_mont, rm);
#pragma unroll
    for (int i = 0; i < 8; ++i) state[i] = st[i];
  }
}

// The tail: `rounds` rounds from pairs0 pairs down to one, in one block.
// tabs: the tables entering the first (width 4 pairs0 when `fold`, else 2
// pairs0); smem: NT x 8 x (3/2 cap) words, cap = the first fold's output
// width. sc1 (NT = 3): s_cat the weight tables of the rounds one after the
// other (8 x pairs words each), tor the rounds' tor_i (rounds, 8), coef the
// first round's coefficients (6, D, 8); while thread 0 absorbs, the other
// warps form the next round's brackets; then round 4 into vabc and rabc.
// Writes evals (rounds, D, 8), rs (rounds, 8), r_mont, state (and pre).
template <int NT>
__device__ __forceinline__ void tail_body(const uint32_t* const (&tabs)[NT], const uint32_t* __restrict__ s_cat,
                                          const uint32_t* __restrict__ consts, const uint32_t* __restrict__ tor,
                                          uint32_t* pre, const uint32_t* coef, uint32_t* state, uint32_t* evals,
                                          uint32_t* rs, uint32_t* r_mont, uint32_t* vabc, uint32_t* rabc,
                                          uint32_t* smem, int64_t pairs0, int fold, int rounds, int D) {
  __shared__ Acc red[kTailThreads / 32][3];
  __shared__ Acc qs[3];
  __shared__ uint32_t msg[fs::kMsgWords];
  __shared__ fs::Sc1Coeffs co;
  __shared__ Fr r_sh, p_sh;
  __shared__ uint32_t st_sh[8];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int first = nwarps > 1 ? 32 : 1;  // the threads beside thread 0 while it absorbs
  const int64_t cap = fold ? 2 * pairs0 : pairs0;
  uint32_t* const buf0 = smem;
  uint32_t* const buf1 = smem + NT * 8 * cap;
  const int64_t n1 = cap / 2 > 0 ? cap / 2 : 1;
  Tabs<NT> tb;
#pragma unroll
  for (int m = 0; m < NT; ++m) tb.in[m] = tabs[m];
  tb.n_in = fold ? 4 * pairs0 : 2 * pairs0;
  bool to1 = false;  // the next fold writes buf1 (else buf0)
  Fr r = fold ? load8(r_mont) : fe_zero<FrParams>(), rc = fe_zero<FrParams>();
  if (threadIdx.x == 0) {
    if (NT == 3) p_sh = load8(pre);
#pragma unroll
    for (int i = 0; i < 8; ++i) st_sh[i] = state[i];
  }
  if constexpr (NT == 3) fs::sc1_load_coef(co, coef, D, 0);
  __syncthreads();
  uint32_t st[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) st[i] = st_sh[i];
  int64_t s_off = 0;
  for (int k = 0; k < rounds; ++k) {
    const int64_t pairs = pairs0 >> k;
    const bool rf = fold || k > 0;
    tb.n_out = to1 ? n1 : cap;
#pragma unroll
    for (int m = 0; m < NT; ++m) tb.out[m] = (to1 ? buf1 : buf0) + m * 8 * tb.n_out;
    Acc acc = acc_zero();
    for (int64_t base = 0; base < pairs; base += blockDim.x >> 2)
      pair_pass<NT>(tb, s_cat + s_off, pairs, base, rf, r, acc);
    acc = acc_warp_sum(acc, 4);
    if (lane < 3) red[warp][lane] = acc;
    __syncthreads();
    if (threadIdx.x < 3) {
      for (int w = 1; w < nwarps; ++w) acc_add(acc, red[w][threadIdx.x]);
      qs[threadIdx.x] = acc;
    }
    __syncthreads();
    if constexpr (NT == 3) {
      fs::sc1_evals(co, qs, D, evals + (int64_t)k * D * 8, msg);
      __syncthreads();
      const bool next = k + 1 < rounds;
      if (threadIdx.x == 0) {
        fs::sc1_sample(co, load8(tor + 8 * k), msg, D, st, rc);
      } else {
        fs::sc1_brackets(co, p_sh, load8(tor + 8 * k), load8(tor + 8 * (next ? k + 1 : k)), consts, D, first,
                         next);
      }
      __syncthreads();
      fs::sc1_next(co, D, nullptr, reinterpret_cast<uint32_t*>(&r_sh), reinterpret_cast<uint32_t*>(&p_sh), next);
    } else if (warp == 0) {
      Fr rm;
      fs::sc2_step(qs, st, evals + (int64_t)k * 3 * 8, msg, rc, rm);
      if (lane == 0) r_sh = rm;
    }
    if (threadIdx.x == 0) store8(rs + 8 * k, rc);
    __syncthreads();
    r = r_sh;
    if (rf) {
#pragma unroll
      for (int m = 0; m < NT; ++m) tb.in[m] = tb.out[m];
      tb.n_in = tb.n_out;
      to1 = !to1;
    }
    s_off += 8 * pairs;
  }
  if (warp != 0) return;
  if constexpr (NT == 3) fs::sc1_final(tb.in[0], tb.in[1], tb.in[2], tb.n_in, co.r, st, vabc, rabc, msg);
  if (lane == 0) {
    store8(r_mont, r);
    if (NT == 3) store8(pre, p_sh);
#pragma unroll
    for (int i = 0; i < 8; ++i) state[i] = st[i];
  }
}

// The words of a round's entering tables of one instance: (8, 4 pairs) when
// the round folds, else (8, 2 pairs).
__device__ __forceinline__ int64_t table_words(int64_t pairs, int fold) { return 8 * (fold ? 4 : 2) * pairs; }

}  // namespace sck

__global__ void __launch_bounds__(sck::kThreads)
sc1_round_kernel(const uint32_t* az, const uint32_t* bz, const uint32_t* cz, const uint32_t* __restrict__ s,
                 const uint32_t* __restrict__ consts, const uint32_t* __restrict__ tor_i,
                 const uint32_t* __restrict__ tor_next, uint32_t* pre, uint32_t* coef, uint32_t* state,
                 uint32_t* evals, uint32_t* r_out, uint32_t* r_mont, uint32_t* ctr, uint32_t* az_out,
                 uint32_t* bz_out, uint32_t* cz_out, unsigned long long* sums, int64_t pairs, int fold, int D,
                 int64_t s_stride, int64_t ist) {
  const int64_t b = blockIdx.y, in = b * sck::table_words(pairs, fold), out = b * 16 * pairs, st = b * ist;
  sck::sc1_round_body(az + in, bz + in, cz + in, s + b * s_stride, consts, tor_i + st, tor_next + st, pre + st,
                      coef + st, state + st, evals + st, r_out + st, r_mont + st, ctr + st, az_out + out,
                      bz_out + out, cz_out + out, sums + st / 2, pairs, fold, D);
}

__global__ void __launch_bounds__(sck::kThreads)
prod2_round_kernel(const uint32_t* w, const uint32_t* z, uint32_t* state, uint32_t* evals, uint32_t* r_out,
                   uint32_t* r_mont, uint32_t* ctr, uint32_t* w_out, uint32_t* z_out, unsigned long long* sums,
                   int64_t pairs, int fold, int64_t ist) {
  const int64_t b = blockIdx.y, in = b * sck::table_words(pairs, fold), out = b * 16 * pairs, st = b * ist;
  sck::prod2_round_body(w + in, z + in, state + st, evals + st, r_out + st, r_mont + st, ctr + st, w_out + out,
                        z_out + out, sums + st / 2, pairs, fold);
}

__global__ void __launch_bounds__(sck::kTailThreads)
sc1_tail_kernel(const uint32_t* az, const uint32_t* bz, const uint32_t* cz, const uint32_t* __restrict__ s_cat,
                const uint32_t* __restrict__ consts, const uint32_t* __restrict__ tor, uint32_t* pre,
                const uint32_t* coef, uint32_t* state, uint32_t* evals, uint32_t* rs, uint32_t* r_mont,
                uint32_t* vabc, uint32_t* rabc, int64_t pairs0, int fold, int rounds, int D, int64_t s_stride,
                int64_t ist) {
  extern __shared__ uint4 smem[];
  const int64_t b = blockIdx.x, in = b * sck::table_words(pairs0, fold), st = b * ist;
  const uint32_t* const tabs[3] = {az + in, bz + in, cz + in};
  sck::tail_body<3>(tabs, s_cat + b * s_stride, consts, tor + st, pre + st, coef + st, state + st, evals + st,
                    rs + st, r_mont + st, vabc + st, rabc + st, reinterpret_cast<uint32_t*>(smem), pairs0, fold,
                    rounds, D);
}

__global__ void __launch_bounds__(sck::kTailThreads)
sc2_tail_kernel(const uint32_t* w, const uint32_t* z, uint32_t* state, uint32_t* evals, uint32_t* rs,
                uint32_t* r_mont, int64_t pairs0, int fold, int rounds, int64_t ist) {
  extern __shared__ uint4 smem[];
  const int64_t b = blockIdx.x, in = b * sck::table_words(pairs0, fold), st = b * ist;
  const uint32_t* const tabs[2] = {w + in, z + in};
  sck::tail_body<2>(tabs, nullptr, nullptr, nullptr, nullptr, nullptr, state + st, evals + st, rs + st,
                    r_mont + st, nullptr, nullptr, reinterpret_cast<uint32_t*>(smem), pairs0, fold, rounds, 0);
}
