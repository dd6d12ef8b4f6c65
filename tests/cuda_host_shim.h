// Host shim for the CUDA sources of spartan_tpu_torch/csrc: compiled with
// g++ -include, it runs a kernel on CPU threads (one std::thread per CUDA
// thread, one block at a time, grids of one or two dimensions) so that the
// CPU tests can hold the kernels' own arithmetic against the plain PyTorch
// versions. Shuffles, ballots and
// __syncwarp are barriers over the warp or the team; the device code's
// carry flag is fp_cc.cuh's host branch. Blocks run one after another, so a
// ticket counter taken with atomicAdd makes the last block the last to run.
#pragma once
#include <cstdint>
#include <thread>
#include <barrier>
#include <vector>
#include <map>
#include <mutex>
#include <functional>
#include <memory>
#include <atomic>

#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __constant__
#define __restrict__
#define __launch_bounds__(...)
#define __shared__ static

struct uint4 { uint32_t x, y, z, w; };
inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) { return {a, b, c, d}; }
struct Dim { unsigned x = 0, y = 0, z = 0; };
inline thread_local Dim threadIdx, blockIdx;
inline Dim blockDim, gridDim;

inline int __clz(uint32_t x) { return x ? __builtin_clz(x) : 32; }
inline uint32_t __byte_perm(uint32_t x, uint32_t y, uint32_t s) {
  const uint64_t v = ((uint64_t)y << 32) | x;
  uint32_t r = 0;
  for (int i = 0; i < 4; ++i) r |= (uint32_t)((v >> (8 * ((s >> (4 * i)) & 7))) & 0xffu) << (8 * i);
  return r;
}
inline uint32_t __funnelshift_r(uint32_t lo, uint32_t hi, uint32_t n) {
  return (uint32_t)((((uint64_t)hi << 32) | lo) >> (n & 31));
}
inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }
inline uint32_t atomicAdd(uint32_t* p, uint32_t v) { return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }
inline unsigned long long atomicAdd(unsigned long long* p, unsigned long long v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
template <class V> inline V __ldcg(const V* p) { return *(const volatile V*)p; }
inline long long clock64() { return 0; }

struct ShimBlock {
  int nthreads;
  std::unique_ptr<std::barrier<>> block_bar;
  std::mutex mu;
  std::map<std::pair<int, unsigned>, std::unique_ptr<std::barrier<>>> warp_bars;
  uint64_t xbuf[1024];
  std::barrier<>* warp_bar(int warp, unsigned mask) {
    std::lock_guard<std::mutex> g(mu);
    auto& b = warp_bars[{warp, mask}];
    if (!b) b.reset(new std::barrier<>(__builtin_popcount(mask)));
    return b.get();
  }
};
inline ShimBlock* g_block = nullptr;

inline void __syncthreads() { g_block->block_bar->arrive_and_wait(); }
inline void __syncwarp(unsigned mask = 0xffffffffu) {
  g_block->warp_bar(threadIdx.x / 32, mask)->arrive_and_wait();
}
// Every lane of the warp publishes v and reads lane src's (full warps only).
template <class V>
inline V shim_exchange(V v, int src) {
  int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  uint64_t* buf = g_block->xbuf + warp * 32;
  auto* bar = g_block->warp_bar(warp, 0xffffffffu);
  buf[lane] = (uint64_t)v;
  bar->arrive_and_wait();
  V r = (V)buf[src];
  bar->arrive_and_wait();
  return r;
}
template <class V> inline V __shfl_sync(unsigned, V v, int src) { return shim_exchange(v, src); }
template <class V> inline V __shfl_down_sync(unsigned, V v, unsigned d) {
  int lane = threadIdx.x % 32;
  return shim_exchange(v, lane + (int)d < 32 ? lane + (int)d : lane);
}
template <class V> inline V __shfl_xor_sync(unsigned, V v, int m) {
  return shim_exchange(v, (threadIdx.x % 32) ^ m);
}
template <class V> inline V __shfl_up_sync(unsigned, V v, unsigned d) {
  int lane = threadIdx.x % 32;
  return shim_exchange(v, lane - (int)d >= 0 ? lane - (int)d : lane);
}
inline uint32_t __ballot_sync(unsigned, int pred) {
  int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  uint64_t* buf = g_block->xbuf + warp * 32;
  auto* bar = g_block->warp_bar(warp, 0xffffffffu);
  buf[lane] = pred ? 1 : 0;
  bar->arrive_and_wait();
  uint32_t r = 0;
  for (int i = 0; i < 32; ++i) r |= (uint32_t)buf[i] << i;
  bar->arrive_and_wait();
  return r;
}

// Run fn, a kernel call, as every thread of every block of a (gx, gy) grid,
// one block at a time: blockIdx.x outer and blockIdx.y inner, so the blocks
// of different y (a batch's instances) interleave, and state that one y's
// blocks must keep to themselves (a ticket counter, partial sums) shows
// when it is shared.
inline void shim_launch2(unsigned gx, unsigned gy, unsigned threads, const std::function<void()>& fn) {
  blockDim.x = threads;
  gridDim.x = gx;
  gridDim.y = gy;
  for (unsigned bx = 0; bx < gx; ++bx) {
    for (unsigned by = 0; by < gy; ++by) {
      ShimBlock blk;
      blk.nthreads = threads;
      blk.block_bar.reset(new std::barrier<>(threads));
      g_block = &blk;
      std::vector<std::thread> ts;
      for (unsigned t = 0; t < threads; ++t)
        ts.emplace_back([&, bx, by, t] {
          blockIdx.x = bx;
          blockIdx.y = by;
          threadIdx.x = t;
          fn();
        });
      for (auto& th : ts) th.join();
    }
  }
}

// A one-dimensional grid of `blocks` blocks.
inline void shim_launch(unsigned blocks, unsigned threads, const std::function<void()>& fn) {
  shim_launch2(blocks, 1, threads, fn);
}
