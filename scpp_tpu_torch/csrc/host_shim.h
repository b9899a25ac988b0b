// Host shim for the kernel bodies (*_body.cuh): lets g++ compile the device
// code of a body as plain C++, so that the CPU tests check its arithmetic.
// `__device__` and friends are empty, each CUDA thread of a block is a
// std::thread with its own `threadIdx`, and `__syncthreads` is a barrier
// over the threads of the block being run. A harness includes this with
// `-include host_shim.h`, defines `threadIdx`, `blockDim` and `g_barrier`
// once, and runs the blocks one after another. A body that uses warps
// also needs `g_warp_barriers` and `g_warp_xch` defined, and a HostWarps
// for each block run: one barrier and one exchange array per group of 32
// threads (the last group may have fewer), which `__syncwarp` and the
// shuffles use. The asynchronous copies of <cuda_pipeline_primitives.h>
// copy at once, and so do the bulk copies of cr_solve_body.cuh: its
// mbarriers (init, expect-tx, arrive, wait by phase parity, inval) keep
// their state in their own 8 bytes of shared memory, under one lock, and
// a bulk copy completes its bytes on its mbarrier as it returns; the
// proxy fences order nothing here.
#pragma once
#include <algorithm>
#include <array>
#include <atomic>
#include <barrier>
#include <chrono>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <math.h>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>
#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
struct Dim3 { unsigned x = 0, y = 0, z = 0; };
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(16) double2 { double x, y; };
extern thread_local Dim3 threadIdx;
extern Dim3 blockDim;
extern std::barrier<>* g_barrier;
inline void __syncthreads() { g_barrier->arrive_and_wait(); }
// A barrier for the lanes of a warp, which meet several times a matrix
// column: it spins, yielding, where std::barrier sleeps.
struct SpinBarrier {
  explicit SpinBarrier(int n) : n_(n) {}
  void arrive_and_wait() {
    const unsigned gen = gen_.load(std::memory_order_acquire);
    if (count_.fetch_add(1, std::memory_order_acq_rel) + 1 == n_) {
      count_.store(0, std::memory_order_relaxed);
      gen_.fetch_add(1, std::memory_order_acq_rel);
    } else {
      while (gen_.load(std::memory_order_acquire) == gen)
        std::this_thread::yield();
    }
  }
  const int n_;
  std::atomic<int> count_{0};
  std::atomic<unsigned> gen_{0};
};
extern SpinBarrier** g_warp_barriers;
extern unsigned long long (*g_warp_xch)[2][32];
inline void __syncwarp(unsigned = 0xffffffffu) {
  g_warp_barriers[threadIdx.x / 32]->arrive_and_wait();
}
// the lanes of a warp exchange values through a per-warp array, two
// slots used in turn (one count for every type): a lane that writes the
// next exchange cannot pass its barrier before every lane has read this
// one
inline int& xch_slot() {
  thread_local int slot = 0;
  return slot;
}
template <typename T>
inline T __shfl_xor_sync(unsigned, T v, int lane_mask) {
  int& slot = xch_slot();
  const int wp = threadIdx.x / 32, ln = threadIdx.x % 32;
  std::memcpy(&g_warp_xch[wp][slot][ln], &v, sizeof(T));
  __syncwarp();
  T r;
  std::memcpy(&r, &g_warp_xch[wp][slot][ln ^ lane_mask], sizeof(T));
  slot ^= 1;
  return r;
}
template <typename T>
inline T __shfl_sync(unsigned, T v, int src_lane) {
  return __shfl_xor_sync(0u, v, (threadIdx.x % 32) ^ src_lane);
}
inline int __any_sync(unsigned, int v) {
  int any = v != 0;
  for (int o = 16; o > 0; o >>= 1) any |= __shfl_xor_sync(0u, any, o);
  return any;
}
// the warps of one block run: a harness makes one before it starts the
// block's threads
struct HostWarps {
  std::vector<std::unique_ptr<SpinBarrier>> own;
  std::vector<SpinBarrier*> ptrs;
  std::vector<std::array<unsigned long long, 64>> xch;
  explicit HostWarps(int nthreads) : xch((nthreads + 31) / 32) {
    for (int t = 0; t < nthreads; t += 32) {
      own.emplace_back(new SpinBarrier(std::min(32, nthreads - t)));
      ptrs.push_back(own.back().get());
    }
    g_warp_barriers = ptrs.data();
    g_warp_xch =
        reinterpret_cast<unsigned long long(*)[2][32]>(xch.data()->data());
  }
};
inline void __pipeline_memcpy_async(void* dst, const void* src,
                                    std::size_t size) {
  std::memcpy(dst, src, size);
}
inline void __pipeline_commit() {}
inline void __pipeline_wait_prior(std::size_t) {}
// an mbarrier: transaction bytes still owed, arrivals still owed, the
// arrivals a phase takes (low 15 bits) and the current phase's parity
// (top bit)
struct HostMbar {
  std::int32_t tx;
  std::uint16_t pending;
  std::uint16_t count_phase;
};
static_assert(sizeof(HostMbar) == 8, "an mbarrier is 8 bytes");
inline std::mutex& host_mbar_lock() {
  static std::mutex m;
  return m;
}
inline HostMbar* host_mbar(unsigned long long* bar) {
  return reinterpret_cast<HostMbar*>(bar);
}
// the phase completes when its arrivals and bytes are all in
inline void host_mbar_settle(HostMbar* m) {
  if (m->pending == 0 && m->tx == 0) {
    m->count_phase ^= 0x8000;
    m->pending = m->count_phase & 0x7fff;
  }
}
inline void mbar_init(unsigned long long* bar, unsigned count) {
  std::lock_guard<std::mutex> g(host_mbar_lock());
  *host_mbar(bar) = HostMbar{0, static_cast<std::uint16_t>(count),
                             static_cast<std::uint16_t>(count & 0x7fff)};
}
inline void mbar_init_fence() {}
inline void mbar_arrive_expect_tx(unsigned long long* bar, unsigned bytes) {
  std::lock_guard<std::mutex> g(host_mbar_lock());
  HostMbar* m = host_mbar(bar);
  m->tx += static_cast<std::int32_t>(bytes);
  m->pending -= 1;
  host_mbar_settle(m);
}
// true once the phase of this parity has completed
inline bool mbar_try_wait(unsigned long long* bar, unsigned parity) {
  bool done;
  {
    std::lock_guard<std::mutex> g(host_mbar_lock());
    done = unsigned(host_mbar(bar)->count_phase >> 15) != (parity & 1u);
  }
  if (!done) std::this_thread::yield();
  return done;
}
inline void mbar_inval(unsigned long long* bar) {
  std::lock_guard<std::mutex> g(host_mbar_lock());
  *bar = 0;
}
inline void bulk_copy_g2s(void* dst, const void* src, unsigned bytes,
                          unsigned long long* bar) {
  std::memcpy(dst, src, bytes);
  std::lock_guard<std::mutex> g(host_mbar_lock());
  HostMbar* m = host_mbar(bar);
  m->tx -= static_cast<std::int32_t>(bytes);
  host_mbar_settle(m);
}
inline void fence_proxy_async() {}
// a block that traps ends the launch with an error: here, the process
inline void __trap() { std::abort(); }
// the device's cycle counter and globaltimer: nanoseconds of a steady clock
inline long long clock64() {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}
inline long long wall_ns() { return clock64(); }
