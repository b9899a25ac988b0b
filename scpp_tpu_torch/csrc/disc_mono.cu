// Fused discretize and resim kernels for Hopper (sm_90a).
//
// disc_mono_kernel replaces the TPU kernel scpp_tpu/ops/disc_mono.py:157
// _disc_kernel: fixed-step RK of the state and the variational equation
// of every (scenario x interval) pair, which gives A_k, B_k, C_k, z_k of
// the linearized dynamics. resim_mono_kernel replaces :320 _resim_kernel:
// nonlinear RK propagation of every interval, then
// J = sum_k ||x_end(k) - x_{k+1}||_1 per scenario. Their plain versions are
// `_disc_plain` and `_resim_plain` in scpp_tpu_torch/ops/disc_mono.py; the
// arithmetic is in disc_mono_body.cuh.
//
// Layout. Discretize: one 64-thread block (two warps) per interval, 1856
// blocks at B=64, K=30 (96 registers a thread in float, 10 blocks an SM;
// ~19 KB of shared memory a block). Per substep: the last warp integrates
// the state through the stages (value flow maps, lane 0; stage inputs, a
// row a lane); then both warps evaluate the stage Jacobians, two input
// directions a thread on dual numbers with two tangents (the value part is
// shared); then the threads form r = f - A x - B u; then the first warp
// takes the variational recursion, a column of Y a lane, n-term sums over
// rows of [A | B] read four at a time, while the last warp already
// integrates the next substep's state. See disc_mono_body.cuh. Resim: one
// block per scenario of six warps (192 threads; 5.4 KB of shared memory
// in float32, 10.8 KB in float64, resim_mono_smem_bytes), an interval a
// lane, the rows of the state over the warps (the mass rate and the
// copies; each acceleration row; the quaternion rates with one angular
// acceleration; the other two), one block barrier a stage between the
// rows' stage inputs and the flow map's rows; then a sum over the
// intervals in a fixed order (no atomics), so the result does not change
// from launch to launch. The Pallas layout (slot scratch,
// 8-row tiles, the scenario sub-batches of its grid, the iota tangent
// bases) answered Mosaic's limits and is not carried over.
//
// What bounds them. Discretize at the main path's shapes (FOH, dopri5,
// 6 steps, 6 evaluated stages a step): ~1.07 GFLOP for ~2.5 MB, so
// operations bound it at 0.0159 ms (chip_smoke.py:disc_work). The kernel
// runs at about 0.124 ms in a CUDA graph on an NVIDIA H100 80GB HBM3 at
// 700 W (PERF.md, section 6, row 2; the one-warp layout before it, 0.32
// ms). What holds it there, measured with diag/disc_versus.py and
// diag/pipe_probe.py on that card: the chains of dependent operations in
// each warp (a dual-number flow map above all), too few warps an SM to
// hide them (registers), and the instruction cache: the
// one-warp layout's 110 KB of unrolled code ran out of a cache that four
// warps each in its own 16 KB already slow eightfold; this layout's loops
// are rolled. The device's division runs a slow path for a zero
// numerator, which the tangents meet at most directions; disc::tdiv
// avoids it. Resim: ~20 MFLOP for ~0.14 MB, 0.0003 ms of either; it runs
// at about 0.012 ms in a CUDA graph on the same card (PERF.md, section 6,
// row 3; one thread an interval before it, 0.032 ms), of which ~0.002 ms
// is a launch's floor (kernel 5's whole launch in a graph). What bounds it
// now, from development builds on that card: each stage's chain on the
// warp that owns the slowest rows, the device's division and square root
// above all (their check and branch to a slow path keep a warp's
// divisions one after another, so the rows are spread to give no warp
// more than two), and the instruction cache that the six warps'
// different code shares (seven or eight warps ran slower, and so did
// every variant that grew the code).
//
// Interface: plain C functions, loaded with ctypes; each launches on the
// given stream, allocates nothing, and returns the cudaError_t of the
// launch (cudaErrorInvalidValue for a variant or shape it does not take).

#include <cuda_runtime.h>

#include "disc_mono_body.cuh"

namespace {

template <class Model, class Tab, bool FOH, typename T>
__global__ void __launch_bounds__(disc::kDiscThreads)
disc_mono_kernel(int K, int KU, int substeps, const T* X, const T* U,
                 const T* ts, const T* par, T* A, T* Bm, T* C, T* z,
                 long long* prof) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  disc::disc_block<Model, Tab, FOH, T>(
      blockIdx.x, threadIdx.x, disc::kDiscThreads, K, KU, substeps, X, U,
      ts, par, A, Bm, C, z, reinterpret_cast<T*>(smem_raw),
      prof ? prof + (long long)blockIdx.x * disc::kDiscProfSlots : nullptr);
}

template <class Model, class Tab, bool FOH, typename T>
__global__ void __launch_bounds__(32 * disc::ResimWarps<Model>::warps)
resim_mono_kernel(int K, int KU, int substeps, const T* X, const T* U,
                  const T* ts, const T* par, T* J) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  disc::resim_block<Model, Tab, FOH, T>(blockIdx.x, threadIdx.x, K, KU,
                                        substeps, X, U, ts, par, J,
                                        reinterpret_cast<T*>(smem_raw));
}

// the most shared memory a block can have on the H100
constexpr long long kMaxSmem = 232448;

bool shape_ok(int B, int K, int KU, int substeps, int foh) {
  return B >= 1 && K >= 2 && substeps >= 1 && KU == (foh ? K : K - 1) &&
         (long long)B * (K - 1) < (1LL << 31);
}

}  // namespace

// Shared memory of one discretize block, bytes (0 for a variant it does
// not take); the launcher refuses more than kMaxSmem.
extern "C" long long disc_mono_smem_bytes(int elem_bytes, int method,
                                          int foh) {
  return disc::dispatch(
      elem_bytes, 0, method, foh, 0, [&](auto mdl, auto tab, auto fh,
                                         auto val) {
        return (int)disc::disc_smem_bytes<decltype(mdl), decltype(tab),
                                          decltype(fh)::value,
                                          decltype(val)>();
      });
}

extern "C" int disc_mono_threads() { return disc::kDiscThreads; }
extern "C" int disc_mono_prof_slots() { return disc::kDiscProfSlots; }

// X (B, K, n), U (B, KU, m), t (B,), par (B, p) -> A (B, K-1, n, n),
// Bm (B, K-1, n, m), C (B, K-1, n, m; FOH only, else ignored), z (B, K-1, n);
// prof: null, or (B (K-1), kDiscProfSlots) int64 phase counters
extern "C" int disc_mono_launch(int elem_bytes, int model, int method,
                                int foh, void* stream, int B, int K, int KU,
                                int substeps, const void* X, const void* U,
                                const void* t, const void* par, void* A,
                                void* Bm, void* C, void* z, void* prof) {
  if (!shape_ok(B, K, KU, substeps, foh)) return (int)cudaErrorInvalidValue;
  return disc::dispatch(
      elem_bytes, model, method, foh, (int)cudaErrorInvalidValue,
      [&](auto mdl, auto tab, auto fh, auto val) {
        using Model = decltype(mdl);
        using Tab = decltype(tab);
        using T = decltype(val);
        constexpr bool FOH = decltype(fh)::value;
        constexpr long long smem = disc::disc_smem_bytes<Model, Tab, FOH, T>();
        auto kern = disc_mono_kernel<Model, Tab, FOH, T>;
        if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
        if (smem > 48 * 1024) {
          const cudaError_t e = cudaFuncSetAttribute(
              kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
          if (e != cudaSuccess) return (int)e;
        }
        kern<<<B * (K - 1), disc::kDiscThreads, smem,
               (cudaStream_t)stream>>>(
            K, KU, substeps, (const T*)X, (const T*)U, (const T*)t,
            (const T*)par, (T*)A, (T*)Bm, (T*)C, (T*)z, (long long*)prof);
        return (int)cudaGetLastError();
      });
}

// Threads and shared memory (bytes) of one resim block (0 for a variant
// it does not take), as resim_mono_launch gives them
extern "C" int resim_mono_threads() {
  return 32 * disc::ResimWarps<disc::RocketQuat>::warps;
}
extern "C" long long resim_mono_smem_bytes(int elem_bytes, int method,
                                           int foh) {
  return disc::dispatch(
      elem_bytes, 0, method, foh, 0, [&](auto mdl, auto, auto, auto val) {
        return (int)disc::resim_smem_bytes<decltype(mdl), decltype(val)>();
      });
}

// same inputs -> J (B,)
extern "C" int resim_mono_launch(int elem_bytes, int model, int method,
                                 int foh, void* stream, int B, int K, int KU,
                                 int substeps, const void* X, const void* U,
                                 const void* t, const void* par, void* J) {
  if (!shape_ok(B, K, KU, substeps, foh)) return (int)cudaErrorInvalidValue;
  return disc::dispatch(
      elem_bytes, model, method, foh, (int)cudaErrorInvalidValue,
      [&](auto mdl, auto tab, auto fh, auto val) {
        using Model = decltype(mdl);
        using Tab = decltype(tab);
        using T = decltype(val);
        constexpr bool FOH = decltype(fh)::value;
        constexpr long long smem = disc::resim_smem_bytes<Model, T>();
        static_assert(smem <= 48 * 1024, "no opt-in for more");
        resim_mono_kernel<Model, Tab, FOH, T>
            <<<B, 32 * disc::ResimWarps<Model>::warps, smem,
               (cudaStream_t)stream>>>(K, KU, substeps, (const T*)X,
                                       (const T*)U, (const T*)t,
                                       (const T*)par, (T*)J);
        return (int)cudaGetLastError();
      });
}
