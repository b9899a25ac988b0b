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
// Layout. Discretize: one 32-thread block per interval (1856 blocks at
// B=64, K=30, all resident at once): thread c owns column c of the
// augmented variational state and its stage slopes in registers, thread
// ncols owns the state, threads j < n + m evaluate the flow map on dual
// numbers seeded on input direction j (one column of [A | B] each, the
// arithmetic of the reference's jvp), and [A | B], f and r sit in shared
// memory. Resim: one block per scenario, one thread per interval, then a
// sum over the intervals in a fixed order (no atomics), so the result does
// not change from launch to launch. The Pallas layout (slot scratch,
// 8-row tiles, the scenario sub-batches of its grid, the iota tangent
// bases) answered Mosaic's limits and is not carried over.
//
// What bounds them. Discretize at the main path's shapes (FOH, dopri5,
// 6 steps, 6 evaluated stages a step): ~1.1 GFLOP for ~2.4 MB of
// outputs, so operations bound it (chip_smoke.py:disc_work counts both);
// this first version is far from that bound: per stage a block runs three
// barriers and each column thread a 14 x 14 matrix-vector product from
// shared memory. Resim: ~20 MFLOP for ~0.14 MB, well under a microsecond of
// either, so the launch itself dominates.
//
// Interface: plain C functions, loaded with ctypes; each launches on the
// given stream, allocates nothing, and returns the cudaError_t of the
// launch (cudaErrorInvalidValue for a variant or shape it does not take).

#include <cuda_runtime.h>

#include "disc_mono_body.cuh"

namespace {

template <class Model, class Tab, bool FOH, typename T>
__global__ void __launch_bounds__(32)
disc_mono_kernel(int K, int KU, int substeps, const T* X, const T* U,
                 const T* ts, const T* par, T* A, T* Bm, T* C, T* z) {
  __shared__ T smem[disc::disc_smem_elems<Model>()];
  disc::disc_block<Model, Tab, FOH, T>(blockIdx.x, threadIdx.x, K, KU,
                                       substeps, X, U, ts, par, A, Bm, C, z,
                                       smem);
}

template <class Model, class Tab, bool FOH, typename T>
__global__ void __launch_bounds__(256)
resim_mono_kernel(int K, int KU, int substeps, const T* X, const T* U,
                  const T* ts, const T* par, T* J) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  disc::resim_block<Model, Tab, FOH, T>(blockIdx.x, threadIdx.x, blockDim.x,
                                        K, KU, substeps, X, U, ts, par, J,
                                        reinterpret_cast<T*>(smem_raw));
}

bool shape_ok(int B, int K, int KU, int substeps, int foh) {
  return B >= 1 && K >= 2 && substeps >= 1 && KU == (foh ? K : K - 1) &&
         (long long)B * (K - 1) < (1LL << 31);
}

}  // namespace

// X (B, K, n), U (B, KU, m), t (B,), par (B, p) -> A (B, K-1, n, n),
// Bm (B, K-1, n, m), C (B, K-1, n, m; FOH only, else ignored), z (B, K-1, n)
extern "C" int disc_mono_launch(int elem_bytes, int model, int method,
                                int foh, void* stream, int B, int K, int KU,
                                int substeps, const void* X, const void* U,
                                const void* t, const void* par, void* A,
                                void* Bm, void* C, void* z) {
  if (!shape_ok(B, K, KU, substeps, foh)) return (int)cudaErrorInvalidValue;
  return disc::dispatch(
      elem_bytes, model, method, foh, (int)cudaErrorInvalidValue,
      [&](auto mdl, auto tab, auto fh, auto val) {
        using Model = decltype(mdl);
        using Tab = decltype(tab);
        using T = decltype(val);
        constexpr bool FOH = decltype(fh)::value;
        disc_mono_kernel<Model, Tab, FOH, T>
            <<<B * (K - 1), 32, 0, (cudaStream_t)stream>>>(
                K, KU, substeps, (const T*)X, (const T*)U, (const T*)t,
                (const T*)par, (T*)A, (T*)Bm, (T*)C, (T*)z);
        return (int)cudaGetLastError();
      });
}

// same inputs -> J (B,)
extern "C" int resim_mono_launch(int elem_bytes, int model, int method,
                                 int foh, void* stream, int B, int K, int KU,
                                 int substeps, const void* X, const void* U,
                                 const void* t, const void* par, void* J) {
  if (!shape_ok(B, K, KU, substeps, foh)) return (int)cudaErrorInvalidValue;
  const int threads = (K - 1 + 31) / 32 * 32 < 256 ? (K - 1 + 31) / 32 * 32
                                                   : 256;
  return disc::dispatch(
      elem_bytes, model, method, foh, (int)cudaErrorInvalidValue,
      [&](auto mdl, auto tab, auto fh, auto val) {
        using Model = decltype(mdl);
        using Tab = decltype(tab);
        using T = decltype(val);
        constexpr bool FOH = decltype(fh)::value;
        resim_mono_kernel<Model, Tab, FOH, T>
            <<<B, threads, sizeof(T) * (K - 1), (cudaStream_t)stream>>>(
                K, KU, substeps, (const T*)X, (const T*)U, (const T*)t,
                (const T*)par, (T*)J);
        return (int)cudaGetLastError();
      });
}
