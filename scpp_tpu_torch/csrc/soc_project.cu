// Second-order-cone projection for Hopper (sm_90a).
//
// Replaces the TPU kernel scpp_tpu/ops/soc_pallas.py:_soc_kernel: the
// projection of stacked SOC blocks (t, z) onto ||z|| <= t, which the
// first-order conic solver (scpp_tpu_torch/solver/scs.py) runs once per
// Douglas-Rachford iteration. Its plain version is
// `soc_project_blocks_reference` in scpp_tpu_torch/ops/soc_project.py.
//
// The Pallas kernel pads each size group to (G_pad, 128) lanes in tiles
// of 8 cones and is called once per group. Here one launch projects
// every SOC block of every scenario in place, from a (head, size) table
// of int32 that the wrapper builds once per program structure and keeps
// on the device; one thread per (scenario, cone) with a fixed-order sum
// of squares, so the card stays deterministic.
//
// What bounds it: each block is read once and written at most once,
// 2 q values and about 3 q + 4 operations per cone: at the MPC's shapes
// (34 SOC values a scenario) 272 B a scenario in float32, 17 KB at B=64,
// a bound of 1e-7 to 1e-5 ms. A launch costs its latency, a few
// microseconds; this kernel does nothing about it (the solver's ~30 other
// ops an iteration cost as much each). One thread per cone also
// serialises a large cone's sum: a warp per cone above 32 values is the
// step for programs with large cones.
//
// Interface: a plain C function, loaded with ctypes; it launches on the
// given stream, allocates nothing, and returns the cudaError_t of the
// launch (or cudaErrorInvalidValue for arguments it does not take).

#include <cuda_runtime.h>

#include "soc_project_body.cuh"

namespace {

constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
soc_project_kernel(long long n_items, int n_cones, long long ld,
                   const int* head, const int* size, T* w) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i < n_items) soc::project_item<T>(i, n_cones, ld, head, size, w);
}

template <typename T>
int launch(int B, int n_cones, long long ld, void* stream, const int* head,
           const int* size, void* w) {
  const long long n_items = (long long)B * n_cones;
  const long long blocks = (n_items + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  soc_project_kernel<T><<<(unsigned)blocks, kThreads, 0,
                          (cudaStream_t)stream>>>(n_items, n_cones, ld, head,
                                                  size, (T*)w);
  return (int)cudaGetLastError();
}

}  // namespace

// w: B rows of stride ld (elements), projected in place; head, size:
// n_cones int32 each, on the device
extern "C" int soc_project_launch(int elem_bytes, void* stream, int B,
                                  int n_cones, long long ld, const void* head,
                                  const void* size, void* w) {
  if (B < 1 || n_cones < 1 || ld < 1) return (int)cudaErrorInvalidValue;
  if (elem_bytes == 4)
    return launch<float>(B, n_cones, ld, stream, (const int*)head,
                         (const int*)size, w);
  if (elem_bytes == 8)
    return launch<double>(B, n_cones, ld, stream, (const int*)head,
                          (const int*)size, w);
  return (int)cudaErrorInvalidValue;
}
