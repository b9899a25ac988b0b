// Cyclic-reduction KKT solve for Hopper (sm_90a).
//
// Replaces the TPU kernel scpp_tpu/solver/cr_pallas.py:_cr_fused_kernel:
// one single-right-hand-side solve M x = b of the signed block-tridiagonal
// KKT system of the unfused staged IPM, from its cyclic-reduction factor
// (down-sweep, root, up-sweep), for a whole batch in one launch. Its plain
// version is `cr_solve` in scpp_tpu_torch/solver/staged_kkt.py.
//
// The Pallas kernel packs each block and its transpose into lane-packed
// planes and unrolls the levels into (1, Wp) rows, both for Mosaic. Here
// the factor is stored once per factor, (L^{-1}, R, Q) per odd block in
// one contiguous (K-1, 3, Wp, Wp) buffer per scenario plus the root, and
// transposes are read by index.
//
// Layout: one thread block per scenario; within a level each (odd block,
// row) pair is a work item, the level's right-hand sides are in shared
// memory, and a __syncthreads() separates the dependent steps.
//
// What bounds it: one solve reads each factor block it needs once: L^{-1}
// and R of the K-1 odd blocks, and the Q of each but the last odd block
// on a level with an even block count (that Q is the factor's zero
// padding), (2 (K-1) + nQ + 1) Wp^2 values per scenario with the root
// (50.3 MB for B=64, K=30, Wp=48 in fp32, nQ = 25), and does about
// 2 Wp^2 (4 (K-1) + 2 nQ + 2) flops per scenario: bound by bytes,
// 0.0150 ms at 3.35 TB/s (cr_fused.cr_work). This first version runs one
// block per scenario (64 of the 132 SMs at B=64) and reads the L^{-1} rows
// of the down-sweep with a Wp stride between neighbouring threads, so it
// is bound by the latency of its 3 dependent steps per level and of those
// loads.
//
// Interface: a plain C function, loaded with ctypes; it launches on the
// given stream, allocates nothing, and returns the cudaError_t of the
// launch (or cudaErrorInvalidValue for arguments it does not take).

#include <cuda_runtime.h>

#include "cr_solve_body.cuh"

namespace {

constexpr int kThreads = 768;
constexpr size_t kMaxSmem = 232448;   // 227 KB, a Hopper block's most
constexpr size_t kDefaultSmem = 49152; // 48 KB, usable without opting in

template <typename T>
__global__ void __launch_bounds__(kThreads)
cr_solve_kernel(int K, int Wp, int p, const T* blocks, const T* root,
                const T* b, T* x) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const long long s = blockIdx.x;
  const long long WW = (long long)Wp * Wp;
  cr::solve<T>(K, Wp, p, blocks + s * (K - 1) * 3 * WW, root + s * WW,
               b + s * K * Wp, x + s * K * Wp,
               reinterpret_cast<T*>(smem_raw));
}

template <typename T>
int launch(int B, int K, int Wp, int p, void* stream, const void* blocks,
           const void* root, const void* b, void* x) {
  const size_t smem = sizeof(T) * cr::smem_elems(K, Wp);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > kDefaultSmem) {   // not at the main path's shapes (20 KB)
    cudaError_t err = cudaFuncSetAttribute(
        cr_solve_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cr_solve_kernel<T><<<B, kThreads, smem, (cudaStream_t)stream>>>(
      K, Wp, p, (const T*)blocks, (const T*)root, (const T*)b, (T*)x);
  return (int)cudaGetLastError();
}

}  // namespace

// blocks (B, K-1, 3, Wp, Wp), root (B, Wp, Wp), b (B, K, Wp) -> x (B, K, Wp)
extern "C" int cr_solve_launch(int elem_bytes, void* stream, int B, int K,
                               int Wp, int p, const void* blocks,
                               const void* root, const void* b, void* x) {
  if (B < 1 || K < 1 || Wp < 1 || p < 0 || p > Wp)
    return (int)cudaErrorInvalidValue;
  if (elem_bytes == 4)
    return launch<float>(B, K, Wp, p, stream, blocks, root, b, x);
  if (elem_bytes == 8)
    return launch<double>(B, K, Wp, p, stream, blocks, root, b, x);
  return (int)cudaErrorInvalidValue;
}
