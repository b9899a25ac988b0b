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
// Layout: one thread block of 256 threads per scenario (64 of the 132
// SMs at B=64); the body (cr_solve_body.cuh) streams the scenario's
// factor through a ring of shared-memory slots by TMA bulk copies, as
// many slots as the caller's shared-memory budget holds (one at least;
// 227 KB: 7 float32 slots of 27.7 KB, 3 float64 ones), and the levels'
// vectors stay in shared memory.
//
// What bounds it: one solve reads each factor block it needs once: L^{-1}
// and R of the K-1 odd blocks, and the Q of each but the last odd block
// on a level with an even block count (that Q is the factor's zero
// padding), (2 (K-1) + nQ + 1) Wp^2 values per scenario with the root
// (50.3 MB for B=64, K=30, Wp=48 in fp32, nQ = 25), and does about
// 2 Wp^2 (4 (K-1) + 2 nQ + 2) flops per scenario: bound by bytes,
// 0.0150 ms at 3.35 TB/s (cr_fused.cr_work). The kernel moves more: a
// ring of 7 slots keeps levels 2-4 for the up-sweep and reads the 22
// blocks of levels 0-1 twice (1.4 MB a scenario, 91 MB a launch). And
// it runs a dependent chain: 24 chunks of 3 blocks and the root, two
// steps each, every step a chain of shared-memory loads behind one
// barrier. The design keeps the loads off that chain (a chunk's copies
// are issued two chunks early, one thread waits for them and the
// barrier passes them on), reads rows without bank conflicts, 16 bytes
// at a time, and keeps the code small enough for the instruction cache
// (one call site a product, outer loops not unrolled). A deeper ring
// means larger chunks, so fewer dependent steps: the time falls with
// the depth (chip_smoke.py prints it at 1, 2 and the full ring). Times
// (float32, B=64, K=30, Wp=48, one right-hand side, CUDA events; NVIDIA
// H100 80GB HBM3, 700.00 W): 0.0534 ms a launch from the host, 0.0508 ms
// in a CUDA graph, 28-30% of the bound (PERF.md, section 6, row 4; the
// first version: 0.1398 ms).
//
// Interface: a plain C function, loaded with ctypes; it launches on the
// given stream, allocates nothing, and returns the cudaError_t of the
// launch (or cudaErrorInvalidValue for arguments it does not take).

#include <cuda_runtime.h>

#include "cr_solve_body.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxSmem = 232448;   // 227 KB, a Hopper block's most
constexpr long long kDefaultSmem = 49152; // 48 KB, usable without opting in

template <typename T>
__global__ void __launch_bounds__(kThreads)
cr_solve_kernel(int K, int Wp, int p, long long smem, const T* blocks,
                const T* root, const T* b, T* x) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const long long s = blockIdx.x;
  const long long WW = (long long)Wp * Wp;
  cr::solve<T>(K, Wp, p, blocks + s * (K - 1) * 3 * WW, root + s * WW,
               b + s * K * Wp, x + s * K * Wp, smem_raw, smem, false);
}

template <typename T>
int launch(int B, int K, int Wp, int p, long long budget, void* stream,
           const void* blocks, const void* root, const void* b, void* x) {
  const int slots = cr::ring_slots(K, Wp, budget, sizeof(T));
  if (slots < 1) return (int)cudaErrorInvalidValue;
  const long long smem = cr::smem_bytes(K, Wp, slots, sizeof(T));
  if (smem > kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        cr_solve_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cr_solve_kernel<T><<<B, kThreads, smem, (cudaStream_t)stream>>>(
      K, Wp, p, smem, (const T*)blocks, (const T*)root, (const T*)b, (T*)x);
  return (int)cudaGetLastError();
}

}  // namespace

// shared memory of a block with a ring of `slots` slots, and the ring's
// depth in `budget` bytes (0: the launch is refused), for the wrapper
extern "C" long long cr_solve_smem_bytes(int K, int Wp, int slots,
                                         int elem_bytes) {
  return cr::smem_bytes(K, Wp, slots, elem_bytes);
}
extern "C" int cr_solve_ring_slots(int K, int Wp, long long budget,
                                   int elem_bytes) {
  return cr::ring_slots(K, Wp, budget, elem_bytes);
}

// blocks (B, K-1, 3, Wp, Wp), root (B, Wp, Wp), b (B, K, Wp) -> x (B, K, Wp)
// with at most `budget` bytes of shared memory a block (at most 227 KB;
// at least cr::smem_bytes(K, Wp, 1, elem_bytes), one ring slot)
extern "C" int cr_solve_launch(int elem_bytes, void* stream, int B, int K,
                               int Wp, int p, long long budget,
                               const void* blocks, const void* root,
                               const void* b, void* x) {
  if (B < 1 || K < 1 || Wp < 1 || p < 0 || p > Wp || budget > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  if (elem_bytes == 4)
    return launch<float>(B, K, Wp, p, budget, stream, blocks, root, b, x);
  if (elem_bytes == 8)
    return launch<double>(B, K, Wp, p, budget, stream, blocks, root, b, x);
  return (int)cudaErrorInvalidValue;
}
